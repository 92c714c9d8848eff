"""End-to-end times of the port's main paths at batch 64, for one checkout:
the VA training step, the captioning training step and ``embed_audio`` in
bf16 and int8, one line of output. To compare two checkouts on one card,
run it for each in turns, one after the other (A, B, B, A)::

    python vipant_tpu_torch/experiments/path_times.py <checkout root> <label>

It imports the package and the helpers of ``chip_smoke.py`` from the given
root (its configs, seeded batches, CUDA-event timer and profiler window),
so an older checkout is timed with its own kernels. Steps: CUDA-event means
over 8 steps after 3 warm-ups (forward + backward: 5 after 2); ``embed_audio``:
host clock around 8 batches ending in a synchronize; device busy time from a
``torch.profiler`` window of 3 steps.
"""

import os
import sys


def main() -> None:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vipant_tpu_torch.train import loss_and_grads

    if not torch.cuda.is_available():
        raise SystemExit("path_times: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, out = 64, {}
    for name, make_trainer, make_batch in (("VA step", cs._trainer, cs._va_batch),
                                           ("captioning step", cs._caption_trainer, cs._caption_batch)):
        tr = make_trainer(torch, B)
        batch = make_batch(tr, np.random.default_rng(1), B)
        fwd_bwd = cs.cuda_ms(torch, lambda: loss_and_grads(tr.state, *batch), 5, 2)
        step = cs.cuda_ms(torch, lambda: tr.train_step(*batch), 8, 3)
        torch.cuda.reset_peak_memory_stats()
        busy, _, _ = cs._profile(torch, lambda: tr.train_step(*batch))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = (f"{step:.2f} ms, fwd+bwd {fwd_bwd:.2f}, device busy {busy:.2f}, "
                     f"peak {peak:.2f} GiB")
        del tr, batch
        torch.cuda.empty_cache()
    fbank = np.random.default_rng(0).standard_normal((B, 1000, 128)).astype(np.float32)
    for quantize in ("", "int8"):
        eng = cs._engine(torch, B, quantize)
        out[f"embed_audio {quantize or 'bf16'}"] = f"{cs._timed_ms(torch, lambda: eng.embed_audio(fbank), 8):.2f} ms"
        del eng
    print(f"path_times {label} ({torch.cuda.get_device_name(0)}): "
          + "; ".join(f"{k}: {v}" for k, v in out.items()))


if __name__ == "__main__":
    main()
