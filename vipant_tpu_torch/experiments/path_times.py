"""End-to-end times of the port's main paths at batch 64, for one checkout:
the VA training step, the captioning training step, ``embed_audio`` in
bf16 and int8 and greedy ``caption``, one line of output. To compare two checkouts on one card,
run it for each in turns, one after the other (A, B, B, A)::

    python vipant_tpu_torch/experiments/path_times.py <checkout root> <label> [paths]

``paths``, if given, picks some of ``va``, ``caption_step``, ``embed_audio``
and ``caption``, separated by commas; by default all of them run.

It imports the package and the helpers of ``chip_smoke.py`` from the given
root (its configs, seeded batches, CUDA-event timer and profiler window),
so an older checkout is timed with its own kernels. Steps: CUDA-event means
over 8 steps after 3 warm-ups (forward + backward: 5 after 2); ``embed_audio``:
host clock around 8 batches ending in a synchronize; ``caption``: host clock
around 3 batches, and per decode step the KV-cached greedy decoder alone over
its 32 steps; device busy time of every path from a ``torch.profiler`` window
of 3 steps (or batches).
"""

import os
import sys


def main() -> None:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    paths = sys.argv[3].split(",") if len(sys.argv) > 3 else ["va", "caption_step", "embed_audio", "caption"]
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vipant_tpu_torch.models.tasks import _encode
    from vipant_tpu_torch.train import loss_and_grads

    if not torch.cuda.is_available():
        raise SystemExit("path_times: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, out = 64, {}
    for key, name, make_trainer, make_batch in (("va", "VA step", cs._trainer, cs._va_batch),
                                                ("caption_step", "captioning step", cs._caption_trainer,
                                                 cs._caption_batch)):
        if key not in paths:
            continue
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
    for quantize in ("", "int8") if "embed_audio" in paths else ():
        eng = cs._engine(torch, B, quantize)
        wall = cs._timed_ms(torch, lambda: eng.embed_audio(fbank), 8)
        busy, _, _ = cs._profile(torch, lambda: eng.embed_audio(fbank))
        out[f"embed_audio {quantize or 'bf16'}"] = f"{wall:.2f} ms, device busy {busy:.2f}"
        del eng
    if "caption" in paths:
        eng = cs._caption_engine(torch, B)
        dec = eng.model.decoder
        with torch.inference_mode():
            _, feat = _encode(eng.model.audio, torch.from_numpy(fbank[:, None]).to(eng.device), False,
                              require_feature=True)
            per_step = cs._timed_ms(torch, lambda: dec.greedy_decode_kv(feat), 3) / dec.max_len_dec
            batch = cs._timed_ms(torch, lambda: eng.caption(fbank), 3)
            busy, _, _ = cs._profile(torch, lambda: eng.caption(fbank))
        out["caption"] = f"{batch:.2f} ms, {per_step:.3f} ms per decode step, device busy {busy:.2f}"
    print(f"path_times {label} ({torch.cuda.get_device_name(0)}): "
          + "; ".join(f"{k}: {v}" for k, v in out.items()))


if __name__ == "__main__":
    main()
