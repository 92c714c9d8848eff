"""Where the DeiT VA step's bf16 grads part from fp32, on one card.

``chip_smoke.py``'s ``backbone_phase`` (a) holds the DeiT VA step's grads on
the kernels (K) no further from the fp32 plain ops (F) than the bf16 plain
ops (P) are, at B = 16 (``hold_grads_to_fp32``, phase 6 (i)'s gates). This
script runs the same full-width, meme-seeded DeiT-B/16 trainer at a smaller
batch over several seeds and, for each batch, grads on hybrids of the two
paths: the kernels with one operation of the sub-blocks' chains (or a set
of them) swapped for its plain version. Per variant X it prints whether X
passes the gates in K's place, the whole-grad cosine to F, the largest
per-grad shortfall cos(X, F) - cos(P, F), and cos(X, F) on the grads where
K falls furthest behind P::

    python vipant_tpu_torch/experiments/deit_grad_gap.py [B] [seed,...]

(default B = 8, seeds 3,5,7,11; seed 3 is the phase's batch seed). Each
seed also prints cos(K, F) - cos(P, F) on the first seed's three grads.
"""

import contextlib
import io
import os
import shutil
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# variant -> the operations that run on their plain versions (the attention's
# backward reads its forward's statistics, so a plain forward takes the plain
# backward with it)
FORWARD = ("layernorm_fwd", "gemm_bias_act", "attention_fwd", "attention_bwd")
BACKWARD = ("layernorm_bwd", "gemm_dgrad", "gemm_wgrad", "colsum", "attention_bwd")
VARIANTS = {
    "P (all plain)": None,
    "K, colsum plain": ("colsum",),
    "K, gemm_dgrad plain": ("gemm_dgrad",),
    "K, gemm_wgrad plain": ("gemm_wgrad",),
    "K, layernorm_bwd plain": ("layernorm_bwd",),
    "K, attention plain": ("attention_fwd", "attention_bwd"),
    "K forward, plain backward": BACKWARD,
    "plain forward, K backward": FORWARD,
}


@contextlib.contextmanager
def hybrid(plain_names):
    """The fused sub-blocks on the kernels, but ``plain_names`` on their
    plain versions."""
    from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

    ops = kernels.KERNEL_OPS._replace(**{n: getattr(kernels.PLAIN_OPS, n) for n in plain_names})
    with mock.patch.object(fused_attn, "KERNEL_OPS", ops), mock.patch.object(fused_mlp, "KERNEL_OPS", ops):
        yield


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from vipant_tpu_torch.ops import _build
    from vipant_tpu_torch.train import Trainer, loss_and_grads

    if not torch.cuda.is_available():
        raise SystemExit("deit_grad_gap: needs a CUDA device")
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    seeds = [int(s) for s in (sys.argv[2] if len(sys.argv) > 2 else "3,5,7,11").split(",")]
    _build.library()
    smi = cs._smi()
    root = tempfile.mkdtemp(prefix="vipant_deit_gap_")
    try:
        meme_path = os.path.join(root, "deit.pth")
        torch.save(cs.synthetic_deit_state_dict(torch), meme_path)
        over = cs.DEIT_FULL + [f"model.image.meme_path={meme_path}", f"model.audio.meme_path={meme_path}",
                               f"alias_root={root}", f"model_root={root}", f"running.batch_size={B}"]
        tr = Trainer(over, steps_per_epoch=cs.STEPS_PER_EPOCH)
        with cs.plain_ops():
            ref = Trainer(over + ["compute_dtype=float32"], steps_per_epoch=cs.STEPS_PER_EPOCH)
        print(f"DeiT VA grads at B={B} T={cs.DEIT_T} ({smi}); seeds {seeds}", flush=True)
        first = None
        for seed in seeds:
            g = torch.Generator().manual_seed(seed)
            batch = tr.make_batch(torch.randn(B, 3, 224, 224, generator=g).numpy(),
                                  torch.randn(B, 1, 1000, 128, generator=g).numpy())
            k = loss_and_grads(tr.state, *batch)
            with cs.plain_ops():
                p = loss_and_grads(tr.state, *batch)
                f = loss_and_grads(ref.state, *batch)
            g_k, g_p, g_f = k[1], p[1], f[1]
            names = [n for n in g_k if not n.startswith(("loss.", "lm_loss."))]
            cos_f = lambda grads: {n: cs._cos(torch, grads[n], g_f[n]) for n in names}
            c_p = cos_f(g_p)
            c_k = cos_f(g_k)
            watched = sorted(names, key=lambda n: c_k[n] - c_p[n])[:3]
            first = first or watched  # the first seed's, followed on every seed
            print(f"seed {seed}: loss K {float(k[0]):.6f} P {float(p[0]):.6f} F {float(f[0]):.6f}; "
                  f"the grads where K falls furthest behind P: "
                  + ", ".join(f"{n} cos(K,F) {c_k[n]:.6f} cos(P,F) {c_p[n]:.6f}" for n in watched)
                  + "; on the first seed's: " + ", ".join(f"{n} cos(K,F) - cos(P,F) {c_k[n] - c_p[n]:+.6f}"
                                                          for n in first), flush=True)
            for label, plain_names in (("K (all kernels)", ()), *VARIANTS.items()):
                if plain_names == ():
                    x, c_x = k, c_k
                elif plain_names is None:
                    x, c_x = p, c_p
                else:
                    with hybrid(plain_names):
                        x = loss_and_grads(tr.state, *batch)
                    c_x = cos_f(x[1])
                try:
                    with contextlib.redirect_stdout(io.StringIO()):  # the gates' full report
                        cs.hold_grads_to_fp32(torch, f"seed {seed} {label}", "DeiT VA", x, p, f)
                    verdict = "passes"
                except AssertionError:
                    verdict = "FAILS"
                whole = cs._cos(torch, torch.cat([x[1][n].flatten() for n in names]),
                                torch.cat([g_f[n].flatten() for n in names]))
                worst = min(names, key=lambda n: c_x[n] - c_p[n])
                print(f"  {label:28s} gates {verdict:6s} whole cos(X,F) {whole:.6f}; max shortfall "
                      f"{c_x[worst] - c_p[worst]:+.6f} ({worst}); cos(X,F) on the watched "
                      + " ".join(f"{c_x[n]:.6f}" for n in watched), flush=True)
                del x
            del k, p, f, g_k, g_p, g_f, batch
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
