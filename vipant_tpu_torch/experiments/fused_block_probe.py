"""Probe: the packed qkv projection, attention and out projection as one
function, and one product in the four operand orientations.

Counterpart of ``experiments/fused_block_probe.py``, whose two Pallas
kernels asked (a) which ``dot_general`` orientations Mosaic lowers and (b)
whether projection, per-head attention and out projection fit one
VMEM-resident kernel without a head-major layout.

- :func:`probe_dot_variants` (Pallas ``_dot_variant_kernel``): the product
  M, K, N = 256, 128, 384 with the operands stored NN, NT, TN and TT, on the
  hand-written ``dot_variant`` kernel, where the orientation is the layout
  of the tensor-core fragments; reports each against the fp32 product.
- :func:`probe_fused_fwd` (Pallas ``_fused_fwd_kernel``): ``gemm_bias_act``
  (packed qkv) -> ``flash_attention_fwd`` on the q, k, v sections of the
  packed ``[B, T, 3C]`` result, read in place through their strides ->
  ``gemm_bias_act``; returns ``(out [B, T, C], lse [B, H, T])``. No
  LayerNorm, residual or attention bias, as in the Pallas probe. The same
  function as ``fused_attention_block`` plus the logsumexp.

Weights are in the port's layout: ``wqkv`` [3C, C], ``bqkv`` [3C], ``wout``
[C, C] ([out, in]), ``bout`` [C].

Usage::

    python -m vipant_tpu_torch.experiments.fused_block_probe        # on the card
    python -m vipant_tpu_torch.experiments.fused_block_probe cpu    # plain versions
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import KERNEL_OPS, LAUNCHES, PLAIN_OPS, acc

C, H, D = 768, 12, 64
T = 306
B = 64
DOT_MKN = (256, 128, 384)


def dot_variant_inputs(orientation: str, seed: int = 0, device="cpu"):
    """Seeded bf16 operands of the product in ``orientation``'s storage."""
    M, K, N = DOT_MKN
    rng = np.random.default_rng(seed)
    ta, tb = kernels.ORIENTATIONS[orientation]
    a = rng.standard_normal((K, M) if ta else (M, K)).astype(np.float32)
    b = rng.standard_normal((N, K) if tb else (K, N)).astype(np.float32)
    return (torch.from_numpy(a).to(device, torch.bfloat16),
            torch.from_numpy(b).to(device, torch.bfloat16))


def probe_dot_variants(device="cuda") -> Dict[str, float]:
    """orientation -> max |kernel - fp32 product| over the [M, N] result."""
    report = {}
    for name in kernels.ORIENTATIONS:
        a, b = dot_variant_inputs(name, device=device)
        want = kernels.dot_variant_plain(a, b, name)
        report[name] = float((kernels.dot_variant(a, b, name) - want).abs().max())
    return report


def _fused_fwd(ops, x, wqkv, bqkv, wout, bout, heads):
    Bx, Tx, Cx = x.shape
    dt = x.dtype
    qkv = ops.gemm_bias_act(x, wqkv.to(dt).contiguous(), acc(bqkv))
    q, k, v = qkv.view(Bx, Tx, 3, heads, Cx // heads).unbind(dim=2)  # sections, in place
    o, lse = ops.flash_attention_fwd(q, k, v, None, 1.0 / float((Cx // heads) ** 0.5))
    out = ops.gemm_bias_act(o.view(Bx, Tx, Cx), wout.to(dt).contiguous(), acc(bout))
    return out, lse


def probe_fused_fwd(x, wqkv, bqkv, wout, bout, heads: int = H):
    """proj(attn(x)) and the logsumexp: ``(out [B, T, C], lse [B, H, T])``."""
    out = _fused_fwd(KERNEL_OPS, x, wqkv, bqkv, wout, bout, heads)
    if x.is_cuda:
        LAUNCHES["probe_fused_fwd"] += 1
    return out


def probe_fused_fwd_plain(x, wqkv, bqkv, wout, bout, heads: int = H):
    return _fused_fwd(PLAIN_OPS, x, wqkv, bqkv, wout, bout, heads)


def make_inputs(seed: int = 0, batch: int = B, device="cpu", dtype=torch.bfloat16):
    """The Pallas probe's inputs (same seed, same draws) in the port's weight
    layout: x [batch, T, C], wqkv [3C, C], bqkv [3C], wout [C, C], bout [C]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)) * 0.5
    wqkv = rng.standard_normal((C, 3 * C)) * C ** -0.5
    bqkv = rng.standard_normal((3 * C, 1)) * 0.02
    wout = rng.standard_normal((C, C)) * C ** -0.5
    bout = rng.standard_normal((1, C)) * 0.02
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, d)
    return (t(x[:batch], dtype), t(wqkv.T, dtype), t(bqkv[:, 0], torch.float32),
            t(wout.T, dtype), t(bout[0], torch.float32))


def check(device="cuda") -> None:
    report = probe_dot_variants(device)
    print("dot variants: " + ", ".join(f"{k} max|d| {v:.3e}" for k, v in report.items()))
    args = make_inputs(device=device, batch=B if device != "cpu" else 2)
    out, lse = probe_fused_fwd(*args)
    want, lse_want = probe_fused_fwd_plain(*args)
    err = float((out.float() - want.float()).abs().max())
    rel = err / float(want.float().abs().max())
    print(f"fused fwd against its plain version: max abs err {err:.4e} (rel {rel:.4e}); "
          f"lse max abs err {float((lse - lse_want).abs().max()):.4e}")
    if not rel < 2e-2:
        raise AssertionError("parity failure")


if __name__ == "__main__":
    check("cpu" if sys.argv[1:] == ["cpu"] else "cuda")
