"""The pre-LN MLP sub-block ``x + proj(act(fc(LN(x))))``, forward only.

Port of the Pallas kernel ``vipant_tpu/ops/fused_mlp.py::_fwd_kernel`` and
its public op ``fused_ln_mlp_block``. The TPU kernel kept the [T, 4C]
activation in VMEM; on Hopper it is a chain of three hand-written kernels
(:mod:`.kernels`) and the activation makes one bf16 round trip through
device memory:

    h   = layernorm_fwd(x)
    g   = gemm_bias_act(h, Wfc, bfc, act)       [B, T, E] bf16
    out = gemm_bias_act(g, Wproj, bproj, residual=x)

Weights are in the torch Linear layout: ``wfc`` [E, C] (``c_fc.weight``),
``wproj`` [C, E] (``c_proj.weight``). ``act`` is ``quick_gelu`` (CLIP) or
``gelu`` (exact, DeiT).
"""

from __future__ import annotations

import torch

from . import kernels
from .kernels import LAUNCHES

ACTS = ("quick_gelu", "gelu")


def _block(ops, x, lns, lnb, wfc, bfc, wproj, bproj, act):
    if act not in ACTS:
        raise ValueError(f"unknown MLP activation {act!r} (expected one of {ACTS})")
    layernorm, gemm = ops
    dt = x.dtype
    h = layernorm(x, lns.float(), lnb.float())
    g = gemm(h, wfc.to(dt).contiguous(), bfc.float(), act)
    return gemm(g, wproj.to(dt).contiguous(), bproj.float(), residual=x)


_KERNELS = (kernels.layernorm_fwd, kernels.gemm_bias_act)
_PLAIN = (kernels.layernorm_plain, kernels.gemm_bias_act_plain)


class _FusedLNMLP(torch.autograd.Function):
    """Autograd boundary of the kernel chain. The backward is the port of
    the Pallas ``_bwd_kernel``, which is not written yet."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wfc, bfc, wproj, bproj, act):
        out = _block(_KERNELS, x, lns, lnb, wfc, bfc, wproj, bproj, act)
        if x.is_cuda:
            LAUNCHES["fused_ln_mlp_block"] += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("backward kernel lands with training")


def fused_ln_mlp_block(
    x: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wfc: torch.Tensor,
    bfc: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    act: str = "quick_gelu",
) -> torch.Tensor:
    """x + proj(act(fc(LN(x)))). x: [B, T, C]; wfc: [E, C]; wproj: [C, E]."""
    return _FusedLNMLP.apply(x, lns, lnb, wfc, bfc, wproj, bproj, act)


def fused_ln_mlp_block_plain(x, lns, lnb, wfc, bfc, wproj, bproj, act="quick_gelu"):
    return _block(_PLAIN, x, lns, lnb, wfc, bfc, wproj, bproj, act)
