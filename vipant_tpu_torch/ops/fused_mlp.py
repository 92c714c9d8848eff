"""The pre-LN MLP sub-block ``x + proj(act(fc(LN(x))))`` and its backward.

Port of the Pallas kernels ``vipant_tpu/ops/fused_mlp.py::_fwd_kernel`` and
``::_bwd_kernel`` and their public op ``fused_ln_mlp_block``. The TPU
kernels kept the [T, 4C] activation in VMEM; on Hopper each direction is a
chain of hand-written kernels (:mod:`.kernels`) and the activation makes a
bf16 round trip through device memory:

    forward                                   backward (gy = d out)
    h   = layernorm_fwd(x)                    h     = layernorm_fwd(x)           (recomputed)
    g   = gemm_bias_act(h, Wfc, bfc, act)     g, a  = gemm_bias_act(h, Wfc, bfc, act,
    out = gemm_bias_act(g, Wproj, bproj,                            preact)    a fp32
                        residual=x)           dbproj = colsum(gy)
                                              dWproj = gemm_wgrad(gy, g)
                                              da    = gemm_dgrad(gy, Wproj, act'(a))  bf16
                                              dbfc  = colsum(da)
                                              dWfc  = gemm_wgrad(da, h)
                                              dh    = gemm_dgrad(da, Wfc)           fp32
                                              dx, dlns, dlnb = layernorm_bwd(x, dh, +gy)

As in the Pallas kernel the backward keeps only x and recomputes h, a and
act(a) (one extra fc product).

Weights are in the torch Linear layout: ``wfc`` [E, C] (``c_fc.weight``),
``wproj`` [C, E] (``c_proj.weight``). ``act`` is ``quick_gelu`` (CLIP) or
``gelu`` (exact, DeiT).

``fused_ln_mlp_block_int8`` is the forward-only int8 variant, port of the
Pallas kernel ``vipant_tpu/ops/fused_mlp.py::_fwd_int8_kernel`` and its
public op: both products run int8 x int8 -> int32. Per call:

    wf8, sfc = rowquant(Wfc)                  weights: from the fp32 params,
    wp8, spj = rowquant(Wproj)                per output column
    h8, hs = layernorm_rowquant(x)
    g   = gemm_i8(h8, hs, wf8, sfc, bfc, act)     fp32: act(a) is never rounded to bf16
    g8, gs = rowquant(g)                      one scale per token over all E columns
    out = gemm_i8(g8, gs, wp8, spj, bproj, residual=x)

The [B, T, 4C] activation makes its round trip in fp32, because the Pallas
kernel quantizes it from fp32. The weights are quantized in every call, as
the jitted JAX call does. A gradient through it raises in its backward.
"""

from __future__ import annotations

import torch

from .kernels import KERNEL_OPS, LAUNCHES, PLAIN_OPS, acc

ACTS = ("quick_gelu", "gelu")


def _weights(x, wfc, wproj):
    return wfc.to(x.dtype).contiguous(), wproj.to(x.dtype).contiguous()


def _model_sum(y, tp):
    from ..parallel.collectives import _all_reduce_

    return _all_reduce_(y, tp, "model")


def _forward(ops, x, lns, lnb, wfc, bfc, wproj, bproj, act, tp=None):
    """The forward chain. Under a model axis (``tp``, the mesh) ``wfc`` holds
    this rank's hidden rows and ``wproj`` its hidden columns (Megatron's
    split): the proj product takes ``bproj / tp`` and no residual, the fp32
    partial outputs are summed over the group and rounded once to x's dtype,
    then the residual is added (:func:`.fused_attn._forward`'s order)."""
    if act not in ACTS:
        raise ValueError(f"unknown MLP activation {act!r} (expected one of {ACTS})")
    wf, wp = _weights(x, wfc, wproj)
    h = ops.layernorm_fwd(x, acc(lns), acc(lnb))
    g = ops.gemm_bias_act(h, wf, acc(bfc), act)
    if tp is None:
        return ops.gemm_bias_act(g, wp, acc(bproj), residual=x)
    _, a = ops.gemm_bias_act(g, wp, acc(bproj) / tp.model, preact=True)
    return x + _model_sum(a, tp).to(x.dtype)


def _backward(ops, gy, x, lns, lnb, wfc, bfc, wproj, act, tp=None):
    """The backward chain (Pallas ``_bwd_kernel``'s rounding order) for the
    output grad ``gy``: ``(dx, dlns, dlnb, dwfc, dbfc, dwproj, dbproj)``.
    Under a model axis the fp32 dh of this rank's hidden columns is summed
    over the group before the full-width LayerNorm backward; the weight
    grads stay this rank's."""
    wf, wp = _weights(x, wfc, wproj)
    gy = gy.to(x.dtype).contiguous()
    h = ops.layernorm_fwd(x, acc(lns), acc(lnb))
    g, a = ops.gemm_bias_act(h, wf, acc(bfc), act, preact=True)
    dbproj = ops.colsum(gy)
    dwproj = ops.gemm_wgrad(gy, g)
    da = ops.gemm_dgrad(gy, wp, rounded=True, act=act, preact=a)
    dbfc = ops.colsum(da)  # of the rounded da, as in the Pallas kernel
    dwfc = ops.gemm_wgrad(da, h)
    dh = ops.gemm_dgrad(da, wf, rounded=False)
    if tp is not None:
        dh = _model_sum(dh, tp)
    dx, dlns, dlnb = ops.layernorm_bwd(x, acc(lns), dh, residual=gy)
    return dx, dlns, dlnb, dwfc, dbfc, dwproj, dbproj


class _FusedLNMLP(torch.autograd.Function):
    """Autograd boundary of the chains, for ``ops`` the kernels or their
    plain versions. Takes the fp32 params, casts the weight matrices to x's
    dtype inside, and returns their grads in the params' dtypes and torch
    shapes; ``act`` and ``ops`` get none."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wfc, bfc, wproj, bproj, act, ops, tp=None):
        out = _forward(ops, x, lns, lnb, wfc, bfc, wproj, bproj, act, tp)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, lns, lnb, wfc, bfc, wproj, bproj)
            ctx.act, ctx.ops, ctx.tp = act, ops, tp
        if x.is_cuda and ops is KERNEL_OPS:
            LAUNCHES["fused_ln_mlp_block"] += 1
        return out

    @staticmethod
    def backward(ctx, gy):
        x, lns, lnb, wfc, bfc, wproj, bproj = ctx.saved_tensors
        grads = _backward(ctx.ops, gy, x, lns, lnb, wfc, bfc, wproj, ctx.act, ctx.tp)
        if x.is_cuda and ctx.ops is KERNEL_OPS:
            LAUNCHES["fused_ln_mlp_block_bwd"] += 1
        dx, *rest = grads
        params = (lns, lnb, wfc, bfc, wproj, bproj)
        return (dx, *(d.to(p.dtype) for d, p in zip(rest, params)), None, None, None)


def fused_ln_mlp_block(
    x: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wfc: torch.Tensor,
    bfc: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    act: str = "quick_gelu",
    tp=None,
) -> torch.Tensor:
    """x + proj(act(fc(LN(x)))). x: [B, T, C]; wfc: [E, C]; wproj: [C, E].
    ``tp``: the mesh whose model axis E is split over (this rank's rows of
    ``wfc`` and columns of ``wproj``), or None."""
    return _FusedLNMLP.apply(x, lns, lnb, wfc, bfc, wproj, bproj, act, KERNEL_OPS, tp)


def _forward_int8(ops, x, lns, lnb, wfc, bfc, wproj, bproj, act, tp=None):
    """The int8 forward chain (Pallas ``_fwd_int8_kernel``'s rounding order).
    Under a model axis each rank quantizes its own weight slices (the proj
    scales over its E/tp rows) and the activation's per-token scale is taken
    over its hidden columns (``fused_ln_mlp_block_int8``); the fp32 partial
    outputs are summed, rounded once, then the residual is added."""
    if act not in ACTS:
        raise ValueError(f"unknown MLP activation {act!r} (expected one of {ACTS})")
    wf8, sfc = ops.rowquant(wfc.float().contiguous())
    wp8, spj = ops.rowquant(wproj.float().contiguous())
    h8, hs = ops.layernorm_rowquant(x, acc(lns), acc(lnb))
    g = ops.gemm_i8(h8, hs, wf8, sfc, acc(bfc), act=act, out_dtype=torch.float32)
    g8, gs = ops.rowquant(g)
    if tp is None:
        return ops.gemm_i8(g8, gs, wp8, spj, acc(bproj), residual=x, out_dtype=x.dtype)
    y = ops.gemm_i8(g8, gs, wp8, spj, acc(bproj) / tp.model, out_dtype=torch.float32)
    return x + _model_sum(y, tp).to(x.dtype)


class _FusedLNMLPInt8(torch.autograd.Function):
    """The int8 chain behind an autograd boundary whose backward raises: the
    sub-block is forward only, as the Pallas kernel has no VJP."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wfc, bfc, wproj, bproj, act, ops, tp=None):
        out = _forward_int8(ops, x, lns, lnb, wfc, bfc, wproj, bproj, act, tp)
        if x.is_cuda and ops is KERNEL_OPS:
            LAUNCHES["fused_ln_mlp_block_int8"] += 1
        return out

    @staticmethod
    def backward(ctx, gy):
        raise RuntimeError(
            "the int8 MLP sub-block is forward only: it has no backward. Run it under "
            "torch.no_grad() (a frozen tower, serving), not on a trainable tower")


def fused_ln_mlp_block_int8(x, lns, lnb, wfc, bfc, wproj, bproj, act="quick_gelu", tp=None):
    """Int8 x + proj(act(fc(LN(x)))): forward only. Same signature and
    semantics as :func:`fused_ln_mlp_block`; both products in int8."""
    return _FusedLNMLPInt8.apply(x, lns, lnb, wfc, bfc, wproj, bproj, act, KERNEL_OPS, tp)


def fused_ln_mlp_block_int8_plain(x, lns, lnb, wfc, bfc, wproj, bproj, act="quick_gelu", tp=None):
    return _FusedLNMLPInt8.apply(x, lns, lnb, wfc, bfc, wproj, bproj, act, PLAIN_OPS, tp)


def fused_ln_mlp_block_plain(x, lns, lnb, wfc, bfc, wproj, bproj, act="quick_gelu", tp=None):
    """:func:`fused_ln_mlp_block` on the plain versions, forward and backward
    (the chain above), on any device."""
    return _FusedLNMLP.apply(x, lns, lnb, wfc, bfc, wproj, bproj, act, PLAIN_OPS, tp)

