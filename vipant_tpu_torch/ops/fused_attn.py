"""The pre-LN attention sub-block ``x + proj(attn(LN(x)))`` and its backward.

Port of the Pallas kernels ``vipant_tpu/ops/fused_attn.py::_fwd_kernel`` and
``::_bwd_kernel`` and their public ops ``fused_ln_attention_block`` /
``fused_attention_block``. On the TPU the whole sub-block ran in one
VMEM-resident grid step per item, and the backward recomputed it there. On
Hopper its [T, 3C] projection and [H, T, T] scores do not fit one block's
shared memory, so each direction is a chain of hand-written kernels
(:mod:`.kernels`):

    forward                                   backward (g = d out)
    h   = layernorm_fwd(x)       (optional)   h    = layernorm_fwd(x)     (recomputed)
    qkv = gemm_bias_act(h, Wqkv, bqkv)        dbout = colsum(g)
    o   = attention_fwd(qkv, bias)            do   = gemm_dgrad(g, Wout)        bf16
    out = gemm_bias_act(o, Wout, bout,        dWout = gemm_wgrad(g, o)
                        residual=x)           dqkv = attention_bwd(qkv, do)    fp32 + bf16
                                              dbqkv = colsum(dqkv fp32)
                                              dh   = gemm_dgrad(dqkv, Wqkv)    fp32
                                              dWqkv = gemm_wgrad(dqkv, h)
                                              dx, dlns, dlnb = layernorm_bwd(x, dh, +g)

The forward keeps qkv, o and the softmax's row statistics for the backward
(the Pallas kernel stashed qkv above T = 128 and recomputed the rest); the
backward recomputes only h. Saved per layer at the audio tower's B = 64,
T = 306, C = 768: qkv 90.2 MB, o 30.1 MB, statistics 1.9 MB, besides x.

Weights are in the torch ``nn.MultiheadAttention`` layout the port's modules
hold: ``wqkv`` [3C, C] (``in_proj_weight``), ``bqkv`` [3C], ``wout`` [C, C]
(``out_proj.weight``, [out, in]), ``bout`` [C]. The JAX package's [C, 3, C]
qkv layout exists for TPU head sharding and is not carried over.

``*_plain`` run the same chains, forward and backward, on the kernels'
plain versions: the same function, for holding the kernels to on the card.

``*_int8`` are the forward-only int8 variants, port of the Pallas kernel
``vipant_tpu/ops/fused_attn.py::_fwd_int8_kernel`` and its public ops: the
qkv and out projections run int8 x int8 -> int32, the score and context
products stay bf16. Per call:

    wq8, swq = rowquant(bf16(Wqkv))           weights: cast to x's dtype first,
    wo8, swo = rowquant(bf16(Wout))           then per output column
    h8, sh   = layernorm_rowquant(x)          (rowquant(x) without LN)
    qkv = gemm_i8(h8, sh, wq8, swq, bqkv)     bf16, column scale first
    o   = attention_fwd(qkv, bias, fp32_out)  fp32, unrounded
    o8, so = rowquant(o)                      one scale per token over all heads
    out = gemm_i8(o8, so, wo8, swo, bout, residual=x)

The weights are quantized in every call, as the jitted JAX call does: two
small launches, and no cache to go stale when a weight changes. Asking for
a gradient through an int8 sub-block raises in its backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import KERNEL_OPS, LAUNCHES, PLAIN_OPS, acc


def canon_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """fp32, with -inf clamped to -1e30 so a causal (-inf) plus packing
    (-1e30) mask stays finite and no softmax row turns NaN."""
    if bias is None:
        return None
    return torch.clamp(bias.float(), min=-1e30).contiguous()


def _scale(C: int, heads: int) -> float:
    return 1.0 / float((C // heads) ** 0.5)


def _head_scale(qkv: torch.Tensor, heads: int) -> float:
    """The softmax scale of ``heads`` heads in ``qkv`` [..., 3C] (C the
    heads this call holds: all of them, or a model rank's share)."""
    return _scale(qkv.shape[-1] // 3, heads)


def _model_sum(y: torch.Tensor, tp) -> torch.Tensor:
    """The sum over the model group of each rank's fp32 partial ``y``, in
    place."""
    from ..parallel.collectives import _all_reduce_

    return _all_reduce_(y, tp, "model")


def _forward(ops, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, keep=False, tp=None):
    """The forward chain. With ``keep`` also returns what the backward reads:
    ``(wqkv, wout)`` in x's dtype, qkv, o and the attention statistics.
    Under a model axis (``tp``, the mesh) the weights are this rank's head
    block and ``heads`` its heads (``vipant_tpu/ops/fused_attn.py:_fwd_sharded``):
    the out projection takes ``bout / tp`` and no residual, the ranks' fp32
    partial products (the pre-activation the kernel keeps) are summed over
    the group and rounded once to x's dtype, then the residual is added:
    the rounding of the whole product. The JAX package rounds each partial
    to bf16 before its psum; that order put 9 of the 33 grads of a bf16 VA
    step below cosine 0.999 to the one-rank step (CPU, tiny widths), this
    one 1."""
    dt = x.dtype
    wq, wo = wqkv.to(dt).contiguous(), wout.to(dt).contiguous()
    h = ops.layernorm_fwd(x, acc(lns), acc(lnb)) if lns is not None else x
    qkv = ops.gemm_bias_act(h, wq, acc(bqkv))
    att = ops.attention_fwd(qkv, canon_bias(bias), heads, _head_scale(qkv, heads), stats=keep)
    o, stats = att if keep else (att, None)
    if tp is None:
        out = ops.gemm_bias_act(o, wo, acc(bout), residual=x if lns is not None else None)
    else:
        _, a = ops.gemm_bias_act(o, wo, acc(bout) / tp.model, preact=True)
        out = _model_sum(a, tp).to(x.dtype)
        out = x + out if lns is not None else out
    return (out, (wq, wo, qkv, o, stats)) if keep else out


def _backward(ops, g, x, lns, lnb, bqkv, bias, heads, kept, tp=None):
    """The backward chain (Pallas ``_bwd_kernel``'s rounding order) for the
    output grad ``g``: ``(dx, dlns, dlnb, dwqkv, dbqkv, dwout, dbout)``, the
    LN grads None for the bare variant. Under a model axis the chain runs on
    this rank's heads and its dh (fp32 before the LayerNorm, as the whole
    chain keeps it) is summed over the group before the full-width
    LayerNorm backward (``vipant_tpu/ops/fused_attn.py:_bwd_local_tp``); the
    weight grads stay this rank's."""
    wq, wo, qkv, o, stats = kept
    g = g.to(x.dtype).contiguous()
    h = ops.layernorm_fwd(x, acc(lns), acc(lnb)) if lns is not None else x
    dbout = ops.colsum(g)
    do = ops.gemm_dgrad(g, wo, rounded=True)
    dwout = ops.gemm_wgrad(g, o)
    dqkv, dqkv_b = ops.attention_bwd(qkv, do, canon_bias(bias), heads, _head_scale(qkv, heads),
                                     stats)
    dbqkv = ops.colsum(dqkv)
    dh = ops.gemm_dgrad(dqkv_b, wq, rounded=lns is None)
    dwqkv = ops.gemm_wgrad(dqkv_b, h)
    if tp is not None:
        dh = _model_sum(dh, tp)
    if lns is None:
        return dh, None, None, dwqkv, dbqkv, dwout, dbout
    dx, dlns, dlnb = ops.layernorm_bwd(x, acc(lns), dh, residual=g)
    return dx, dlns, dlnb, dwqkv, dbqkv, dwout, dbout


def _name(lns) -> str:
    return "fused_ln_attention_block" if lns is not None else "fused_attention_block"


class _FusedAttention(torch.autograd.Function):
    """Autograd boundary of the chains, for ``ops`` the kernels or their
    plain versions. Takes the fp32 params, casts the weight matrices to x's
    dtype inside, and returns their grads in the params' dtypes and torch
    shapes; the mask, ``heads`` and ``ops`` get none."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, ops, tp=None):
        train = any(ctx.needs_input_grad)
        out = _forward(ops, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, keep=train, tp=tp)
        if train:
            out, kept = out
            ctx.save_for_backward(x, lns, lnb, bqkv, bias, *kept)
            ctx.heads, ctx.ops, ctx.tp = heads, ops, tp
            ctx.dtypes = (wqkv.dtype, bqkv.dtype, wout.dtype, bout.dtype)
        if x.is_cuda and ops is KERNEL_OPS:
            LAUNCHES[_name(lns)] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, lns, lnb, bqkv, bias, *kept = ctx.saved_tensors
        dx, dlns, dlnb, dwq, dbq, dwo, dbo = _backward(
            ctx.ops, g, x, lns, lnb, bqkv, bias, ctx.heads, kept, tp=ctx.tp)
        if x.is_cuda and ctx.ops is KERNEL_OPS:
            LAUNCHES[_name(lns) + "_bwd"] += 1
        tq, tbq, to, tbo = ctx.dtypes
        ln = (None, None) if lns is None else (dlns.to(lns.dtype), dlnb.to(lnb.dtype))
        return (dx, *ln, dwq.to(tq), dbq.to(tbq), dwo.to(to), dbo.to(tbo), None, None, None, None)


def fused_ln_attention_block(
    x: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    heads: int = 12,
    tp=None,
) -> torch.Tensor:
    """x + proj(attn(LN(x))). x: [B, T, C]; lns/lnb: LayerNorm [C];
    bias: optional additive [T, T]. Returns [B, T, C] in x's dtype. ``tp``:
    the mesh whose model axis the weights are split over (this rank's head
    block, ``heads`` its heads; :mod:`...parallel.tensor`), or None."""
    return _FusedAttention.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, KERNEL_OPS, tp)


def fused_attention_block(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    heads: int = 12,
    tp=None,
) -> torch.Tensor:
    """proj(attn(x)): the packed attention without LN or residual."""
    return _FusedAttention.apply(x, None, None, wqkv, bqkv, wout, bout, bias, heads, KERNEL_OPS, tp)


def _forward_int8(ops, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, tp=None):
    """The int8 forward chain (Pallas ``_fwd_int8_kernel``'s rounding order).
    Under a model axis each rank quantizes its own weight slices and the
    context's per-token scale is taken over its own heads (``_fused_int8``);
    the fp32 partial outputs are summed, rounded once, then the residual is
    added, as in :func:`_forward`."""
    dt = x.dtype
    wq8, swq = ops.rowquant(wqkv.to(dt).contiguous())
    wo8, swo = ops.rowquant(wout.to(dt).contiguous())
    h8, sh = ops.layernorm_rowquant(x, acc(lns), acc(lnb)) if lns is not None else ops.rowquant(x)
    qkv = ops.gemm_i8(h8, sh, wq8, swq, acc(bqkv), out_dtype=dt, col_first=True)
    o = ops.attention_fwd(qkv, canon_bias(bias), heads, _head_scale(qkv, heads), fp32_out=True)
    o8, so = ops.rowquant(o)
    if tp is None:
        return ops.gemm_i8(o8, so, wo8, swo, acc(bout), residual=x if lns is not None else None,
                           out_dtype=dt)
    out = _model_sum(ops.gemm_i8(o8, so, wo8, swo, acc(bout) / tp.model, out_dtype=torch.float32),
                     tp).to(dt)
    return x + out if lns is not None else out


class _FusedAttentionInt8(torch.autograd.Function):
    """The int8 chain behind an autograd boundary whose backward raises: the
    sub-block is forward only, as the Pallas kernel has no VJP."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, ops, tp=None):
        out = _forward_int8(ops, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, tp)
        if x.is_cuda and ops is KERNEL_OPS:
            LAUNCHES[_name(lns) + "_int8"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "the int8 attention sub-block is forward only: it has no backward. Run it "
            "under torch.no_grad() (a frozen tower, serving), not on a trainable tower")


def fused_ln_attention_block_int8(x, lns, lnb, wqkv, bqkv, wout, bout, bias=None, heads=12,
                                  tp=None):
    """Int8 x + proj(attn(LN(x))): forward only. Same signature and
    semantics as :func:`fused_ln_attention_block`; the qkv and out
    projections in int8, the score and context products bf16."""
    return _FusedAttentionInt8.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, KERNEL_OPS,
                                     tp)


def fused_attention_block_int8(x, wqkv, bqkv, wout, bout, bias=None, heads=12):
    """Int8 proj(attn(x)) without LN or residual: forward only."""
    return _FusedAttentionInt8.apply(x, None, None, wqkv, bqkv, wout, bout, bias, heads, KERNEL_OPS)


def fused_ln_attention_block_int8_plain(x, lns, lnb, wqkv, bqkv, wout, bout, bias=None, heads=12,
                                        tp=None):
    return _FusedAttentionInt8.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, PLAIN_OPS,
                                     tp)


def fused_attention_block_int8_plain(x, wqkv, bqkv, wout, bout, bias=None, heads=12):
    return _FusedAttentionInt8.apply(x, None, None, wqkv, bqkv, wout, bout, bias, heads, PLAIN_OPS)


def fused_ln_attention_block_plain(x, lns, lnb, wqkv, bqkv, wout, bout, bias=None, heads=12,
                                   tp=None):
    """:func:`fused_ln_attention_block` on the plain versions, forward and
    backward (the chain above), on any device."""
    return _FusedAttention.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, PLAIN_OPS, tp)


def fused_attention_block_plain(x, wqkv, bqkv, wout, bout, bias=None, heads=12):
    return _FusedAttention.apply(x, None, None, wqkv, bqkv, wout, bout, bias, heads, PLAIN_OPS)

