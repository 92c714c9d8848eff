"""Sequence (context) parallelism over the ``seq`` axis: ring attention.

Counterpart of ``vipant_tpu/parallel/sequence.py`` and of the seq branch of
``StackedTransformer`` (``vipant_tpu/nn/layers.py:528-580``). A stacked
trunk under ``mesh.seq > 1`` splits its tokens over the seq ranks
(:func:`split_tokens`); every token-wise op runs on the local tokens on its
hand-written chain (the LayerNorm kernels, the qkv and out-projection
``gemm_bias_act`` with the residual, the whole MLP chain), and the attention
leaves the fused sub-block for :func:`ring_attention`: key and value blocks
pass around the ring by point-to-point exchange while each rank folds them
into an online softmax (m, l, o), so no rank holds the [T, T] scores or the
whole sequence. The JAX package computes this ring with plain
``dot_general`` and no Pallas kernel; so does the port, in plain PyTorch
products. The trunk's output is gathered back over the ring
(:func:`gather_tokens`) and everything after it runs whole on every rank.

A 2-D additive mask (causal, or the token pack) is split by query rows, and
each ring step slices the key block of the rank it came from. The grads
flow back through the ring's exchanges; the trunk's parameters see only
their rank's tokens, so their grads are summed over the seq group by the
step (:func:`..parallel.collectives.all_reduce_grads`, ``seq_sum``).
"""

from __future__ import annotations

import math
import threading
import warnings
from contextlib import contextmanager
from typing import Optional

import torch

from ..ops.kernels import KERNEL_OPS, PLAIN_OPS, acc
from .collectives import _all_gather, exchange
from .mesh import Mesh


_STATE = threading.local()


def ring_mesh() -> Optional[Mesh]:
    """The mesh whose seq ring the current trunk's tokens are split over
    (inside :func:`ring_context`), or None."""
    return getattr(_STATE, "mesh", None)


@contextmanager
def ring_context(mesh: Mesh):
    """The extent in which the self-attention sub-blocks attend over the
    ring (``seq_context`` of the JAX package)."""
    prev = ring_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def warn_whole(mesh: Mesh, T: int, bias: Optional[torch.Tensor]) -> None:
    """JAX's warning when a seq axis cannot split a trunk, which then runs
    whole on every seq rank."""
    why = (f"token count {T} % seq={mesh.seq} != 0" if T % mesh.seq else
           f"mask shape/dtype {tuple(bias.shape)}/{bias.dtype} (need additive 2-D, rows % "
           f"{mesh.seq} == 0)")
    warnings.warn(f"seq-parallel trunk disqualified ({why}); running the UNSHARDED sequential "
                  f"path: compute replicates {mesh.seq}x over the seq axis", stacklevel=3)


def _ring_peers(mesh: Mesh):
    ranks, i = mesh.ranks("seq"), mesh.index("seq")
    S = len(ranks)
    return ranks[(i + 1) % S], ranks[(i - 1) % S]


class _RingShift(torch.autograd.Function):
    """This rank's block to the next rank of the ring, the previous rank's
    here; the backward sends the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        nxt, prv = _ring_peers(mesh)
        out = torch.empty_like(x)
        exchange(mesh, send=x.contiguous(), dst=nxt, recv=out, src=prv)
        return out

    @staticmethod
    def backward(ctx, g):
        nxt, prv = _ring_peers(ctx.mesh)
        out = torch.empty_like(g)
        exchange(ctx.mesh, send=g.contiguous(), dst=prv, recv=out, src=nxt)
        return out, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   bias: Optional[torch.Tensor] = None,
                   p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Exact attention over a token-split sequence (``ring_attention`` of
    the JAX package, :69). ``q, k, v``: this rank's [B, T_local, H, D];
    ``bias``: this rank's query rows of the global additive mask, [T_local,
    T] or [B or 1, H or 1, T_local, T] (rank 3 is ambiguous and raises).
    Scores and the softmax statistics in fp32; the probabilities are
    rounded to ``p_dtype`` (default v's dtype) before the product with v, as
    the JAX ring casts them to v's. A row whose keys are all masked so far
    keeps zero weight, and a row masked over every block returns 0 (the
    flash convention), finite either way. Returns [B, T_local, H, D] in q's
    dtype."""
    S, me = mesh.seq, mesh.index("seq")
    B, Tl, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    p_dtype = p_dtype or v.dtype
    if bias is not None:
        if bias.dim() == 3:
            raise ValueError("ring_attention bias rank 3 is ambiguous ([B, Tl, T] vs [H, Tl, T]): "
                             "pass [Tl, T] or an explicit [B, H, Tl, T]")
        if bias.shape[-2] != Tl or bias.shape[-1] != Tl * S:
            raise ValueError(f"the ring bias must be the local [.., {Tl}, {Tl * S}] row shard, got "
                             f"{tuple(bias.shape)}")
        bias = bias.float()
        while bias.dim() < 4:
            bias = bias[None]
    qf = q.transpose(1, 2).float()  # [B, H, Tl, D]
    m = torch.full((B, H, Tl, 1), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(S):
        kb, vb = kv[0].transpose(1, 2).float(), kv[1].transpose(1, 2).float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # [B, H, Tl, Tk]
        if bias is not None:
            src = (me - step) % S  # the rank this key block came from
            s = s + bias[..., src * Tl:(src + 1) * Tl]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # a row whose keys so far are all -inf keeps zero weight, not NaN
        m_sub = torch.clamp(m_new, min=-1e30)
        p = torch.exp(s - m_sub)
        corr = torch.exp(m - m_sub)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(p_dtype).float(), vb)
        m = m_new
        if step + 1 < S:
            kv = _RingShift.apply(kv, mesh)
    out = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.transpose(1, 2)


def usable(mesh: Optional[Mesh], T: int, bias: Optional[torch.Tensor]) -> bool:
    """Whether a trunk of ``T`` tokens with ``bias`` rings over ``mesh``'s
    seq axis: T and the mask's rows split over it, and the mask is additive
    and 2-D (``vipant_tpu/nn/layers.py:528-549``)."""
    if mesh is None or mesh.seq == 1:
        return False
    ok = bias is None or (bias.dim() == 2 and bias.dtype != torch.bool and bias.shape[0] % mesh.seq == 0)
    return ok and T % mesh.seq == 0


class _SplitTokens(torch.autograd.Function):
    """This rank's tokens of a sequence every rank holds whole; the backward
    gathers every rank's token grads (each rank's work sees its tokens
    only)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        Tl = x.shape[1] // mesh.seq
        i = mesh.index("seq")
        return x[:, i * Tl:(i + 1) * Tl].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim1(g, ctx.mesh), None


def _gather_dim1(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = _all_gather(x.transpose(0, 1).contiguous(), mesh, "seq")  # [S * Tl, B, ...]
    return parts.transpose(0, 1).contiguous()


class _GatherTokens(torch.autograd.Function):
    """Every rank's tokens along dim 1, in the ring's order; the backward
    hands this rank its tokens' cotangents (every rank computes the same
    loss from the whole sequence)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.Tl = mesh, x.shape[1]
        return _gather_dim1(x, mesh)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index("seq")
        return g[:, i * ctx.Tl:(i + 1) * ctx.Tl].contiguous(), None


def split_tokens(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SplitTokens.apply(x, mesh)


def gather_tokens(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherTokens.apply(x, mesh)


def split_rows(bias: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    """This rank's query rows of a [T, T] mask."""
    if bias is None:
        return None
    Tl = bias.shape[0] // mesh.seq
    i = mesh.index("seq")
    return bias[i * Tl:(i + 1) * Tl]


class _RingBlock(torch.autograd.Function):
    """The pre-LN attention sub-block ``x + proj(ring(qkv(LN(x))))`` on this
    rank's tokens: the LayerNorm and both products on ``ops`` (the
    hand-written kernels on the card, their plain versions on the CPU),
    the attention by :func:`ring_attention`. Backward: the chain of
    ``ops.fused_attn._backward`` with the ring's grads from autograd through
    its exchanges."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, mesh, ops):
        dt = x.dtype
        wq, wo = wqkv.to(dt).contiguous(), wout.to(dt).contiguous()
        h = ops.layernorm_fwd(x, acc(lns), acc(lnb))
        qkv = ops.gemm_bias_act(h, wq, acc(bqkv))
        B, Tl, C3 = qkv.shape
        C = C3 // 3
        train = any(ctx.needs_input_grad)
        q, k, v = (qkv[..., i * C:(i + 1) * C].float().reshape(B, Tl, heads, C // heads)
                   .requires_grad_(train) for i in range(3))
        with torch.enable_grad() if train else torch.no_grad():
            o = ring_attention(q, k, v, mesh, bias, p_dtype=dt).to(dt)
        o2 = o.detach().reshape(B, Tl, C).contiguous()
        out = ops.gemm_bias_act(o2, wo, acc(bout), residual=x)
        if train:
            ctx.save_for_backward(x, lns, lnb, wq, wo, o2)
            ctx.ring = (q, k, v, o)
            ctx.ops, ctx.dtypes = ops, (lnb.dtype, wqkv.dtype, bqkv.dtype, wout.dtype, bout.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, lns, lnb, wq, wo, o2 = ctx.saved_tensors
        q, k, v, o = ctx.ring
        ops = ctx.ops
        B, Tl, C = o2.shape
        g = g.to(x.dtype).contiguous()
        dbout = ops.colsum(g)
        do = ops.gemm_dgrad(g, wo, rounded=True)
        dwout = ops.gemm_wgrad(g, o2)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do.reshape(o.shape))
        dqkv = torch.cat([t.reshape(B, Tl, C) for t in (dq, dk, dv)], dim=-1).contiguous()
        del ctx.ring
        dbqkv = ops.colsum(dqkv)
        dqkv_b = dqkv.to(x.dtype)
        h = ops.layernorm_fwd(x, acc(lns), acc(lnb))  # recomputed, as the fused chain does
        dh = ops.gemm_dgrad(dqkv_b, wq, rounded=False)
        dwqkv = ops.gemm_wgrad(dqkv_b, h)
        dx, dlns, dlnb = ops.layernorm_bwd(x, acc(lns), dh, residual=g)
        tl, tq, tbq, to, tbo = ctx.dtypes
        return (dx, dlns.to(lns.dtype), dlnb.to(tl), dwqkv.to(tq), dbqkv.to(tbq), dwout.to(to),
                dbout.to(tbo), None, None, None, None)


def ring_ln_attention_block(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, mesh):
    """``x + proj(attn(LN(x)))`` on this rank's tokens ``x`` [B, T_local, C],
    the attention over the whole ring; ``bias`` this rank's query rows of
    the [T, T] mask."""
    return _RingBlock.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, mesh, KERNEL_OPS)


def ring_ln_attention_block_plain(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, mesh):
    """:func:`ring_ln_attention_block` on the plain versions, on any device."""
    return _RingBlock.apply(x, lns, lnb, wqkv, bqkv, wout, bout, bias, heads, mesh, PLAIN_OPS)
