"""Attention on separate q, k, v, and the dispatcher the layers call.

Port of the Pallas kernels ``vipant_tpu/ops/attention.py::_fwd_kernel`` /
``::_bwd_kernel`` (and their ``[B, T, H, D]`` twins ``_fwd_kernel4`` /
``_bwd_kernel4``) and of the public ops ``flash_attention`` and
``attention``. The hand-written kernels (:func:`.kernels.flash_attention_fwd`,
``_bwd``, ``_dbias``; ``csrc/flash_attention.cu``) read q, k and v through
``[B, T, H, 64]`` strides, so the sections of a packed projection and
transposed views go in without a copy, and take queries and keys of
different lengths.

On the TPU the dispatcher sent only equal-length attention without a boolean
mask to its kernel and everything else to XLA's attention. The port has no
such second path: every attention that is not the fused sub-block
(:mod:`.fused_attn`) runs :func:`flash_attention`, cross-attention with
``Tq != Tk`` included. Not carried over: the heads-per-block and VMEM
heuristics and their environment switches, the mesh partitioning and the
ring-attention branch.

``causal`` is folded into the bias before the launch (the kernel tests no
index), and every bias is clamped at -1e30, as the JAX op does: a row that is
masked everywhere comes out uniform, not NaN.

``flash_attention_plain`` runs the same function, forward and backward, on
the kernels' plain versions, on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import KERNEL_OPS, PLAIN_OPS

NEG_INF = -1e30


class _FlashAttention(torch.autograd.Function):
    """Autograd boundary of the three kernels (or their plain versions):
    saves q, k, v, the bias, o and the logsumexp; nothing quadratic."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, bias_grad, ops):
        o, lse = ops.flash_attention_fwd(q, k, v, bias, scale)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, bias, o, lse)
            ctx.scale, ctx.bias_grad, ctx.ops = scale, bias_grad, ops
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        ops, scale = ctx.ops, ctx.scale
        g = g.to(q.dtype).contiguous()
        dq, dk, dv, delta = ops.flash_attention_bwd(q, k, v, bias, o, lse, g, scale)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            # a constant mask stays in the softmax recompute; only the sum is skipped
            dbias = (ops.flash_attention_dbias(q, k, v, bias, lse, delta, g, scale).to(bias.dtype)
                     if ctx.bias_grad else torch.zeros_like(bias))
        return dq, dk, dv, dbias, None, None, None


def _flash(ops, q, k, v, bias, causal, bias_grad):
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[-1]
    if causal:
        if Tq != Tk:
            raise ValueError(f"causal attention needs equal lengths, got {Tq} and {Tk}")
        causal_bias = torch.triu(torch.full((Tq, Tq), NEG_INF, device=q.device), diagonal=1)
        bias = causal_bias if bias is None else bias.float() + causal_bias
    if bias is not None:
        if tuple(bias.shape) != (Tq, Tk):
            raise ValueError(f"bias must be [{Tq}, {Tk}], got {tuple(bias.shape)}")
        dt = torch.promote_types(bias.dtype, torch.float32)
        bias = torch.clamp(bias.to(dt), min=NEG_INF).contiguous()
    return _FlashAttention.apply(q, k, v, bias, 1.0 / float(D ** 0.5), bias_grad, ops)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False,
                    bias_grad: bool = True) -> torch.Tensor:
    """q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; ``bias``: optional additive
    [Tq, Tk]; ``causal`` adds the causal mask (equal lengths). Returns
    [B, Tq, H, D]. With ``bias_grad=False`` the bias gets a zero grad and the
    [Tq, Tk] sum over items and heads is not taken. On CUDA: bf16, D = 64."""
    return _flash(KERNEL_OPS, q, k, v, bias, causal, bias_grad)


def flash_attention_plain(q, k, v, bias=None, causal=False, bias_grad=True):
    return _flash(PLAIN_OPS, q, k, v, bias, causal, bias_grad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
              bias_grad: bool = False) -> torch.Tensor:
    """The dispatcher of the layers: :func:`flash_attention` for every shape.
    Biases reaching it are constant masks (causal, packing), so the backward
    skips the bias grad unless ``bias_grad=True``; leading singleton axes of
    the bias are dropped."""
    if mask is not None:
        raise ValueError("attention takes additive biases, not boolean masks: fold the mask "
                         "into a bias")
    if bias is not None:
        while bias.dim() > 2:
            if bias.shape[0] != 1:
                raise ValueError(f"attention expects a [Tq, Tk] bias, got {tuple(bias.shape)}")
            bias = bias[0]
    return flash_attention(q, k, v, bias=bias, bias_grad=bias_grad)
