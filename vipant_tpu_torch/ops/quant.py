"""Int8 quantization helpers of the forward-only int8 sub-blocks.

Counterpart of ``vipant_tpu/ops/quant.py``. The scheme is post-training
dynamic quantization: weights per output channel, symmetric int8;
activations per token (per row), symmetric int8, quantized where the
sub-block has them. Forward only: training stays bf16, and a tower may run
int8 inside a training step only where no gradient flows through it (a
frozen tower, ``model.image.int8_frozen``).

:func:`quantize_cols` and :func:`quantize_rows` are the plain functions on
tensors. On the card the sub-blocks quantize with the hand-written
``rowquant`` kernel (:mod:`.kernels`), which computes the same codes and
scales; a weight in the torch [out, in] layout is quantized per output
column by quantizing its rows.

The switch is a ``contextvars`` scope, not a process-wide flag: an int8
engine beside a bf16 one, or a frozen int8 tower beside a trainable bf16
one, each see their own setting. The TPU-era ``VIPANT_INT8_*`` environment
switches of the JAX package are not carried over.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_INT8_FWD = contextvars.ContextVar("vipant_torch_int8_fwd", default=False)


@contextlib.contextmanager
def int8_fwd_context(enabled: bool = True):
    """Inside, the attention and MLP sub-blocks of :mod:`..nn.layers` run
    their forward-only int8 variants (``enabled=False`` turns an enclosing
    scope off)."""
    token = _INT8_FWD.set(bool(enabled))
    try:
        yield
    finally:
        _INT8_FWD.reset(token)


def int8_fwd_enabled() -> bool:
    return _INT8_FWD.get()


def _quantize(x: torch.Tensor, dim: int):
    x32 = x.float()
    # a tensor divisor: on CUDA, dividing by a Python scalar multiplies by its
    # reciprocal, which is an ulp off the division the JAX package does
    scale = x32.abs().amax(dim=dim, keepdim=True) / x32.new_tensor(127.0) + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_cols(w: torch.Tensor):
    """Per-output-column symmetric int8: w [K, M] -> (w_i8 [K, M], scale
    [1, M] fp32) with w ~ w_i8 * scale."""
    return _quantize(w, 0)


def quantize_rows(x: torch.Tensor):
    """Per-row (per-token) symmetric int8: x [..., K] -> (x_i8, scale
    [..., 1] fp32) with x ~ x_i8 * scale. Rounds half to even and divides by
    the scale; an all-zero row gets scale 1e-12 and codes 0."""
    return _quantize(x, -1)
