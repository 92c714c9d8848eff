"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

Three kernels (``csrc/``) make up the two fused transformer sub-blocks:

- :func:`layernorm_fwd` (``csrc/layernorm.cu``): fp32-statistics LayerNorm,
  bf16 out;
- :func:`gemm_bias_act` (``csrc/gemm.cu``): ``epilogue(x . w^T + b)`` with an
  optional QuickGELU / exact GELU and an optional residual;
- :func:`attention_fwd` (``csrc/attention.cu``): exact two-pass softmax
  attention over the packed ``[B, T, 3C]`` projection.

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor, after checking device, dtype (bf16),
shapes, contiguity and alignment; it raises on anything the kernel does not
take. ``LAUNCHES[name]`` counts kernel launches and nothing else.

The plain versions follow the Pallas kernels' rounding order (see the notes
in the CUDA sources), so that they are the reference the kernels are held to
on the card and the path the CPU tests compare with the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import _build

LN_EPS = 1e-5
HEAD_DIM = 64  # the attention kernel's head dim
ACTS = {"none": 0, "quick_gelu": 1, "gelu": 2}

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def layernorm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = LN_EPS) -> torch.Tensor:
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def act_plain(a: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick_gelu":
        return quick_gelu(a)
    if act == "gelu":
        return a * (torch.erf(a / 2 ** 0.5) + 1) / 2
    return a


def gemm_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        act: str = "none",
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x.float(), w.float().t()) + b.float()
    y = act_plain(y, act).to(x.dtype)
    return y if residual is None else residual + y


def attention_plain(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int,
                    scale: float) -> torch.Tensor:
    B, T, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.view(B, T, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # [B, H, T, D]
    return o.transpose(1, 2).reshape(B, T, C)


# ---------------------------------------------------------------------------
# launch wrappers
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype == dtype, f"{name} must be {dtype} on CUDA, got {t.dtype}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"vt_{name}")(*args, stream)
    _build.check(lib, err, name)
    LAUNCHES[name] += 1


def layernorm_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics (eps 1e-5); the
    affine result is rounded once to ``x.dtype``. w, b: [C] fp32."""
    if not x.is_cuda:
        return layernorm_plain(x, w, b)
    C = x.shape[-1]
    _cuda_operand(x, "x", torch.bfloat16, x.device)
    for t, n in ((w, "w"), (b, "b")):
        _cuda_operand(t, n, torch.float32, x.device)
        _require(t.shape == (C,), f"{n} must be [{C}], got {tuple(t.shape)}")
    y = torch.empty_like(x)
    _launch("layernorm_fwd", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), x.numel() // C, C, LN_EPS)
    return y


def gemm_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str = "none",
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(x . w^T + b)`` rounded to ``x.dtype``, plus ``residual`` (added
    after the rounding). x: [..., K]; w: [N, K] (torch Linear layout);
    b: [N] fp32; residual: [..., N] like x."""
    _require(act in ACTS, f"unknown activation {act!r}")
    if not x.is_cuda:
        return gemm_bias_act_plain(x, w, b, act, residual)
    K = x.shape[-1]
    N = w.shape[0]
    _cuda_operand(x, "x", torch.bfloat16, x.device)
    _cuda_operand(w, "w", torch.bfloat16, x.device)
    _cuda_operand(b, "b", torch.float32, x.device)
    _require(w.dim() == 2 and w.shape[1] == K, f"w must be [N, {K}], got {tuple(w.shape)}")
    _require(b.shape == (N,), f"b must be [{N}], got {tuple(b.shape)}")
    _require(K % 8 == 0, f"K={K} must be a multiple of 8")
    out_shape = (*x.shape[:-1], N)
    if residual is not None:
        _cuda_operand(residual, "residual", torch.bfloat16, x.device)
        _require(tuple(residual.shape) == out_shape,
                 f"residual must be {out_shape}, got {tuple(residual.shape)}")
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _launch("gemm_bias_act", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            x.numel() // K, N, K, ACTS[act])
    return y


def attention_fwd(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int,
                  scale: float) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v for all heads. qkv: [B, T, 3C] with
    q|k|v sections and head-major columns inside each; bias: optional
    [T, T] fp32 (finite: clamp with ``canon_bias``). Returns [B, T, C]."""
    if not qkv.is_cuda:
        return attention_plain(qkv, bias, heads, scale)
    _require(qkv.dim() == 3 and qkv.shape[-1] % 3 == 0, f"qkv must be [B, T, 3C], got {tuple(qkv.shape)}")
    B, T, C3 = qkv.shape
    C = C3 // 3
    _require(C == heads * HEAD_DIM,
             f"the attention kernel takes head dim {HEAD_DIM}; got C={C}, heads={heads}")
    _cuda_operand(qkv, "qkv", torch.bfloat16, qkv.device)
    if bias is not None:
        _cuda_operand(bias, "bias", torch.float32, qkv.device)
        _require(tuple(bias.shape) == (T, T), f"bias must be [{T}, {T}], got {tuple(bias.shape)}")
    out = torch.empty((B, T, C), dtype=qkv.dtype, device=qkv.device)
    _launch("attention_fwd", qkv.device, qkv.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), B, T, heads, scale)
    return out
