"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

The kernels (``csrc/``) make up the two fused transformer sub-blocks and
their backward chains:

- :func:`layernorm_fwd` / :func:`layernorm_bwd` (``csrc/layernorm.cu``):
  fp32-statistics LayerNorm, and its backward with the residual grad and
  the per-column weight and bias grads, its rows walked as
  :func:`layernorm_bwd_split` plans and its sums added in the order of
  :func:`layernorm_bwd_ordered`;
- :func:`gemm_bias_act` (``csrc/gemm_fwd.cu``): ``epilogue(x . w^T + b)``
  with an optional QuickGELU / exact GELU, an optional residual and an
  optional fp32 copy of the pre-activation;
- :func:`gemm_dgrad` (``csrc/gemm_dgrad.cu``): ``dy . w`` with ``w`` read as
  stored, an optional activation-grad epilogue, fp32 or rounded out;
- :func:`gemm_wgrad` (``csrc/gemm_wgrad.cu``): ``a^T . b`` reduced over all
  rows, fp32 out, the rows split into the chunks :func:`wgrad_split` plans;
- :func:`colsum` (``csrc/reduce.cu``): fp32 column sums (the bias grads),
  the rows split into the chunks :func:`colsum_split` plans;
- :func:`attention_fwd` / :func:`attention_bwd` (``csrc/attention.cu``,
  ``csrc/attention_bwd.cu``): exact two-pass softmax attention over the
  packed ``[B, T, 3C]`` projection, and its backward; with ``fp32_out``
  the forward leaves the context unrounded in fp32, for the int8 sub-block;
- :func:`rowquant` / :func:`layernorm_rowquant` (``csrc/quant.cu``): per-row
  symmetric int8 codes and fp32 scales, of a tensor (a warp or a few per
  row, as :func:`rowquant_plan` picks) or of LayerNorm(x);
- :func:`gemm_i8` (``csrc/gemm_i8.cu``): int8 x int8 -> int32 product with
  the dequantizing epilogue (scales, bias, activation, residual);
- :func:`flash_attention_fwd` / :func:`flash_attention_bwd` /
  :func:`flash_attention_dbias` (``csrc/flash_attention.cu``): attention on
  separate q, k, v ``[B, T, H, 64]`` views of any strides, queries and keys
  of different lengths, with the logsumexp (in the blocks of
  :func:`flash_fwd_plan`); its backward from the logsumexp (in the blocks
  of :func:`flash_bwd_plan`); and the bias grad summed over items and
  heads in the chunks of :func:`dbias_split`, in the fixed order of
  :func:`flash_attention_dbias_ordered`;
- :func:`dot_variant` (``csrc/dot_variants.cu``): one product in the four
  operand orientations (the probe of ``experiments/fused_block_probe.py``),
  in the blocks of :func:`dot_plan`;
- :func:`patch_gather` (``csrc/patches.cu``): the patches of a ViT patch
  embedding (im2col) in ``F.unfold``'s layout, rounded to the tower's dtype,
  for the whole batch in one launch (``ops/patches.py``).

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor, after checking device, dtype (bf16
activations, fp32 params and grads), shapes, contiguity and alignment; it
raises on anything the kernel does not take. ``LAUNCHES[name]`` counts
kernel launches and nothing else.

The plain versions follow the Pallas kernels' rounding order (see the notes
in the CUDA sources), so that they are the reference the kernels are held to
on the card and the path the CPU tests compare with the JAX package. They
accumulate in fp32, or in float64 for float64 inputs, where every rounding
to the activations' dtype is a no-op (``tests/test_torch_backward_plain.py``
runs them through ``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .quant import quantize_rows

LN_EPS = 1e-5
HEAD_DIM = 64  # the attention kernels' head dim
LN_MAX_C = 2048  # the widest row the LayerNorm kernels take: 8 vectors of 16 bytes a lane of a warp
LN_BWD_WARPS = 4  # warps a block of layernorm_bwd, each walking its own rows; one partial row a block
FLASH_MAX_Q = 128  # query rows a block of flash_attention_fwd holds at most: 8 warps of 16
FLASH_ONE_TILE_Q = 80  # ... where every key fits one 64-key tile: 5 warps, 4 blocks an SM
COLSUM_WARPS = 8  # warps a block of colsum; warp w sums rows w, w + 8, ... of the block's chunk
COLSUM_STRIP = 512  # bytes of a row one colsum block reads: 16 a lane of a warp
COLSUM_MIN_ROWS = 64  # the fewest rows a colsum chunk is given
FLASH_BWD_MAX_K = 64  # keys a block of flash_attention_bwd's dk, dv kernel holds at most: 4 warps of 16
FLASH_TILE = 64  # query rows and keys of a block of flash_attention_dbias (and of a tile the kernels stage)
DBIAS_BLOCKS_PER_SM = 2  # flash_attention_dbias's blocks an SM that dbias_split aims at
WGRAD_TILE = 128  # gemm_wgrad's output tile, both ways
WGRAD_STEP = 64  # rows of the reduction per pipeline stage of gemm_wgrad
WGRAD_CHUNK_COST = 40  # a row chunk's fixed cost (ring fill, partial tile out and in), in steps; fitted on the H100
SM_COUNT = 132  # streaming multiprocessors of the H100 the split is planned for
ROWQUANT_BLOCK_WARPS = 4  # warps a block of rowquant and layernorm_rowquant
# rowquant's (warps a row, loads a lane) instances, smallest first (quant.cu's kShapes, whose last,
# (4, 0), reads a row twice)
ROWQUANT_SHAPES = ((1, 2), (1, 3), (1, 4), (1, 6), (2, 8), (4, 6))
DOT_TILE = 64  # output rows and columns of a dot_variant block (rows: one warpgroup's wgmma)
DOT_STEP = 128  # k per stage of dot_variant
DOT_MAX_STAGES = 4  # stages dot_variant holds in shared memory at once: K <= 512 in one round trip
ACTS = {"none": 0, "quick_gelu": 1, "gelu": 2}
ORIENTATIONS = {"NN": (0, 0), "NT": (0, 1), "TN": (1, 0), "TT": (1, 1)}  # (a, b) transposed

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation dtype: fp32, or float64 for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _ln_stats(x: torch.Tensor, eps: float = LN_EPS):
    """(xhat, rstd) of the fp32-island LayerNorm, in the accumulation dtype.
    The statistics are taken in float64 and rounded once to that dtype, as
    the kernels' ``rows.cuh`` takes them: the mean is the row's float64 sum
    over C, which for bf16 values is exact in any order (while the row's
    values span less than 2^34 in magnitude), the variance is about that
    rounded mean, and rstd = 1 / sqrt(var + eps) with eps as an fp32 value.
    The sums of squares of two orders differ by float64 ulps, so a kernel's
    mean and rstd are this version's unless its float64 rstd lies within
    those ulps of a rounding boundary of the dtype."""
    x32, x64, C = acc(x), x.double(), x.shape[-1]
    mu = (x64.sum(dim=-1, keepdim=True) / C).to(x32.dtype)
    d = x64 - mu.double()
    var = (d * d).sum(dim=-1, keepdim=True) / C
    eps32 = torch.tensor(eps, dtype=torch.float32).item()
    rstd = (1.0 / torch.sqrt(var + eps32)).to(x32.dtype)
    return (x32 - mu) * rstd, rstd


def layernorm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = LN_EPS) -> torch.Tensor:
    xhat, _ = _ln_stats(x, eps)
    return (xhat * acc(w) + acc(b)).to(x.dtype)


def layernorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dh: torch.Tensor,
                        residual: Optional[torch.Tensor] = None):
    """Backward of :func:`layernorm_plain` given the fp32 grad ``dh`` of its
    output: ``(dx, dw, db)``. ``dx`` is rounded once to ``x.dtype`` after
    the optional ``residual`` grad is added; ``dw``, ``db`` sum over rows."""
    C = x.shape[-1]
    xhat, rstd = _ln_stats(x)
    dh = acc(dh)
    dw = (dh * xhat).reshape(-1, C).sum(0)
    db = dh.reshape(-1, C).sum(0)
    dxhat = dh * acc(w)
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    if residual is not None:
        dx = dx + acc(residual)
    return dx.to(x.dtype), dw, db


def layernorm_bwd_ordered(x: torch.Tensor, w: torch.Tensor, dh: torch.Tensor,
                          residual: Optional[torch.Tensor] = None):
    """:func:`layernorm_bwd_plain` with the weight and bias grads summed in
    the order of the kernel, one fp32 addition at a time: warp g of the plan
    of :func:`layernorm_bwd_split` adds ``dh * xhat`` and ``dh`` over its
    rows in order, the ``LN_BWD_WARPS`` warps of a block are added in order
    into its partial row, and the partial rows are summed as
    :func:`colsum_ordered` sums an fp32 matrix. The kernel's db equals it
    bitwise (its dw only within fp32 rounding)."""
    C = x.shape[-1]
    dx, _, _ = layernorm_bwd_plain(x, w, dh, residual)
    xhat, _ = _ln_stats(x)
    g = acc(dh).reshape(-1, C)
    terms = torch.cat((g * xhat.reshape(-1, C), g), dim=1)  # [rows, 2C]
    rows = terms.shape[0]
    if rows == 0:
        sums = terms.sum(0)
    else:
        warps, per = layernorm_bwd_split(rows, C)
        blocks = -(-warps // LN_BWD_WARPS)
        terms = torch.nn.functional.pad(terms, (0, 0, 0, blocks * LN_BWD_WARPS * per - rows))
        terms = terms.view(blocks, LN_BWD_WARPS, per, 2 * C)
        s = torch.zeros((blocks, LN_BWD_WARPS, 2 * C), dtype=terms.dtype, device=terms.device)
        for r in range(per):
            s = s + terms[:, :, r]
        part = s[:, 0]
        for v in range(1, LN_BWD_WARPS):
            part = part + s[:, v]
        sums = colsum_ordered(part)
    return dx, sums[:C], sums[C:]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def act_plain(a: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick_gelu":
        return quick_gelu(a)
    if act == "gelu":
        return a * (torch.erf(a / 2 ** 0.5) + 1) / 2
    return a


def act_grad_plain(a: torch.Tensor, act: str) -> torch.Tensor:
    """d act(a) / d a, elementwise (``_act_vjp`` of the JAX package)."""
    if act == "quick_gelu":
        sig = torch.sigmoid(1.702 * a)
        return sig * (1.0 + 1.702 * a * (1.0 - sig))
    if act == "gelu":
        phi = torch.exp(-0.5 * a * a) * (2 * torch.pi) ** -0.5
        return 0.5 * (1.0 + torch.erf(a / 2 ** 0.5)) + a * phi
    return torch.ones_like(a)


def gemm_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        act: str = "none", residual: Optional[torch.Tensor] = None,
                        preact: bool = False):
    a = torch.matmul(acc(x), acc(w).t()) + acc(b)
    y = act_plain(a, act).to(x.dtype)
    y = y if residual is None else residual + y
    return (y, a) if preact else y


def gemm_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, rounded: bool, act: str = "none",
                     preact: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(acc(dy), acc(w))
    if act != "none":
        y = y * act_grad_plain(preact, act)
    return y.to(dy.dtype) if rounded else y


def gemm_wgrad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(acc(a).reshape(-1, a.shape[-1]).t(), acc(b).reshape(-1, b.shape[-1]))


def colsum_plain(x: torch.Tensor) -> torch.Tensor:
    return acc(x).reshape(-1, x.shape[-1]).sum(0)


def colsum_ordered(x: torch.Tensor) -> torch.Tensor:
    """:func:`colsum_plain` with the fp32 additions in the order of the
    kernel, one by one: in each chunk of :func:`colsum_split`, group w of
    ``COLSUM_WARPS`` adds rows w, w + 8, ... in turn, then the groups are
    added in order into the chunk's partial row; the partial rows are summed
    the same way, as one chunk. The kernel's result equals it bitwise."""
    N = x.shape[-1]
    x2 = acc(x).reshape(-1, N)
    W = COLSUM_WARPS

    def chunk_sums(t, chunks, per):  # [rows, N] -> [chunks, N]
        t = torch.nn.functional.pad(t, (0, 0, 0, chunks * per - t.shape[0])).view(chunks, per // W, W, N)
        s = torch.zeros((chunks, W, N), dtype=t.dtype, device=t.device)
        for k in range(per // W):
            s = s + t[:, k]
        out = s[:, 0]
        for w in range(1, W):
            out = out + s[:, w]
        return out

    if x2.shape[0] == 0:
        return x2.sum(0)
    S, per = colsum_split(x2.shape[0], N, x.element_size())
    return chunk_sums(chunk_sums(x2, S, per), 1, -(-S // W) * W)[0]


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, H*D] -> [B, H, T, D]."""
    B, T, C = t.shape
    return t.view(B, T, heads, C // heads).transpose(1, 2)


def _softmax_p(qkv, bias, heads, scale):
    """(q, k, v, p) in the accumulation dtype; p is the exact fp32 softmax."""
    B, T, C3 = qkv.shape
    q, k, v = acc(qkv).view(B, T, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    return q, k, v, torch.softmax(s, dim=-1)


def attention_plain(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int,
                    scale: float, stats: bool = False, fp32_out: bool = False):
    """Returns [B, T, C], or ``(out, None)`` with ``stats``: the kernel's row
    statistics exist only for its backward, which the plain backward does
    not read. With ``fp32_out`` the context stays in the accumulation dtype,
    unrounded."""
    B, T, C3 = qkv.shape
    _, _, v, p = _softmax_p(qkv, bias, heads, scale)
    o = torch.matmul(acc(p.to(qkv.dtype)), v)  # [B, H, T, D]
    o = (o if fp32_out else o.to(qkv.dtype)).transpose(1, 2).reshape(B, T, C3 // 3)
    return (o, None) if stats else o


def attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, bias: Optional[torch.Tensor],
                        heads: int, scale: float, stats=None):
    """Backward of :func:`attention_plain` for the output grad ``do``
    [B, T, C]: ``(dqkv, dqkv rounded to qkv.dtype)``, dqkv [B, T, 3C] in
    the accumulation dtype. The softmax is recomputed; ``stats`` is ignored.
    ``delta`` sums the fp32 p times dp (not FA2's rowsum(do * o)), ds and p
    are rounded before their products, as in the Pallas kernel."""
    B, T, C3 = qkv.shape
    q, k, v, p = _softmax_p(qkv, bias, heads, scale)
    dt = qkv.dtype
    do_h = acc(_heads(do, heads))
    dp = torch.matmul(do_h, v.transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    ds = acc((p * (dp - delta) * scale).to(dt))
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dv = torch.matmul(acc(p.to(dt)).transpose(-1, -2), do_h)
    dqkv = torch.stack((dq, dk, dv), dim=2)  # [B, H, 3, T, D]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(B, T, C3)
    return dqkv, dqkv.to(dt)


def _flash_scores(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor], scale: float):
    """Scores [B, H, Tq, Tk] of q [B, Tq, H, D] and k [B, Tk, H, D] in the
    accumulation dtype: (q . k^T) * scale, then + bias."""
    s = torch.matmul(acc(q).transpose(1, 2), acc(k).permute(0, 2, 3, 1)) * scale
    return s if bias is None else s + bias


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor], scale: float):
    """``(o [B, Tq, H, D] in q's dtype, lse [B, H, Tq])``: exact softmax over
    all keys, ``p / l`` rounded to v's dtype before ``p . v``, one rounding
    of o, ``lse = m + log l`` in the accumulation dtype."""
    s = _flash_scores(q, k, bias, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(acc((p / l).to(v.dtype)), acc(v).transpose(1, 2))  # [B, H, Tq, D]
    return o.to(q.dtype).transpose(1, 2).contiguous(), (m + torch.log(l))[..., 0]


def _flash_ds_raw(q, k, v, bias, lse, delta, do, scale):
    """(p, ds_raw) [B, H, Tq, Tk]: p = exp(s - lse), ds_raw = p * (dp - delta)."""
    p = torch.exp(_flash_scores(q, k, bias, scale) - lse[..., None])
    dp = torch.matmul(acc(do).transpose(1, 2), acc(v).permute(0, 2, 3, 1))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor, scale: float):
    """Backward of :func:`flash_attention_fwd_plain` for the output grad
    ``do`` [B, Tq, H, D]: ``(dq, dk, dv, delta)``. p is recomputed from
    ``lse``; ``delta = rowsum(do * o)`` [B, H, Tq] from the rounded ``o``;
    ``ds_raw * scale`` and p are rounded to q's dtype before their products."""
    dt = q.dtype
    do_h = acc(do).transpose(1, 2)  # [B, H, Tq, D]
    delta = (do_h * acc(o).transpose(1, 2)).sum(dim=-1)
    p, ds_raw = _flash_ds_raw(q, k, v, bias, lse, delta, do, scale)
    ds = acc((ds_raw * scale).to(dt))
    dq = torch.matmul(ds, acc(k).transpose(1, 2))
    dk = torch.matmul(ds.transpose(-1, -2), acc(q).transpose(1, 2))
    dv = torch.matmul(acc(p.to(dt)).transpose(-1, -2), do_h)
    back = lambda t: t.to(dt).transpose(1, 2).contiguous()
    return back(dq), back(dk), back(dv), delta


def flash_attention_dbias_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: Optional[torch.Tensor], lse: torch.Tensor,
                                delta: torch.Tensor, do: torch.Tensor, scale: float) -> torch.Tensor:
    """[Tq, Tk] sum over items and heads of the unscaled ``ds_raw``."""
    return _flash_ds_raw(q, k, v, bias, lse, delta, do, scale)[1].sum(dim=(0, 1))


def flash_attention_dbias_ordered(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: Optional[torch.Tensor], lse: torch.Tensor,
                                  delta: torch.Tensor, do: torch.Tensor, scale: float) -> torch.Tensor:
    """:func:`flash_attention_dbias_plain` with the fp32 additions in the
    order of the kernel, one by one: the (item, head) pairs ``b * H + h`` cut
    into the chunks of :func:`dbias_split`, each chunk's ``ds_raw`` added in
    turn from zero, then the chunks' partial sums added in order from zero.
    The kernel's result equals it bitwise wherever its ``ds_raw`` does,
    which is where the products are exact (small-integer inputs: the
    tensor cores sum a product in another order than ``torch.matmul``)."""
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    ds = _flash_ds_raw(q, k, v, bias, lse, delta, do, scale)[1].reshape(B * H, Tq, Tk)
    total = torch.zeros((Tq, Tk), dtype=ds.dtype, device=ds.device)
    if B * H == 0 or Tq == 0:  # an empty sum
        return total
    chunks, per = dbias_split(B * H, Tq, Tk)
    for c in range(chunks):
        part = torch.zeros_like(total)
        for bh in range(c * per, min(c * per + per, B * H)):
            part = part + ds[bh]
        total = total + part
    return total


def dot_variant_plain(a: torch.Tensor, b: torch.Tensor, orientation: str) -> torch.Tensor:
    ta, tb = ORIENTATIONS[orientation]
    return torch.matmul(acc(a.t() if ta else a), acc(b.t() if tb else b))


def patch_gather_plain(x: torch.Tensor, patch_hw: Tuple[int, int], stride_hw: Tuple[int, int],
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``F.unfold`` of x [B, Cin, H, W] rounded to ``dtype``: [B, Cin*ph*pw, L],
    contiguous (:func:`patch_gather`)."""
    return torch.nn.functional.unfold(x.to(dtype), kernel_size=patch_hw, stride=stride_hw)


def rowquant_plain(x: torch.Tensor):
    """Per-row symmetric int8 of x [..., K]: ``(codes int8 [..., K], scale
    fp32 [..., 1])``, ``scale = max|x| / 127 + 1e-12``, ``codes =
    clip(round_half_even(x / scale), -127, 127)``."""
    return quantize_rows(x)


def layernorm_rowquant_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """:func:`rowquant_plain` of LayerNorm(x) rounded to ``x.dtype``."""
    return quantize_rows(layernorm_plain(x, w, b))


def int_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact integer product xq [..., K] . wq [N, K]^T as fp32 (one
    rounding of the int32 sum, which passes 2^24 at K = 3072): int32 on the
    CPU, float64 on CUDA, which has no integer matmul."""
    if xq.is_cuda:
        return torch.matmul(xq.double(), wq.double().t()).float()
    return torch.matmul(xq.int(), wq.int().t()).float()


def gemm_i8_plain(xq: torch.Tensor, row_scale: torch.Tensor, wq: torch.Tensor,
                  col_scale: torch.Tensor, b: torch.Tensor, act: str = "none",
                  residual: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.bfloat16, col_first: bool = False):
    v = int_matmul_plain(xq, wq)
    rs, cs = row_scale.reshape(*xq.shape[:-1], 1), col_scale.reshape(-1)
    v = (v * cs) * rs if col_first else (v * rs) * cs
    y = act_plain(v + b.float(), act).to(out_dtype)
    return y if residual is None else residual + y


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _build.library()
    call = getattr(lib, f"vt_{name}")
    if device.index == torch.cuda.current_device():  # no device guard: it costs ~3 us a call
        err = call(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = call(*args, torch._C._cuda_getCurrentRawStream(device.index))
    _build.check(lib, err, name)
    LAUNCHES[name] += 1


def _param_vector(t: torch.Tensor, name: str, n: int, device: torch.device) -> None:
    _cuda_operand(t, name, torch.float32, device)
    _require(t.shape == (n,), f"{name} must be [{n}], got {tuple(t.shape)}")


def _ln_width(C: int) -> None:
    _require(0 < C <= LN_MAX_C and C % 8 == 0,
             f"C={C} must be a positive multiple of 8 and at most {LN_MAX_C} (a warp holds the row "
             f"in 16-byte vectors)")


def layernorm_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics, taken in float64
    as :func:`layernorm_plain` takes them (eps 1e-5); the affine result is
    rounded once to ``x.dtype``. w, b: [C] fp32. On CUDA
    C % 8 == 0, C <= 2048 and x, w, b 16-byte aligned."""
    if not x.is_cuda:
        return layernorm_plain(x, w, b)
    C = x.shape[-1]
    _ln_width(C)
    _cuda_operand(x, "x", torch.bfloat16, x.device)
    _param_vector(w, "w", C, x.device)
    _param_vector(b, "b", C, x.device)
    y = torch.empty_like(x)
    _launch("layernorm_fwd", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), x.numel() // C, C, LN_EPS)
    return y


@functools.lru_cache(maxsize=1024)
def layernorm_bwd_split(rows: int, C: int) -> Tuple[int, int]:
    """``(warps, rows_per_warp)``: how :func:`layernorm_bwd` walks its
    ``rows`` (>= 1) of width C. Warp g of the grid takes rows ``g * R`` to
    ``g * R + R - 1`` in order (R = rows_per_warp), ``LN_BWD_WARPS`` warps a
    block, each block writing one partial weight-grad row. The grid is
    persistent: at most as many blocks as the card holds at once, which
    ``layernorm.cu``'s ``BwdSchedule`` gives per width (4 an SM up to C =
    512, 3 up to 1024, then 2: the registers of a lane's rows and sums), so
    a training shape puts several warps on every SM. Every row falls in one
    warp and no warp is empty: ``(warps - 1) * R < rows <= warps * R``. A
    function of the shapes and the constants above only, so the same shapes
    always sum in the same order."""
    vecs = -(-C // 256)  # 16-byte vectors a lane holds
    per_sm = 4 if vecs <= 2 else 3 if vecs <= 4 else 2
    per = -(-rows // (SM_COUNT * per_sm * LN_BWD_WARPS))
    return -(-rows // per), per


def layernorm_bwd(x: torch.Tensor, w: torch.Tensor, dh: torch.Tensor,
                  residual: Optional[torch.Tensor] = None):
    """Backward of :func:`layernorm_fwd` (statistics recomputed from ``x``)
    for the fp32 output grad ``dh``: ``(dx, dw, db)``, dx rounded once to
    ``x.dtype`` after adding ``residual``; dw, db [C] fp32 column sums, in
    the fixed order of :func:`layernorm_bwd_ordered`: two runs give the same
    bits."""
    if not x.is_cuda:
        return layernorm_bwd_plain(x, w, dh, residual)
    C = x.shape[-1]
    _ln_width(C)
    rows = x.numel() // C
    _cuda_operand(x, "x", torch.bfloat16, x.device)
    _param_vector(w, "w", C, x.device)
    _cuda_operand(dh, "dh", torch.float32, x.device)
    _require(dh.shape == x.shape, f"dh must be {tuple(x.shape)}, got {tuple(dh.shape)}")
    if residual is not None:
        _cuda_operand(residual, "residual", torch.bfloat16, x.device)
        _require(residual.shape == x.shape, f"residual must be {tuple(x.shape)}")
    dx = torch.empty_like(x)
    if rows == 0:  # an empty sum, as the plain version gives it
        zeros = torch.zeros(C, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    warps, per = layernorm_bwd_split(rows, C)
    blocks = -(-warps // LN_BWD_WARPS)
    S, cs_rows = colsum_split(blocks, 2 * C, 4)
    buf = torch.empty((1 + blocks + S) * 2 * C, dtype=torch.float32, device=x.device)  # dw|db, partials
    p = buf.data_ptr()
    _launch("layernorm_bwd", x.device, x.data_ptr(), w.data_ptr(), dh.data_ptr(), _ptr(residual),
            dx.data_ptr(), p + 8 * C, p + 8 * C * (1 + blocks), p, rows, C, per, blocks, S, cs_rows,
            LN_EPS)
    return dx, buf[:C], buf[C:2 * C]


def gemm_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str = "none",
                  residual: Optional[torch.Tensor] = None, preact: bool = False):
    """``act(x . w^T + b)`` rounded to ``x.dtype``, plus ``residual`` (added
    after the rounding). x: [..., K]; w: [N, K] (torch Linear layout);
    b: [N] fp32; residual: [..., N] like x. With ``preact`` it returns
    ``(y, a)``, ``a = x . w^T + b`` kept in fp32."""
    _require(act in ACTS, f"unknown activation {act!r}")
    if not x.is_cuda:
        return gemm_bias_act_plain(x, w, b, act, residual, preact)
    K = x.shape[-1]
    N = w.shape[0]
    _cuda_operand(x, "x", torch.bfloat16, x.device)
    _cuda_operand(w, "w", torch.bfloat16, x.device)
    _require(w.dim() == 2 and w.shape[1] == K, f"w must be [N, {K}], got {tuple(w.shape)}")
    _param_vector(b, "b", N, x.device)
    _require(K > 0 and K % 8 == 0, f"K={K} must be a positive multiple of 8")
    out_shape = (*x.shape[:-1], N)
    if residual is not None:
        _cuda_operand(residual, "residual", torch.bfloat16, x.device)
        _require(tuple(residual.shape) == out_shape,
                 f"residual must be {out_shape}, got {tuple(residual.shape)}")
    M = x.numel() // K
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    a = torch.empty(out_shape, dtype=torch.float32, device=x.device) if preact else None
    # odd N: the raw fp32 product, then the epilogue in a second kernel
    partial = torch.empty((M, N), dtype=torch.float32, device=x.device) if N % 2 else None
    _launch("gemm_bias_act", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
            _ptr(residual), y.data_ptr(), _ptr(a), _ptr(partial), M, N, K, ACTS[act])
    return (y, a) if preact else y


def gemm_dgrad(dy: torch.Tensor, w: torch.Tensor, rounded: bool, act: str = "none",
               preact: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dy . w`` for dy [..., K] and w [K, N] read as stored (the data grad
    of ``y = x . w^T``). With ``act`` the product is multiplied by
    ``act'(preact)`` (preact: [..., N] fp32) before the rounding. Returns
    [..., N] rounded to ``dy.dtype`` if ``rounded``, else fp32."""
    _require(act in ACTS, f"unknown activation {act!r}")
    _require((act == "none") == (preact is None), "preact goes with an activation grad")
    if not dy.is_cuda:
        return gemm_dgrad_plain(dy, w, rounded, act, preact)
    K = dy.shape[-1]
    _cuda_operand(dy, "dy", torch.bfloat16, dy.device)
    _cuda_operand(w, "w", torch.bfloat16, dy.device)
    _require(w.dim() == 2 and w.shape[0] == K, f"w must be [{K}, N], got {tuple(w.shape)}")
    N = w.shape[1]
    _require(K % 8 == 0 and N % 8 == 0, f"K={K} and N={N} must be multiples of 8")
    out_shape = (*dy.shape[:-1], N)
    if preact is not None:
        _cuda_operand(preact, "preact", torch.float32, dy.device)
        _require(tuple(preact.shape) == out_shape, f"preact must be {out_shape}")
    y = torch.empty(out_shape, dtype=dy.dtype if rounded else torch.float32, device=dy.device)
    _launch("gemm_dgrad", dy.device, dy.data_ptr(), w.data_ptr(), _ptr(preact),
            None if rounded else y.data_ptr(), y.data_ptr() if rounded else None,
            dy.numel() // K, N, K, ACTS[act])
    return y


@functools.lru_cache(maxsize=1024)
def wgrad_split(M: int, N1: int, N2: int) -> Tuple[int, int]:
    """``(S, rows_per_chunk)``: how :func:`gemm_wgrad` cuts its M rows. The
    kernel launches one block per (128 x 128 output tile, row chunk); each
    sums its chunk into an fp32 partial tile and a second kernel adds the S
    partials in order. The output alone has too few tiles for the card (36
    for 768 x 768), so S is the split that fills it best: among the splits
    that put at least one block on every SM, the least ``rounds * (steps
    per chunk + a chunk's fixed cost)``, where ``rounds`` is the most blocks
    any SM gets; if M is too short for that many blocks, the finest split.
    Chunks are whole pipeline steps (64 rows), none is empty, and the last
    may be short: ``(S - 1) * rows_per_chunk < M <= S * rows_per_chunk``.
    A function of the shapes and the constants above only, so the same
    shapes always sum in the same order."""
    tiles = -(-N1 // WGRAD_TILE) * -(-N2 // WGRAD_TILE)
    steps = max(1, -(-M // WGRAD_STEP))
    best = None
    for per_chunk in range(steps, 0, -1):  # coarse to fine: ties go to the coarser split
        S = -(-steps // per_chunk)
        blocks = tiles * S
        cost = -(-blocks // SM_COUNT) * (per_chunk + WGRAD_CHUNK_COST)
        key = (blocks < SM_COUNT, cost if blocks >= SM_COUNT else -blocks)
        if best is None or key < best[0]:
            best = (key, S, per_chunk * WGRAD_STEP)
    return best[1], best[2]


def gemm_wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T . b`` over all rows: a [..., N1], b [..., N2] -> [N1, N2] fp32
    (the weight grad of ``y = x . w^T`` is ``gemm_wgrad(dy, x)``). The rows
    are summed in the chunks of :func:`wgrad_split`, the chunks in order:
    two runs give the same bits."""
    if not a.is_cuda:
        return gemm_wgrad_plain(a, b)
    N1, N2 = a.shape[-1], b.shape[-1]
    M = a.numel() // N1
    _cuda_operand(a, "a", torch.bfloat16, a.device)
    _cuda_operand(b, "b", torch.bfloat16, a.device)
    _require(b.numel() // N2 == M, f"a and b must have the same rows: {tuple(a.shape)}, {tuple(b.shape)}")
    _require(N1 % 8 == 0 and N2 % 8 == 0, f"N1={N1} and N2={N2} must be multiples of 8")
    if M == 0:  # an empty sum, as the plain version gives it
        return torch.zeros((N1, N2), dtype=torch.float32, device=a.device)
    S, rows_per_chunk = wgrad_split(M, N1, N2)
    y = torch.empty((N1, N2), dtype=torch.float32, device=a.device)
    partial = torch.empty((S, N1, N2), dtype=torch.float32, device=a.device) if S > 1 else None
    _launch("gemm_wgrad", a.device, a.data_ptr(), b.data_ptr(), y.data_ptr(), _ptr(partial),
            N1, N2, M, S, rows_per_chunk)
    return y


@functools.lru_cache(maxsize=1024)
def colsum_split(rows: int, N: int, itemsize: int) -> Tuple[int, int]:
    """``(S, rows_per_chunk)``: how :func:`colsum` cuts its ``rows`` (>= 1)
    of N elements of ``itemsize`` bytes. The kernel launches one block per
    (strip of 512 bytes of a row, row chunk), so the card gets strips * S
    blocks; S aims at two blocks an SM (the strips alone are 2 to 18 blocks
    at the paths' widths), with no chunk under ``COLSUM_MIN_ROWS`` rows.
    Chunks are multiples of ``COLSUM_WARPS`` rows, none is empty, and the
    last may be short: ``(S - 1) * rows_per_chunk < rows <= S *
    rows_per_chunk``. A function of the shapes and the constants above only,
    so the same shapes always sum in the same order."""
    strips = -(-N * itemsize // COLSUM_STRIP)
    S = max(1, min(-(-2 * SM_COUNT // strips), -(-rows // COLSUM_MIN_ROWS)))
    per = -(-rows // S)
    per = -(-per // COLSUM_WARPS) * COLSUM_WARPS
    return -(-rows // per), per


def colsum(x: torch.Tensor) -> torch.Tensor:
    """fp32 sums over all rows of x [..., N] (bf16 or fp32) -> [N]. On CUDA a
    row is a whole number of 16-byte vectors (N % 8 == 0 for bf16, N % 4 ==
    0 for fp32) and x is 16-byte aligned. The rows are summed in the chunks
    of :func:`colsum_split`, in the fixed order of :func:`colsum_ordered`:
    two runs give the same bits."""
    if not x.is_cuda:
        return colsum_plain(x)
    _require(x.dtype in (torch.bfloat16, torch.float32), f"x must be bf16 or fp32, got {x.dtype}")
    _cuda_operand(x, "x", x.dtype, x.device)
    N, per_vec = x.shape[-1], 16 // x.element_size()
    _require(N > 0 and N % per_vec == 0,
             f"N={N} must be a positive multiple of {per_vec} for {x.dtype} (16-byte row vectors)")
    rows = x.numel() // N
    if rows == 0:  # an empty sum, as the plain version gives it
        return torch.zeros(N, dtype=torch.float32, device=x.device)
    S, rows_per_chunk = colsum_split(rows, N, x.element_size())
    buf = torch.empty((S + 1) * N, dtype=torch.float32, device=x.device)  # the sums, then S partial rows
    _launch("colsum", x.device, x.data_ptr(), int(x.dtype == torch.float32), buf.data_ptr() + 4 * N,
            buf.data_ptr(), rows, N, S, rows_per_chunk)
    return buf[:N]


def _attention_operands(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int):
    _require(qkv.dim() == 3 and qkv.shape[-1] % 3 == 0, f"qkv must be [B, T, 3C], got {tuple(qkv.shape)}")
    B, T, C3 = qkv.shape
    C = C3 // 3
    _require(C == heads * HEAD_DIM,
             f"the attention kernels take head dim {HEAD_DIM}; got C={C}, heads={heads}")
    _cuda_operand(qkv, "qkv", torch.bfloat16, qkv.device)
    if bias is not None:
        _cuda_operand(bias, "bias", torch.float32, qkv.device)
        _require(tuple(bias.shape) == (T, T), f"bias must be [{T}, {T}], got {tuple(bias.shape)}")
    return B, T, C


def attention_fwd(qkv: torch.Tensor, bias: Optional[torch.Tensor], heads: int,
                  scale: float, stats: bool = False, fp32_out: bool = False):
    """softmax(q.k^T * scale + bias) . v for all heads. qkv: [B, T, 3C] with
    q|k|v sections and head-major columns inside each; bias: optional
    [T, T] fp32 (finite: clamp with ``canon_bias``). Returns [B, T, C], or
    with ``stats`` ``(out, stats)``: the softmax's row max and row sum,
    [2, B, H, T] fp32, which :func:`attention_bwd` reads. With ``fp32_out``
    (forward only, no ``stats``) the context is returned in fp32, unrounded
    (kernel ``attention_fwd_f32``)."""
    _require(not (stats and fp32_out), "fp32_out is forward only: no stats")
    if not qkv.is_cuda:
        return attention_plain(qkv, bias, heads, scale, stats, fp32_out)
    B, T, C = _attention_operands(qkv, bias, heads)
    if fp32_out:
        out = torch.empty((B, T, C), dtype=torch.float32, device=qkv.device)
        _launch("attention_fwd_f32", qkv.device, qkv.data_ptr(), _ptr(bias), out.data_ptr(),
                B, T, heads, scale)
        return out
    out = torch.empty((B, T, C), dtype=qkv.dtype, device=qkv.device)
    st = torch.empty((2, B, heads, T), dtype=torch.float32, device=qkv.device) if stats else None
    _launch("attention_fwd", qkv.device, qkv.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(st),
            B, T, heads, scale)
    return (out, st) if stats else out


def attention_bwd(qkv: torch.Tensor, do: torch.Tensor, bias: Optional[torch.Tensor], heads: int,
                  scale: float, stats: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`attention_fwd` for the output grad ``do`` [B, T, C]
    bf16, from the forward's ``stats``: ``(dqkv, dqkv rounded to bf16)``,
    dqkv [B, T, 3C] fp32."""
    if not qkv.is_cuda:
        return attention_bwd_plain(qkv, do, bias, heads, scale, stats)
    B, T, C = _attention_operands(qkv, bias, heads)
    _cuda_operand(do, "do", torch.bfloat16, qkv.device)
    _require(tuple(do.shape) == (B, T, C), f"do must be {(B, T, C)}, got {tuple(do.shape)}")
    _require(stats is not None, "attention_bwd needs the forward's row statistics")
    _cuda_operand(stats, "stats", torch.float32, qkv.device)
    _require(tuple(stats.shape) == (2, B, heads, T), f"stats must be {(2, B, heads, T)}")
    scratch = torch.empty((2, B, heads, T), dtype=torch.float32, device=qkv.device)  # delta, 1 / l
    dqkv = torch.empty(qkv.shape, dtype=torch.float32, device=qkv.device)
    dqkv_b = torch.empty_like(qkv)
    _launch("attention_bwd", qkv.device, qkv.data_ptr(), do.data_ptr(), _ptr(bias),
            stats.data_ptr(), scratch.data_ptr(), dqkv.data_ptr(), dqkv_b.data_ptr(),
            B, T, heads, scale)
    return dqkv, dqkv_b


def _codes_and_scale(x: torch.Tensor):
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    return q, scale


class RowquantPlan(NamedTuple):
    warps: int  # warps that hold a row
    vecs: int  # loads a lane holds (0: the row is read twice from memory)
    blocks: int  # blocks of ROWQUANT_BLOCK_WARPS warps, the persistent grid
    per_load: int  # values a load: 16 // itemsize (16-byte vectors) or 1 (scalar loads)


def rowquant_blocks_per_sm(vecs: int) -> int:
    """Blocks of :func:`rowquant` an SM holds at once, by the loads a lane
    holds: ``quant.cu``'s ``RowSchedule::kBlocksPerSM`` (the register budget
    its ``__launch_bounds__`` asks of the compiler)."""
    return 8 if vecs <= 2 else 6 if vecs <= 4 else 4


@functools.lru_cache(maxsize=1024)
def rowquant_plan(rows: int, K: int, itemsize: int) -> RowquantPlan:
    """How :func:`rowquant` launches on ``rows`` rows of K values of
    ``itemsize`` bytes. A row whose bytes are a whole number of 16-byte
    vectors is read as vectors (``per_load = 16 // itemsize``), any other
    with scalar loads. ``(warps, vecs)`` is the first of
    ``ROWQUANT_SHAPES`` (``quant.cu``'s ``kShapes``) whose ``32 * warps *
    vecs`` loads hold the row, or else ``(4, 0)``: the row is read twice.
    The grid is persistent: a block holds ``ROWQUANT_BLOCK_WARPS // warps``
    rows at a time, and there are as many blocks as the rows need or as the
    card holds at once (:func:`rowquant_blocks_per_sm` on ``SM_COUNT``
    SMs), whichever is fewer."""
    per_load = 16 // itemsize if K * itemsize % 16 == 0 else 1
    loads = -(-K // per_load)
    warps, vecs = next(((w, v) for w, v in ROWQUANT_SHAPES if 32 * w * v >= loads), (4, 0))
    need = -(-rows // (ROWQUANT_BLOCK_WARPS // warps))
    return RowquantPlan(warps, vecs, min(need, SM_COUNT * rowquant_blocks_per_sm(vecs)), per_load)


def rowquant(x: torch.Tensor):
    """Per-row symmetric int8 of x [..., K] (bf16 or fp32): ``(codes int8
    [..., K], scale fp32 [..., 1])``; see :func:`rowquant_plain`. On CUDA x
    is 16-byte aligned; the kernel's instance and grid are
    :func:`rowquant_plan`'s."""
    if not x.is_cuda:
        return rowquant_plain(x)
    _require(x.dtype in (torch.bfloat16, torch.float32), f"x must be bf16 or fp32, got {x.dtype}")
    _cuda_operand(x, "x", x.dtype, x.device)
    K = x.shape[-1]
    q, scale = _codes_and_scale(x)
    rows = x.numel() // K if K else 0
    plan = rowquant_plan(rows, K, x.element_size())
    _launch("rowquant", x.device, x.data_ptr(), int(x.dtype == torch.float32), q.data_ptr(),
            scale.data_ptr(), rows, K, plan.per_load, plan.warps, plan.vecs, plan.blocks)
    return q, scale


def layernorm_rowquant(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """:func:`rowquant` of ``layernorm_fwd(x, w, b)`` in one kernel, bitwise:
    the normalised row is rounded to bf16 and quantized without leaving the
    registers of its warp. w, b: [C] fp32; on CUDA layernorm_fwd's contract
    (C % 8 == 0, C <= 2048, 16-byte aligned)."""
    if not x.is_cuda:
        return layernorm_rowquant_plain(x, w, b)
    C = x.shape[-1]
    _ln_width(C)
    _cuda_operand(x, "x", torch.bfloat16, x.device)
    _param_vector(w, "w", C, x.device)
    _param_vector(b, "b", C, x.device)
    q, scale = _codes_and_scale(x)
    _launch("layernorm_rowquant", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
            q.data_ptr(), scale.data_ptr(), x.numel() // C, C, LN_EPS)
    return q, scale


def gemm_i8(xq: torch.Tensor, row_scale: torch.Tensor, wq: torch.Tensor, col_scale: torch.Tensor,
            b: torch.Tensor, act: str = "none", residual: Optional[torch.Tensor] = None,
            out_dtype: torch.dtype = torch.bfloat16, col_first: bool = False) -> torch.Tensor:
    """``act(float(xq . wq^T) * row_scale * col_scale + b)`` as ``out_dtype``
    (fp32, or bf16 with one rounding), plus ``residual`` (added after the
    rounding). xq: [..., K] int8 with ``row_scale`` one fp32 per row; wq:
    [N, K] int8 with ``col_scale`` one fp32 per output column; b: [N] fp32.
    The integer sum is exact; ``col_first`` multiplies by the column scale
    before the row scale (each product is one fp32 rounding)."""
    _require(act in ACTS, f"unknown activation {act!r}")
    if not xq.is_cuda:
        return gemm_i8_plain(xq, row_scale, wq, col_scale, b, act, residual, out_dtype, col_first)
    K, N = xq.shape[-1], wq.shape[0]
    M = xq.numel() // K
    _cuda_operand(xq, "xq", torch.int8, xq.device)
    _cuda_operand(wq, "wq", torch.int8, xq.device)
    _require(wq.dim() == 2 and wq.shape[1] == K, f"wq must be [N, {K}], got {tuple(wq.shape)}")
    _cuda_operand(row_scale, "row_scale", torch.float32, xq.device)
    _require(row_scale.numel() == M, f"row_scale must hold {M} values, got {tuple(row_scale.shape)}")
    _cuda_operand(col_scale, "col_scale", torch.float32, xq.device)
    _require(col_scale.numel() == N, f"col_scale must hold {N} values, got {tuple(col_scale.shape)}")
    _param_vector(b, "b", N, xq.device)
    _require(K % 16 == 0 and N % 8 == 0, f"K={K} must be a multiple of 16 and N={N} of 8")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"out_dtype {out_dtype} is not taken")
    out_shape = (*xq.shape[:-1], N)
    if residual is not None:
        _require(out_dtype == torch.bfloat16, "the residual is added to a bf16 result")
        _cuda_operand(residual, "residual", torch.bfloat16, xq.device)
        _require(tuple(residual.shape) == out_shape,
                 f"residual must be {out_shape}, got {tuple(residual.shape)}")
    y = torch.empty(out_shape, dtype=out_dtype, device=xq.device)
    f32 = out_dtype == torch.float32
    _launch("gemm_i8", xq.device, xq.data_ptr(), row_scale.data_ptr(), wq.data_ptr(),
            col_scale.data_ptr(), b.data_ptr(), _ptr(residual), y.data_ptr() if f32 else None,
            None if f32 else y.data_ptr(), M, N, K, ACTS[act], int(col_first))
    return y


def _flash_views(device: torch.device, **views: torch.Tensor):
    """Checks q, k, v as [B, T, H, 64] bf16 views the kernels can read (last
    dim contiguous, other strides and the address multiples of 8 elements)
    and returns their 9 element strides as a C array."""
    strides = []
    for name, t in views.items():
        _require(t.device == device, f"{name} is on {t.device}, expected {device}")
        _require(t.dtype == torch.bfloat16, f"{name} must be bfloat16 on CUDA, got {t.dtype}")
        _require(t.dim() == 4 and t.shape[-1] == HEAD_DIM,
                 f"the attention kernels take [B, T, H, {HEAD_DIM}]; {name} is {tuple(t.shape)}")
        _require(t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
                 and t.data_ptr() % 16 == 0,
                 f"{name}: the last dim must be contiguous and every other stride and the "
                 f"address a multiple of 8 elements; strides {t.stride()}")
        strides += list(t.stride()[:3])
    return (ctypes.c_longlong * len(strides))(*strides)


def _flash_operands(q, k, v, bias):
    strides = _flash_views(q.device, q=q, k=k, v=v)
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    _require(Tk > 0, "attention over no keys")
    _require(tuple(k.shape) == (B, Tk, H, HEAD_DIM) and v.shape == k.shape,
             f"k and v must be {(B, Tk, H, HEAD_DIM)}, got {tuple(k.shape)}, {tuple(v.shape)}")
    if bias is not None:
        _cuda_operand(bias, "bias", torch.float32, q.device)
        _require(tuple(bias.shape) == (Tq, Tk), f"bias must be [{Tq}, {Tk}], got {tuple(bias.shape)}")
    return strides, B, Tq, Tk, H


def _flash_dense(t: Optional[torch.Tensor], name: str, shape, dtype, device) -> None:
    _require(t is not None, f"{name} is missing")
    _cuda_operand(t, name, dtype, device)
    _require(tuple(t.shape) == tuple(shape), f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


@functools.lru_cache(maxsize=1024)
def flash_fwd_plan(Tq: int, Tk: int) -> Tuple[int, int]:
    """``(tiles, rows_per_block)``: how :func:`flash_attention_fwd` cuts Tq
    (>= 1) query rows of a head into blocks of whole 16-row warps against Tk
    keys: as few blocks as hold at most ``FLASH_MAX_Q`` rows each, or
    ``FLASH_ONE_TILE_Q`` where every key fits one 64-key tile (the kernel
    then keeps the scores in registers and runs 4 blocks an SM), sized alike
    (one block of 80 rows at the decoder's Tq = 77, Tk = 61; eight of 128 at
    T = 971). Every row falls in one block: ``(tiles - 1) * rows_per_block <
    Tq <= tiles * rows_per_block``."""
    tiles = -(-Tq // (FLASH_ONE_TILE_Q if Tk <= 64 else FLASH_MAX_Q))
    per = -(-Tq // tiles)
    return tiles, -(-per // 16) * 16


class FlashBwdPlan(NamedTuple):
    """The blocks of :func:`flash_attention_bwd`'s two kernels per (item,
    head): ``q_tiles`` blocks of ``q_rows`` query rows (dq) and ``k_tiles``
    blocks of ``k_rows`` keys (dk, dv)."""

    q_tiles: int
    q_rows: int
    k_tiles: int
    k_rows: int


@functools.lru_cache(maxsize=1024)
def flash_bwd_plan(Tq: int, Tk: int) -> FlashBwdPlan:
    """How :func:`flash_attention_bwd` cuts a head of Tq (>= 1) query rows
    and Tk (>= 1) keys into blocks of whole 16-row warps. Its dq kernel takes
    the query rows as :func:`flash_fwd_plan` does (one block of 5 warps per
    head at the decoder's Tq = 77, Tk = 61; eight of 128 rows at T = 971);
    its dk, dv kernel takes the keys in as few blocks of at most
    ``FLASH_BWD_MAX_K`` as hold them, sized alike (one of 64 at Tk = 61, two
    of 48 at 77, sixteen of 64 at 971). Every query row and every key falls
    in one block: ``(tiles - 1) * rows < T <= tiles * rows``."""
    q_tiles, q_rows = flash_fwd_plan(Tq, Tk)
    k_tiles = -(-Tk // FLASH_BWD_MAX_K)
    per = -(-Tk // k_tiles)
    return FlashBwdPlan(q_tiles, q_rows, k_tiles, -(-per // 16) * 16)


@functools.lru_cache(maxsize=1024)
def dbias_split(BH: int, Tq: int, Tk: int) -> Tuple[int, int]:
    """``(chunks, per_chunk)``: how :func:`flash_attention_dbias` cuts its
    ``BH`` (>= 1) (item, head) pairs. Its kernel launches one block per
    (``FLASH_TILE`` query rows, ``FLASH_TILE`` keys, chunk), so the chunks
    aim at ``DBIAS_BLOCKS_PER_SM`` blocks an SM (256 blocks at B16 T200 H12
    and at B64 T77 H8). Chunk c takes the pairs ``c * per_chunk`` to ``c *
    per_chunk + per_chunk - 1`` in order, none is empty: ``(chunks - 1) *
    per_chunk < BH <= chunks * per_chunk``. A function of the shapes and the
    constants above only, so the same shapes always sum in the same order."""
    tiles = -(-Tq // FLASH_TILE) * -(-Tk // FLASH_TILE)
    want = max(1, min(BH, -(-DBIAS_BLOCKS_PER_SM * SM_COUNT // tiles)))
    per = -(-BH // want)
    return -(-BH // per), per


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], scale: float):
    """softmax(q . k^T * scale + bias) . v per head. q: [B, Tq, H, 64]; k, v:
    [B, Tk, H, 64]; any strides with a contiguous last dim (sections of a
    packed projection, transposed views); bias: optional [Tq, Tk] fp32,
    finite. Returns ``(o [B, Tq, H, 64], lse [B, H, Tq] fp32)``, contiguous.
    The kernel launches ``flash_fwd_plan(Tq, Tk)`` blocks per (item, head)."""
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, bias, scale)
    strides, B, Tq, Tk, H = _flash_operands(q, k, v, bias)
    o = torch.empty((B, Tq, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    rows = flash_fwd_plan(Tq, Tk)[1] if Tq > 0 else 16
    _launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            _ptr(bias), o.data_ptr(), lse.data_ptr(), B, Tq, Tk, H, scale, rows)
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, scale: float):
    """Backward of :func:`flash_attention_fwd` from its ``o`` and ``lse`` for
    the output grad ``do`` (both contiguous [B, Tq, H, 64]): ``(dq, dk, dv,
    delta)``, the grads contiguous bf16 in the shapes of q, k, v, and
    ``delta = rowsum(do * o)`` [B, H, Tq] fp32, which
    :func:`flash_attention_dbias` reads. The kernels launch the blocks of
    ``flash_bwd_plan(Tq, Tk)`` per (item, head); the grads are the same bits
    in every run."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, bias, o, lse, do, scale)
    strides, B, Tq, Tk, H = _flash_operands(q, k, v, bias)
    _flash_dense(o, "o", (B, Tq, H, HEAD_DIM), torch.bfloat16, q.device)
    _flash_dense(do, "do", (B, Tq, H, HEAD_DIM), torch.bfloat16, q.device)
    _flash_dense(lse, "lse", (B, H, Tq), torch.float32, q.device)
    delta = torch.empty_like(lse)
    dq = torch.empty((B, Tq, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    plan = flash_bwd_plan(max(Tq, 1), Tk)
    _launch("flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            _ptr(bias), o.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, scale, plan.q_rows, plan.k_rows)
    return dq, dk, dv, delta


def flash_attention_dbias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor], lse: torch.Tensor, delta: torch.Tensor,
                          do: torch.Tensor, scale: float) -> torch.Tensor:
    """The bias grad [Tq, Tk] fp32 of :func:`flash_attention_fwd`: the
    unscaled ``p * (dp - delta)`` summed over all items and heads in the
    chunks of :func:`dbias_split`, in the fixed order of
    :func:`flash_attention_dbias_ordered` (two runs agree bitwise), from the
    forward's ``lse`` and the backward's ``delta``."""
    if not q.is_cuda:
        return flash_attention_dbias_plain(q, k, v, bias, lse, delta, do, scale)
    strides, B, Tq, Tk, H = _flash_operands(q, k, v, bias)
    _flash_dense(do, "do", (B, Tq, H, HEAD_DIM), torch.bfloat16, q.device)
    _flash_dense(lse, "lse", (B, H, Tq), torch.float32, q.device)
    _flash_dense(delta, "delta", (B, H, Tq), torch.float32, q.device)
    if B * H == 0 or Tq == 0:  # an empty sum, as the plain version gives it
        return torch.zeros((Tq, Tk), dtype=torch.float32, device=q.device)
    chunks, per = dbias_split(B * H, Tq, Tk)
    partial = torch.empty((chunks, Tq, Tk), dtype=torch.float32, device=q.device)
    dbias = torch.empty((Tq, Tk), dtype=torch.float32, device=q.device)
    _launch("flash_attention_dbias", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            _ptr(bias), lse.data_ptr(), delta.data_ptr(), do.data_ptr(), partial.data_ptr(),
            dbias.data_ptr(), B, Tq, Tk, H, scale, chunks, per)
    return dbias


class DotPlan(NamedTuple):
    """The launch of :func:`dot_variant`: output tiles of 64 x ``bn``, one
    block each, ``blocks`` of them, and ``stages`` stages of ``DOT_STEP`` k
    in shared memory at once."""

    bn: int
    stages: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def dot_plan(M: int, N: int, K: int) -> DotPlan:
    """How :func:`dot_variant` cuts the product [M, K] . [K, N] (M, N >= 1):
    one block per 64 x 64 output tile (24 at the probe's 256 x 384), every
    stage of ``DOT_STEP`` k in shared memory at once where K <= 512, else a
    ring of ``DOT_MAX_STAGES``; no stage at K = 0 (the kernel stores zeros).
    ``csrc/dot_variants.cu`` launches the same (``vt_dot_plan``)."""
    blocks = -(-M // DOT_TILE) * -(-N // DOT_TILE)
    return DotPlan(DOT_TILE, min(-(-K // DOT_STEP), DOT_MAX_STAGES), blocks)


def dot_variant(a: torch.Tensor, b: torch.Tensor, orientation: str) -> torch.Tensor:
    """The product a . b -> [M, N] fp32 with the operands stored as
    ``orientation`` says: ``NN`` a [M, K], b [K, N]; ``NT`` b [N, K]; ``TN``
    a [K, M]; ``TT`` both. M, N, K multiples of 16 on CUDA."""
    _require(orientation in ORIENTATIONS, f"unknown orientation {orientation!r}")
    if not a.is_cuda:
        return dot_variant_plain(a, b, orientation)
    ta, tb = ORIENTATIONS[orientation]
    _cuda_operand(a, "a", torch.bfloat16, a.device)
    _cuda_operand(b, "b", torch.bfloat16, a.device)
    _require(a.dim() == 2 and b.dim() == 2, "a and b must be matrices")
    (K, M), (N, Kb) = (a.shape if ta else a.shape[::-1]), (b.shape if tb else b.shape[::-1])
    _require(K == Kb, f"{orientation}: a {tuple(a.shape)} and b {tuple(b.shape)} do not contract")
    _require(M % 16 == 0 and N % 16 == 0 and K % 16 == 0 and a.data_ptr() % 32 == 0
             and b.data_ptr() % 32 == 0,
             f"M={M}, N={N}, K={K} must be multiples of 16 and the operands 32-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _launch("dot_variant", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, ta, tb)
    return out


def patch_gather(x: torch.Tensor, patch_hw: Tuple[int, int], stride_hw: Tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The patches of x [B, Cin, H, W] in ``F.unfold``'s layout [B, Cin*ph*pw,
    L], contiguous, in ``dtype``: column l is the patch at grid cell (l //
    ncol, l % ncol), flattened in (c, h, w) order (an OIHW weight's reshaped
    to [D, K]), rounded to nearest even as ``Tensor.to`` rounds: bitwise
    :func:`patch_gather_plain`. On CUDA one launch for the batch, x read
    through its strides (the device frontend's fbanks are a view cropped in
    time); x fp32 or bf16 and not requiring grad (every path feeds it data,
    so the kernel has no backward), W <= 4096, ``dtype`` bf16 or fp32."""
    _require(x.dim() == 4, f"x must be [B, Cin, H, W], got {tuple(x.shape)}")
    (ph, pw), (sh, sw) = patch_hw, stride_hw
    B, Cin, H, W = x.shape
    _require(0 < ph <= H and 0 < pw <= W, f"patch {ph}x{pw} does not fit the input's {H}x{W}")
    _require(sh > 0 and sw > 0, f"stride {sh}x{sw} must be positive")
    if not x.is_cuda:
        return patch_gather_plain(x, patch_hw, stride_hw, dtype)
    _require(x.dtype in (torch.float32, torch.bfloat16), f"x must be fp32 or bf16 on CUDA, got {x.dtype}")
    _require(dtype in (torch.float32, torch.bfloat16), f"dtype must be fp32 or bf16 on CUDA, got {dtype}")
    _require(not x.requires_grad, "x must not require grad: the patch gather has no backward")
    _require(W <= 4096, f"W={W} must be at most 4096 (a block stages whole input rows)")
    out = torch.empty((B, Cin * ph * pw, ((H - ph) // sh + 1) * ((W - pw) // sw + 1)), dtype=dtype,
                      device=x.device)
    if out.numel():
        _launch("patch_gather", x.device, x.data_ptr(), int(x.dtype == torch.float32), *x.stride(),
                out.data_ptr(), int(dtype == torch.float32), B, Cin, H, W, ph, pw, sh, sw)
    return out


class Ops(NamedTuple):
    """The operations the sub-blocks are built from: the kernels' wrappers
    (:data:`KERNEL_OPS`) or their plain versions (:data:`PLAIN_OPS`)."""

    layernorm_fwd: object
    layernorm_bwd: object
    gemm_bias_act: object
    gemm_dgrad: object
    gemm_wgrad: object
    colsum: object
    attention_fwd: object
    attention_bwd: object
    rowquant: object
    layernorm_rowquant: object
    gemm_i8: object
    flash_attention_fwd: object
    flash_attention_bwd: object
    flash_attention_dbias: object


KERNEL_OPS = Ops(layernorm_fwd, layernorm_bwd, gemm_bias_act, gemm_dgrad, gemm_wgrad, colsum,
                 attention_fwd, attention_bwd, rowquant, layernorm_rowquant, gemm_i8,
                 flash_attention_fwd, flash_attention_bwd, flash_attention_dbias)
PLAIN_OPS = Ops(layernorm_plain, layernorm_bwd_plain, gemm_bias_act_plain, gemm_dgrad_plain,
                gemm_wgrad_plain, colsum_plain, attention_plain, attention_bwd_plain,
                rowquant_plain, layernorm_rowquant_plain, gemm_i8_plain,
                flash_attention_fwd_plain, flash_attention_bwd_plain, flash_attention_dbias_plain)
