"""The hand-written CUDA kernels (vipant_tpu_torch/csrc) against their plain
PyTorch versions on the card, at the serving and training paths' shapes.
Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest

Tolerances: atol = rtol = 2e-2 on bf16 outputs, one bf16 ulp of the output
plus a different fp32 summation order; max |d| <= 1e-2 * max |plain| on
fp32 grads (weight, bias and LayerNorm grads, the fp32 dqkv), which sum
over thousands of rows in another order. Int8 codes: rowquant's codes and
scales are bitwise its plain version's and the same in every run, and
layernorm_rowquant's bitwise rowquant(layernorm_fwd(x)); against the plain
LayerNorm, and in the sub-blocks, equal except a share of at most 1e-3 off
by exactly one (chip_smoke.py), scales to 1e-6 relative; the int32 sum
of gemm_i8 is exact (compared bitwise at unit scales). The flash-attention
kernels give the same bits for every layout of q, k, v, their grads and
bias grad the same bits in every run, and the bias grad on small-integer
inputs (exact products) the bits of kernels.flash_attention_dbias_ordered
(the plain sum in the kernel's order); so do gemm_bias_act, gemm_dgrad, gemm_wgrad,
gemm_i8, attention_bwd, whose recomputed p is bitwise the forward's, and
colsum, whose sum is also bitwise kernels.colsum_ordered (the plain sum in
the kernel's order). dot_variant gives the same bits in every run and for
every storage of one logical product (NN, NT, TN, TT), max |d| <= 1e-3
from its fp32 plain version at every chip_smoke.DOT_CASES case. patch_gather
is bitwise its plain version (F.unfold of the input rounded to the output's
dtype) and the same in every run."""

import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
from vipant_tpu_torch.ops import LAUNCHES, fused_attn, fused_mlp, kernels, reset_launches
from vipant_tpu_torch.serve import InferenceEngine

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import DOT_CASES, LAYERNORM_BWD_CASES  # noqa: E402  (the repo root's smoke script)

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)
REL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


def _close(got, want, what=""):
    """bf16: atol = rtol = 2e-2; fp32: max |d| <= 1e-2 * max |want|."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.isfinite(got).all(), what
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=what)
    else:
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= REL * scale, f"{what}: max|d| {err:.3e} > {REL} * {scale:.3e}"


def _bias(kind, T, k=4):
    if kind == "none":
        return None
    causal = causal_mask(T, device="cuda")
    if kind == "causal":
        return causal
    pack = pack_tokens(torch.zeros(k, T // k, 1, device="cuda"), k)[1]
    return pack if kind == "pack" else causal + pack


@pytest.mark.parametrize("B,T,C,H,kind", [
    (4, 306, 768, 12, "none"),          # audio tower
    (1, 308, 512, 8, "causal_pack"),    # text tower, 4 captions packed
    (1, 200, 768, 12, "pack"),          # image tower, 4 images packed
    (3, 37, 128, 2, "causal"),          # short ragged tail
])
def test_attention_block_kernels_match_plain(gen, B, T, C, H, kind):
    args = (_rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1),
            _rn(gen, 3 * C, C, std=C ** -0.5).bfloat16(), _rn(gen, 3 * C, std=0.02),
            _rn(gen, C, C, std=C ** -0.5).bfloat16(), _rn(gen, C, std=0.02))
    bias = _bias(kind, T)
    reset_launches()
    got = fused_attn.fused_ln_attention_block(*args, bias=bias, heads=H)
    assert LAUNCHES == {"layernorm_fwd": 1, "gemm_bias_act": 2, "attention_fwd": 1,
                        "fused_ln_attention_block": 1}
    want = fused_attn.fused_ln_attention_block_plain(*args, bias=bias, heads=H)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    bare = fused_attn.fused_attention_block(args[0], *args[3:], bias=bias, heads=H)
    want = fused_attn.fused_attention_block_plain(args[0], *args[3:], bias=bias, heads=H)
    torch.testing.assert_close(bare.float(), want.float(), **TOL)


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (1, 308, 512), (2, 37, 64)])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_block_kernels_match_plain(gen, B, T, C, act):
    E = 4 * C
    args = (_rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1),
            _rn(gen, E, C, std=C ** -0.5).bfloat16(), _rn(gen, E, std=0.02),
            _rn(gen, C, E, std=E ** -0.5).bfloat16(), _rn(gen, C, std=0.02))
    got = fused_mlp.fused_ln_mlp_block(*args, act=act)
    want = fused_mlp.fused_ln_mlp_block_plain(*args, act=act)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = _rn(gen, 2, 10, 128)
    w, b = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.layernorm_fwd(x, w, b)  # fp32 activations
    with pytest.raises(ValueError, match="head dim"):
        kernels.attention_fwd(_rn(gen, 2, 10, 96).bfloat16(), None, 1, 1.0)  # D = 32
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gemm_bias_act(x.bfloat16().transpose(0, 1), torch.ones(8, 128, device="cuda").bfloat16(),
                              torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.gemm_bias_act(_rn(gen, 4, 12).bfloat16(), torch.ones(8, 12, device="cuda").bfloat16(),
                              torch.zeros(8, device="cuda"))
    # the LayerNorm kernels hold a row as 16-byte vectors in one warp: C % 8 == 0, C <= 2048
    for C in (12, 4096):
        x, w, b = _rn(gen, 3, C).bfloat16(), torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
        for call in (lambda: kernels.layernorm_fwd(x, w, b), lambda: kernels.layernorm_rowquant(x, w, b),
                     lambda: kernels.layernorm_bwd(x, w, _rn(gen, 3, C))):
            with pytest.raises(ValueError, match="multiple of 8 and at most 2048"):
                call()
    # colsum reads rows of whole 16-byte vectors
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.colsum(_rn(gen, 5, 12).bfloat16())
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.colsum(_rn(gen, 5, 6))


def test_engine_runs_every_sub_block_through_the_kernels(gen):
    cfg = [
        "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
        "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
        "+running/audio=default", "worker=CLAP", "model.audio.encoder.layers=2",
        "model.text.encoder.layers=2", "running.audio.max_len=200", "model_file=",
    ]
    eng = InferenceEngine(cfg, batch_size=4, device="cuda")
    fb = np.random.default_rng(3).standard_normal((6, 200, 128)).astype(np.float32)
    texts = ["a dog barking", "rain", "a car", "wind", "birds"]
    reset_launches()
    got_a, got_t = eng.embed_audio(fb), eng.embed_texts(texts)
    assert LAUNCHES["fused_ln_attention_block"] == LAUNCHES["fused_ln_mlp_block"] == 2 * 2 + 2 * 2
    with mock.patch.object(fused_attn, "fused_ln_attention_block",
                           fused_attn.fused_ln_attention_block_plain), \
         mock.patch.object(fused_mlp, "fused_ln_mlp_block", fused_mlp.fused_ln_mlp_block_plain):
        want_a, want_t = eng.embed_audio(fb), eng.embed_texts(texts)
    for got, want in ((got_a, want_a), (got_t, want_t)):
        assert np.isfinite(got).all()
        cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
        assert cos.min() >= 0.999


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (1, 308, 512), (64, 77, 512), (3, 37, 64),
                                   (50, 306, 768), (50, 77, 512), (250, 77, 512)])  # the AT step and eval
def test_layernorm_fwd_kernel_matches_plain(gen, B, T, C):
    x, w, b = _rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1)
    reset_launches()
    got = kernels.layernorm_fwd(x, w, b)
    assert LAUNCHES == {"layernorm_fwd": 1}
    _close(got, kernels.layernorm_plain(x, w, b), "y")
    assert torch.equal(got, kernels.layernorm_fwd(x, w, b))
    assert torch.equal(got, kernels.layernorm_plain(x, w, b))  # float64 statistics on both sides


@pytest.mark.parametrize("rows,N,dtype", [
    (19584, 768, torch.bfloat16), (19584, 2304, torch.float32), (19584, 3072, torch.bfloat16),  # audio, B = 64
    (4928, 512, torch.bfloat16), (4928, 1536, torch.float32), (4928, 2048, torch.bfloat16),     # caption decoder
    (1224, 768, torch.bfloat16),                                                                 # audio, B = 4
    (15300, 768, torch.bfloat16), (15300, 2304, torch.float32), (15300, 3072, torch.bfloat16),  # AT, B = 50
    (0, 8, torch.bfloat16), (1, 8, torch.bfloat16), (111, 24, torch.float32),                    # ragged
    (111, 2304, torch.float32), (111, 3072, torch.bfloat16),
])
def test_colsum_kernel_matches_plain_and_repeats(gen, rows, N, dtype):
    x = _rn(gen, rows, N).to(dtype)
    got = kernels.colsum(x)
    _close(got, kernels.colsum_plain(x), "colsum")
    assert torch.equal(got, kernels.colsum(x))  # no atomics: the same bits in every run
    assert torch.equal(got, kernels.colsum_ordered(x))  # the fp32 additions in the planned order
    # small integers sum exactly in fp32 whatever the order: any misplaced element shows
    ix = torch.randint(-3, 4, (rows, N), generator=gen, device="cuda").to(dtype)
    assert torch.equal(kernels.colsum(ix), kernels.colsum_plain(ix))


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (1, 308, 512), (3, 37, 64),
                                   (2, 45, 1024), (1, 33, 2048), (5, 7, 8)])  # every schedule of layernorm.cu
def test_layernorm_bwd_kernel_matches_plain(gen, B, T, C):
    x, w = _rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1)
    dh, res = _rn(gen, B, T, C), _rn(gen, B, T, C).bfloat16()
    for r in (res, None):
        reset_launches()
        got = kernels.layernorm_bwd(x, w, dh, r)
        assert LAUNCHES == {"layernorm_bwd": 1}
        want = kernels.layernorm_bwd_plain(x, w, dh, r)
        for name, g, wt in zip(("dx", "dw", "db"), got, want):
            _close(g, wt, name)
        again = kernels.layernorm_bwd(x, w, dh, r)
        assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])  # no atomics
        assert torch.equal(got[2], kernels.layernorm_bwd_ordered(x, w, dh, r)[2])  # the planned order


@pytest.mark.parametrize("case,M,C", LAYERNORM_BWD_CASES, ids=[c[0] for c in LAYERNORM_BWD_CASES])
def test_layernorm_bwd_kernel_at_every_training_case(gen, case, M, C):
    """Every (rows, C) the training paths give it: within tolerance, dw and db
    the same bits in two runs, db bitwise the ordered mirror, dw within fp32
    rounding of it; small integers for dh make db exact in any order."""
    x, w = _rn(gen, M, C).bfloat16(), 1 + _rn(gen, C, std=0.1)
    dh, res = _rn(gen, M, C), _rn(gen, M, C).bfloat16()
    got = kernels.layernorm_bwd(x, w, dh, res)
    for name, g, wt in zip(("dx", "dw", "db"), got, kernels.layernorm_bwd_plain(x, w, dh, res)):
        _close(g, wt, name)
    _, dw2, db2 = kernels.layernorm_bwd(x, w, dh, res)
    assert torch.equal(got[1], dw2) and torch.equal(got[2], db2)
    _, dw_o, db_o = kernels.layernorm_bwd_ordered(x, w, dh, res)
    assert torch.equal(got[2], db_o)
    _close(got[1], dw_o, "dw against the ordered mirror")
    idh = torch.randint(-3, 4, (M, C), generator=gen, device="cuda").float()
    assert torch.equal(kernels.layernorm_bwd(x, w, idh, res)[2], kernels.layernorm_bwd_plain(x, w, idh, res)[2])


@pytest.mark.parametrize("M,N,K", [
    (1224, 2304, 768), (1224, 768, 3072), (111, 64, 256),
    (19584, 2304, 768), (19584, 768, 3072),  # the training step's audio batch, B = 64
    (15300, 2304, 768), (15300, 768, 3072),  # the AT step's audio batch, B = 50
])
def test_gemm_backward_kernels_match_plain(gen, M, N, K):
    x, w, b = _rn(gen, M, K).bfloat16(), _rn(gen, N, K, std=K ** -0.5).bfloat16(), _rn(gen, N)
    y, a = kernels.gemm_bias_act(x, w, b, "gelu", preact=True)
    y0, a0 = kernels.gemm_bias_act_plain(x, w, b, "gelu", preact=True)
    _close(y, y0, "y")
    _close(a, a0, "preact")
    dy, a_in = _rn(gen, M, N).bfloat16(), _rn(gen, M, K)  # a_in: the preact of dy . w
    for act in ("none", "quick_gelu", "gelu"):
        pre = None if act == "none" else a_in
        for rounded in (True, False):
            _close(kernels.gemm_dgrad(dy, w, rounded, act, pre),
                   kernels.gemm_dgrad_plain(dy, w, rounded, act, pre), f"dgrad {act} {rounded}")
    _close(kernels.gemm_wgrad(dy, x), kernels.gemm_wgrad_plain(dy, x), "wgrad")
    for t in (dy, a0):
        _close(kernels.colsum(t), kernels.colsum_plain(t), f"colsum {t.dtype}")


@pytest.mark.parametrize("M,N1,N2", [
    (19584, 768, 768), (19584, 2304, 768), (19584, 768, 3072), (19584, 3072, 768),  # audio tower, B = 64
    (4928, 512, 512), (4928, 1536, 512), (4928, 512, 2048), (4928, 2048, 512),      # caption decoder, B = 64
    (15300, 768, 768), (15300, 2304, 768), (15300, 768, 3072), (15300, 3072, 768),  # AT audio tower, B = 50
    (1, 768, 768), (63, 768, 768), (3200, 768, 768),                                # ragged rows
    (1000, 136, 264), (63, 8, 24), (200, 64, 520),                                  # N short of and past a tile
])
def test_gemm_wgrad_kernel_matches_plain_and_repeats(gen, M, N1, N2):
    a, b = _rn(gen, M, N1).bfloat16(), _rn(gen, M, N2).bfloat16()
    reset_launches()
    got = kernels.gemm_wgrad(a, b)
    assert LAUNCHES == {"gemm_wgrad": 1}
    _close(got, kernels.gemm_wgrad_plain(a, b), "wgrad")
    assert torch.equal(got, kernels.gemm_wgrad(a, b))  # no atomics: the same bits in every run
    # small integers sum exactly in fp32 whatever the order: any misplaced element shows
    ia = torch.randint(-3, 4, (M, N1), generator=gen, device="cuda").bfloat16()
    ib = torch.randint(-3, 4, (M, N2), generator=gen, device="cuda").bfloat16()
    assert torch.equal(kernels.gemm_wgrad(ia, ib), kernels.gemm_wgrad_plain(ia, ib))
    # the order of the sum is the plan's: one partial per row chunk, added in order
    S, rows = kernels.wgrad_split(M, N1, N2)
    assert (S - 1) * rows < M <= S * rows


@pytest.mark.parametrize("M,N,K", [
    (1, 64, 64), (4, 2048, 512), (4, 512, 2048), (16, 512, 2048),   # caption decode at T = 1
    (64, 2048, 512), (64, 512, 2048), (256, 512, 2048),
    (63, 200, 136), (37, 13, 64), (111, 264, 256),                   # ragged M, N off the tile, odd N
    (1224, 2304, 768), (1224, 768, 3072),                            # audio tower, B = 4
    (19584, 2304, 768), (19584, 768, 3072),                          # the training step's audio batch
    (15300, 2304, 768), (15300, 768, 3072),                          # the AT step's audio batch, B = 50
    (3850, 1536, 512), (19250, 2048, 512),                           # its text tower, B = 50 and eval B = 250
])
def test_gemm_bias_act_kernel_matches_plain_and_repeats(gen, M, N, K):
    x, w, b = _rn(gen, M, K).bfloat16(), _rn(gen, N, K, std=K ** -0.5).bfloat16(), _rn(gen, N, std=0.1)
    res = _rn(gen, M, N).bfloat16()
    for act in ("none", "quick_gelu", "gelu"):
        for r in (None, res):
            for pre in (False, True):
                what = f"{act} residual={r is not None} preact={pre}"
                reset_launches()
                got = kernels.gemm_bias_act(x, w, b, act, r, pre)
                assert LAUNCHES == {"gemm_bias_act": 1}
                want = kernels.gemm_bias_act_plain(x, w, b, act, r, pre)
                for g, wt in zip(*((got, want) if pre else ((got,), (want,)))):
                    _close(g, wt, what)
    # no atomics: the same bits in every run
    assert torch.equal(kernels.gemm_bias_act(x, w, b, "gelu", res), kernels.gemm_bias_act(x, w, b, "gelu", res))
    # small integers sum exactly in fp32 whatever the order: any misplaced element shows
    ix = torch.randint(-3, 4, (M, K), generator=gen, device="cuda").bfloat16()
    iw = torch.randint(-3, 4, (N, K), generator=gen, device="cuda").bfloat16()
    ib = torch.randint(-3, 4, (N,), generator=gen, device="cuda").float()
    y, a = kernels.gemm_bias_act(ix, iw, ib, preact=True)
    y0, a0 = kernels.gemm_bias_act_plain(ix, iw, ib, preact=True)
    assert torch.equal(a, a0) and torch.equal(y, y0)


@pytest.mark.parametrize("M,N,K", [
    (19584, 768, 768), (19584, 768, 2304), (19584, 3072, 768), (19584, 768, 3072),  # audio tower, B = 64
    (4928, 512, 512), (4928, 512, 1536), (4928, 2048, 512), (4928, 512, 2048),      # caption decoder, B = 64
    (15300, 768, 768), (15300, 768, 2304), (15300, 3072, 768), (15300, 768, 3072),  # AT audio tower, B = 50
    (1224, 768, 768), (111, 64, 256), (111, 200, 40), (63, 136, 24), (1, 64, 8),    # ragged M, N = 64, K < 64
])
def test_gemm_dgrad_kernel_matches_plain_and_repeats(gen, M, N, K):
    dy, w, pre = _rn(gen, M, K).bfloat16(), _rn(gen, K, N, std=K ** -0.5).bfloat16(), _rn(gen, M, N)
    for act in ("none", "quick_gelu", "gelu"):
        p = None if act == "none" else pre
        for rounded in (True, False):
            reset_launches()
            got = kernels.gemm_dgrad(dy, w, rounded, act, p)
            assert LAUNCHES == {"gemm_dgrad": 1}
            _close(got, kernels.gemm_dgrad_plain(dy, w, rounded, act, p), f"{act} rounded={rounded}")
            assert torch.equal(got, kernels.gemm_dgrad(dy, w, rounded, act, p))  # no atomics, no K split
    # small integers sum exactly in fp32 whatever the order: any misplaced element shows
    idy = torch.randint(-3, 4, (M, K), generator=gen, device="cuda").bfloat16()
    iw = torch.randint(-3, 4, (K, N), generator=gen, device="cuda").bfloat16()
    assert torch.equal(kernels.gemm_dgrad(idy, iw, False), kernels.gemm_dgrad_plain(idy, iw, False))


def test_gemm_wgrad_takes_batched_operands_and_rejects_others(gen):
    a, b = _rn(gen, 3, 70, 64).bfloat16(), _rn(gen, 3, 70, 128).bfloat16()
    _close(kernels.gemm_wgrad(a, b), kernels.gemm_wgrad_plain(a, b), "batched")
    assert torch.equal(kernels.gemm_wgrad(a[:0], b[:0]), torch.zeros(64, 128, device="cuda"))  # no rows
    with pytest.raises(ValueError, match="same rows"):
        kernels.gemm_wgrad(a, b[:2].contiguous())
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.gemm_wgrad(_rn(gen, 70, 12).bfloat16(), _rn(gen, 70, 64).bfloat16())
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.gemm_wgrad(a.float(), b)


@pytest.mark.parametrize("B,T,C,H,kind", [
    (2, 1, 128, 2, "none"),             # one token
    (3, 50, 768, 12, "none"),           # one image, less than a key tile
    (64, 77, 512, 8, "causal"),         # caption decoder
    (16, 200, 768, 12, "pack"),         # image tower, 4 packed: block-diagonal
    (64, 306, 768, 12, "none"),         # audio tower, the training step's batch
    (4, 308, 512, 8, "causal_pack"),    # text tower, 4 captions packed
    (2, 971, 768, 12, "none"),          # past what shared memory holds: keys streamed
    (2, 705, 128, 2, "causal"),         # the first length that streams
    (2, 704, 128, 2, "causal"),         # the last that stays resident
])
def test_attention_fwd_kernel_matches_plain(gen, B, T, C, H, kind):
    qkv = _rn(gen, B, T, 3 * C).bfloat16()
    bias = fused_attn.canon_bias(_bias(kind, T))
    reset_launches()
    out = kernels.attention_fwd(qkv, bias, H, 0.125)
    assert LAUNCHES == {"attention_fwd": 1}
    _close(out, kernels.attention_plain(qkv, bias, H, 0.125), "context")
    out_s, stats = kernels.attention_fwd(qkv, bias, H, 0.125, stats=True)
    assert torch.equal(out_s, out)  # the statistics are a by-product
    # they are the row max and the row sum of exp(s - max) over the real keys
    q, k, _, _ = kernels._softmax_p(qkv, bias, H, 0.125)
    sc = torch.matmul(q, k.transpose(-1, -2)) * 0.125
    sc = sc if bias is None else sc + bias
    m = sc.amax(-1)
    torch.testing.assert_close(stats[0], m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(stats[1], torch.exp(sc - m[..., None]).sum(-1), atol=0, rtol=1e-4)
    f32 = kernels.attention_fwd(qkv, bias, H, 0.125, fp32_out=True)
    assert LAUNCHES["attention_fwd_f32"] == 1
    torch.testing.assert_close(f32, kernels.attention_plain(qkv, bias, H, 0.125, fp32_out=True),
                               atol=1e-2, rtol=1e-2)  # p is rounded to bf16 in both
    assert torch.equal(f32.bfloat16(), out)
    # the backward takes these statistics
    do = _rn(gen, B, T, C).bfloat16()
    got = kernels.attention_bwd(qkv, do, bias, H, 0.125, stats)
    want = kernels.attention_bwd_plain(qkv, do, bias, H, 0.125)
    _close(got[0], want[0], "dqkv")
    _close(got[1], want[1], "dqkv bf16")


@pytest.mark.parametrize("T", [37, 306, 971])
def test_attention_fwd_row_masked_everywhere_is_uniform_not_nan(gen, T):
    B, H, C = 2, 2, 128
    qkv = _rn(gen, B, T, 3 * C).bfloat16()
    bias = torch.zeros(T, T, device="cuda")
    bias[5] = -1e30       # row 5 sees no key
    bias[:, 7] = -1e30    # and no row sees key 7
    out, stats = kernels.attention_fwd(qkv, bias, H, 0.125, stats=True)
    assert torch.isfinite(out).all() and torch.isfinite(stats).all()
    _close(out, kernels.attention_plain(qkv, bias, H, 0.125), "masked")
    v = qkv.float().view(B, T, 3, H, 64)[:, :, 2]                   # [B, T, H, 64]
    uniform = v.mean(dim=1).reshape(B, C)                           # the mean of all values
    torch.testing.assert_close(out[:, 5].float(), uniform, **TOL)
    assert torch.equal(stats[1][:, :, 5], torch.full((B, H), float(T), device="cuda"))


@pytest.mark.parametrize("B,T,C,H,kind", [
    (4, 306, 768, 12, "none"),          # audio tower
    (64, 306, 768, 12, "none"),         # the training step's audio batch
    (50, 306, 768, 12, "none"),         # the AT step's audio batch
    (1, 308, 512, 8, "causal_pack"),    # text tower, 4 captions packed
    (3, 37, 128, 2, "causal"),          # short ragged tail
    (64, 77, 512, 8, "causal"),         # caption decoder
    (16, 200, 768, 12, "pack"),         # image tower, 4 packed: block-diagonal
    (2, 1, 128, 2, "none"),             # one token
    (2, 768, 128, 2, "causal"),         # the last length whose keys stay resident in dq
    (2, 769, 128, 2, "causal"),         # the first that streams them
    (2, 971, 128, 2, "none"),
])
def test_attention_bwd_kernel_matches_plain(gen, B, T, C, H, kind):
    qkv, do = _rn(gen, B, T, 3 * C).bfloat16(), _rn(gen, B, T, C).bfloat16()
    bias = fused_attn.canon_bias(_bias(kind, T))
    o, stats = kernels.attention_fwd(qkv, bias, H, 0.125, stats=True)
    _close(o, kernels.attention_plain(qkv, bias, H, 0.125), "o")
    reset_launches()
    got = kernels.attention_bwd(qkv, do, bias, H, 0.125, stats)
    assert LAUNCHES == {"attention_bwd": 1}
    want = kernels.attention_bwd_plain(qkv, do, bias, H, 0.125)
    _close(got[0], want[0], "dqkv")
    _close(got[1], want[1], "dqkv bf16")
    again = kernels.attention_bwd(qkv, do, bias, H, 0.125, stats)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])  # no atomics


@pytest.mark.parametrize("T,kind,w0,r0", [
    (64, "none", 0, 0),           # one tile each way
    (306, "pack", 40, 100),       # windows across the 64-key and 128-row tile edges
    (77, "causal", 10, 13),       # the decoder's length, masked
    (306, "none", 250, 200),      # windows that run past T
])
def test_attention_bwd_recomputes_the_forwards_p_bitwise(gen, T, kind, w0, r0):
    """v one-hot on keys w0 .. w0 + 63 makes the forward's output o[i, d] =
    bf16(p[i, w0 + d]); do one-hot on queries r0 .. r0 + 63 makes the
    backward's dv[j, d] = bf16(p[r0 + d, j]); one nonzero term per sum, so
    both are exact and the two p must be equal bit for bit."""
    B, H, C = 2, 2, 128
    bias = fused_attn.canon_bias(_bias(kind, T, k=2 if kind == "pack" else 4))
    nk, nq = min(64, T - w0), min(64, T - r0)
    qkv = _rn(gen, B, T, 3 * C).bfloat16()
    v = qkv.view(B, T, 3, H, 64)[:, :, 2]
    v.zero_()
    v[:, w0 + torch.arange(nk), :, torch.arange(nk)] = 1
    do = torch.zeros(B, T, H, 64, dtype=torch.bfloat16, device="cuda")
    do[:, r0 + torch.arange(nq), :, torch.arange(nq)] = 1
    o, stats = kernels.attention_fwd(qkv, bias, H, 0.125, stats=True)
    _, dqkv_b = kernels.attention_bwd(qkv, do.view(B, T, C), bias, H, 0.125, stats)
    p_fwd = o.view(B, T, H, 64)[:, r0:r0 + nq, :, :nk]                                  # [B, query, H, key]
    p_bwd = dqkv_b.view(B, T, 3, H, 64)[:, w0:w0 + nk, 2, :, :nq].permute(0, 3, 2, 1)
    assert (p_fwd != 0).float().mean().item() > 0.25
    assert torch.equal(p_fwd, p_bwd)


def _grads(block, args, g, **kw):
    """Grads of ``block(*args, **kw)`` for the output grad ``g`` with respect
    to every argument, through the sub-block's autograd boundary."""
    leaves = [a.clone().requires_grad_() for a in args]
    return torch.autograd.grad(block(*leaves, **kw), leaves, g)


@pytest.mark.parametrize("B,T,C,H,kind", [
    (4, 306, 768, 12, "none"),
    (64, 306, 768, 12, "none"),         # the training step's audio batch
    (1, 308, 512, 8, "causal_pack"),
    (3, 37, 128, 2, "causal"),
])
def test_attention_block_backward_matches_plain(gen, B, T, C, H, kind):
    args = (_rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1),
            _rn(gen, 3 * C, C, std=C ** -0.5), _rn(gen, 3 * C, std=0.02),
            _rn(gen, C, C, std=C ** -0.5), _rn(gen, C, std=0.02))
    bias, g = _bias(kind, T), _rn(gen, B, T, C).bfloat16()
    names = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwout", "dbout")
    reset_launches()
    got = _grads(fused_attn.fused_ln_attention_block, args, g, bias=bias, heads=H)
    assert LAUNCHES["fused_ln_attention_block_bwd"] == 1 and LAUNCHES["attention_bwd"] == 1
    want = _grads(fused_attn.fused_ln_attention_block_plain, args, g, bias=bias, heads=H)
    for name, a, b in zip(names, got, want):
        _close(a, b, name)
    bare = (args[0], *args[3:])
    got = _grads(fused_attn.fused_attention_block, bare, g, bias=bias, heads=H)
    want = _grads(fused_attn.fused_attention_block_plain, bare, g, bias=bias, heads=H)
    for name, a, b in zip(names[:1] + names[3:], got, want):
        _close(a, b, "bare " + name)


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (1, 308, 512), (2, 37, 64)])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_block_backward_matches_plain(gen, B, T, C, act):
    E = 4 * C
    args = (_rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1),
            _rn(gen, E, C, std=C ** -0.5), _rn(gen, E, std=0.02),
            _rn(gen, C, E, std=E ** -0.5), _rn(gen, C, std=0.02))
    gy = _rn(gen, B, T, C).bfloat16()
    names = ("dx", "dlns", "dlnb", "dwfc", "dbfc", "dwproj", "dbproj")
    reset_launches()
    got = _grads(fused_mlp.fused_ln_mlp_block, args, gy, act=act)
    assert LAUNCHES["fused_ln_mlp_block_bwd"] == 1 and LAUNCHES["layernorm_bwd"] == 1
    want = _grads(fused_mlp.fused_ln_mlp_block_plain, args, gy, act=act)
    for name, a, b in zip(names, got, want):
        _close(a, b, name)


def test_train_step_runs_every_backward_through_the_kernels(gen):
    """Two-layer VA step at full width (B = 8): one backward launch of each
    sub-block per trainable layer, none from the frozen image tower, and
    every trainable grad as close to the fp32 grads of the plain ops (same
    init, same batch) as the plain ops' own bf16 grads: cosine within 5e-3,
    relative error within 3e-2, and the scale along the fp32 grad,
    V.F / |F|^2, within 5e-2 (which cosine alone cannot see), these two
    for every grad but the loss
    head's scalar logit_scale, whose grad is taken from the forward's
    features before any backward kernel runs. bf16 rounding alone puts the kernels'
    and the plain ops' bf16 grads about 0.5 % apart on the bias grads, so
    they are not held to each other at 0.999."""
    from vipant_tpu_torch.train import Trainer, loss_and_grads

    def trainer(dtype):
        return Trainer([
            "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val",
            "+model/text=dummy", "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
            "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=1000",
            "model.image.token_pack=4", "worker=CVAP", "model_file=", "running.batch_size=8",
            "model.image.encoder.layers=2", f"compute_dtype={dtype}",
        ], device="cuda", steps_per_epoch=1000)

    tr = trainer("bfloat16")
    r = np.random.default_rng(0)
    batch = tr.make_batch(r.standard_normal((8, 3, 224, 224)).astype(np.float32),
                          r.standard_normal((8, 1, 1000, 128)).astype(np.float32))
    reset_launches()
    loss, grads = loss_and_grads(tr.state, *batch)
    assert LAUNCHES["fused_ln_attention_block_bwd"] == LAUNCHES["fused_ln_mlp_block_bwd"] == 2
    assert LAUNCHES["fused_ln_attention_block"] == LAUNCHES["fused_ln_mlp_block"] == 4
    with mock.patch.object(fused_attn, "fused_ln_attention_block",
                           fused_attn.fused_ln_attention_block_plain), \
         mock.patch.object(fused_mlp, "fused_ln_mlp_block", fused_mlp.fused_ln_mlp_block_plain):
        loss_p, grads_p = loss_and_grads(tr.state, *batch)
        loss_f, grads_f = loss_and_grads(trainer("float32").state, *batch)
    assert torch.isfinite(loss) and abs(loss.item() - loss_p.item()) <= 1e-2 * abs(loss_p.item())

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    for k, g in grads.items():
        K, P, F = (t.double().flatten() for t in (g, grads_p[k], grads_f[k]))
        nf = F.norm().item()
        if nf > 0:
            assert cos(K, F) >= cos(P, F) - 5e-3, k
        if nf > 0 and not k.startswith("loss."):  # logit_scale: a scalar before any kernel
            assert (K - F).norm().item() / nf <= (P - F).norm().item() / nf + 3e-2, k
            assert abs((K - P) @ F).item() <= 5e-2 * nf ** 2, k  # scale along F


def test_at_step_runs_no_backward_kernel_in_the_frozen_text_tower(gen):
    """Two-layer AT step at full width (``LAMonitor``, B = 50, int32 token
    ids): every sub-block of both towers forward through the kernels, one
    backward launch of each sub-block per audio layer and none from the
    frozen text tower, and a finite loss near the plain ops' (1e-2)."""
    from vipant_tpu_torch.train import LATrainer, build_monitor, loss_and_grads

    tr = build_monitor([
        "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
        "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
        "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
        "running.audio.max_len=1000", "worker=CLAP", "monitor=LAMonitor", "model_file=",
        "running.batch_size=50", "model.audio.encoder.layers=2", "model.text.encoder.layers=2",
    ], steps_per_epoch=1000)
    assert isinstance(tr, LATrainer) and tr.device.type == "cuda"
    assert not any(k.startswith("text.") for k in tr.trainable)
    r = np.random.default_rng(0)
    ids = np.zeros((50, 77), np.int32)
    for row in ids:
        n = int(r.integers(5, 21))
        row[0], row[1:1 + n], row[1 + n] = 49406, r.integers(1, 49406, n), 49407
    batch = tr.make_batch(r.standard_normal((50, 1, 1000, 128)).astype(np.float32), ids)
    assert batch[1].dtype == torch.int32
    reset_launches()
    loss, _ = loss_and_grads(tr.state, *batch)
    assert LAUNCHES["fused_ln_attention_block"] == LAUNCHES["fused_ln_mlp_block"] == 4
    assert LAUNCHES["fused_ln_attention_block_bwd"] == LAUNCHES["fused_ln_mlp_block_bwd"] == 2
    assert LAUNCHES["attention_bwd"] == 2 and LAUNCHES["layernorm_bwd"] == 4
    with mock.patch.object(fused_attn, "fused_ln_attention_block",
                           fused_attn.fused_ln_attention_block_plain), \
         mock.patch.object(fused_mlp, "fused_ln_mlp_block", fused_mlp.fused_ln_mlp_block_plain):
        loss_p, _ = loss_and_grads(tr.state, *batch)
    assert torch.isfinite(loss) and abs(loss.item() - loss_p.item()) <= 1e-2 * abs(loss_p.item())


# ---------------------------------------------------------------------------
# the int8 kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,K", [(1224, 768), (1224, 3072), (19584, 768), (2304, 768), (37, 64),
                                    (300, 37), (300, 100), (1224, 2048),  # scalar loads (bf16); wider rows
                                    (50, 5000), (20, 8201)])  # 4 warps a row; the row read twice
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowquant_kernel_matches_plain(gen, rows, K, dtype):
    x = (_rn(gen, rows, K) * 3).to(dtype)
    x[1] = 0  # an all-zero row: scale 1e-12, codes 0
    reset_launches()
    got = kernels.rowquant(x)
    assert LAUNCHES == {"rowquant": 1}
    # bitwise the plain version (the same IEEE division, rounding and clip) and the same bits in
    # every run
    want = kernels.rowquant_plain(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = kernels.rowquant(x)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert (got[0][1] == 0).all() and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowquant_codes_at_the_half_way_points(gen, dtype):
    """Values within a few ulps of (k + 1/2) * scale, where the kernel's
    product by the reciprocal cannot prove the rounding and it divides: the
    codes are still bitwise the plain version's (IEEE division, half to
    even)."""
    rows, K = 256, 768
    s = (0.25 + 4 * torch.rand(rows, 1, generator=gen, device="cuda")).to(dtype).float()
    k = torch.randint(-127, 127, (rows, K), generator=gen, device="cuda").float() + 0.5
    steps = torch.randint(-3, 4, (rows, K), generator=gen, device="cuda")
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    x = ((k * s).to(dtype).view(ints) + steps.to(ints)).view(dtype)  # a few ulps from (k + 1/2) * s
    x[:, 0] = (127 * s[:, 0]).to(dtype)  # the row's largest: the scale is about s
    got, want = kernels.rowquant(x), kernels.rowquant_plain(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (1, 308, 512), (3, 37, 64), (2, 100, 1024),
                                   (2, 50, 2048)])
def test_layernorm_rowquant_kernel_matches_plain(gen, B, T, C):
    x = _rn(gen, B, T, C).bfloat16()
    x[0, 1] = 0
    w, b = 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1)
    reset_launches()
    got = kernels.layernorm_rowquant(x, w, b)
    assert LAUNCHES == {"layernorm_rowquant": 1}
    again = kernels.layernorm_rowquant(x, w, b)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # bitwise the chain layernorm_fwd -> rowquant: the LayerNorm code is shared
    q, s = kernels.rowquant(kernels.layernorm_fwd(x, w, b))
    assert torch.equal(got[0], q) and torch.equal(got[1], s)
    # the statistics are taken in float64 on both sides (rows.cuh, kernels._ln_stats), so the
    # codes and scales are the plain version's
    pq, ps = kernels.layernorm_rowquant_plain(x, w, b)
    assert torch.equal(got[0], pq) and torch.equal(got[1], ps)


@pytest.mark.parametrize("M,N,K", [(1224, 2304, 768), (1224, 768, 3072), (308, 1536, 512),
                                   (308, 512, 2048), (19584, 3072, 768), (19584, 768, 3072),
                                   (3200, 2304, 768), (111, 64, 256), (111, 64, 80),
                                   (50, 24, 80)])  # K and N short of a tile, K not a multiple of 32
def test_gemm_i8_kernel_matches_plain(gen, M, N, K):
    xq, rs = kernels.rowquant(_rn(gen, M, K))
    wq, cs = kernels.rowquant(_rn(gen, N, K, std=K ** -0.5))
    b, res = _rn(gen, N, std=0.02), _rn(gen, M, N).bfloat16()
    if K == 3072:  # the largest sum there is: every code at its limit
        xq[0], wq[0] = 127, -127
    for kw in (dict(), dict(col_first=True), dict(residual=res), dict(act="quick_gelu", out_dtype=torch.float32),
               dict(act="gelu", out_dtype=torch.float32)):
        reset_launches()
        got = kernels.gemm_i8(xq, rs, wq, cs, b, **kw)
        assert LAUNCHES == {"gemm_i8": 1}
        want = kernels.gemm_i8_plain(xq, rs, wq, cs, b, **kw)
        _close(got, want, f"gemm_i8 {kw}")
        assert torch.equal(got, kernels.gemm_i8(xq, rs, wq, cs, b, **kw))  # no atomics: the same bits
    # the integer sum itself is exact: unit scales, no bias
    one_r, one_c = torch.ones(M, 1, device="cuda"), torch.ones(N, 1, device="cuda")
    got = kernels.gemm_i8(xq, one_r, wq, one_c, torch.zeros(N, device="cuda"), out_dtype=torch.float32)
    assert torch.equal(got, kernels.int_matmul_plain(xq, wq))


@pytest.mark.parametrize("B,T,C,H,kind", [(4, 306, 768, 12, "none"), (1, 308, 512, 8, "causal_pack"),
                                          (4, 200, 768, 12, "pack"), (3, 37, 128, 2, "causal")])
def test_attention_fwd_f32_kernel_matches_plain(gen, B, T, C, H, kind):
    qkv = _rn(gen, B, T, 3 * C).bfloat16()
    bias = fused_attn.canon_bias(_bias(kind, T))
    got = kernels.attention_fwd(qkv, bias, H, 0.125, fp32_out=True)
    want = kernels.attention_plain(qkv, bias, H, 0.125, fp32_out=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)  # p is rounded to bf16 in both
    # rounded once, it is the bf16 kernel's context bitwise
    assert torch.equal(got.bfloat16(), kernels.attention_fwd(qkv, bias, H, 0.125))


@pytest.mark.parametrize("B,T,C,H,kind", [
    (4, 306, 768, 12, "none"), (16, 308, 512, 8, "causal_pack"), (16, 200, 768, 12, "pack"),
    (3, 37, 128, 2, "causal"),
])
def test_attention_block_int8_kernels_match_plain(gen, B, T, C, H, kind):
    args = (_rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1),
            _rn(gen, 3 * C, C, std=C ** -0.5), _rn(gen, 3 * C, std=0.02),
            _rn(gen, C, C, std=C ** -0.5), _rn(gen, C, std=0.02))
    args[0][0, 1] = 0  # an all-zero token
    bias = _bias(kind, T)
    reset_launches()
    got = fused_attn.fused_ln_attention_block_int8(*args, bias=bias, heads=H)
    assert LAUNCHES == {"rowquant": 3, "layernorm_rowquant": 1, "gemm_i8": 2, "attention_fwd_f32": 1,
                        "fused_ln_attention_block_int8": 1}
    want = fused_attn.fused_ln_attention_block_int8_plain(*args, bias=bias, heads=H)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    bf16 = fused_attn.fused_ln_attention_block(*args, bias=bias, heads=H)
    cos = torch.nn.functional.cosine_similarity(got.float(), bf16.float(), dim=-1)
    assert cos.min().item() >= 0.999
    bare = fused_attn.fused_attention_block_int8(args[0], *args[3:], bias=bias, heads=H)
    want = fused_attn.fused_attention_block_int8_plain(args[0], *args[3:], bias=bias, heads=H)
    torch.testing.assert_close(bare.float(), want.float(), **TOL)
    leaf = args[3].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        fused_attn.fused_ln_attention_block_int8(*args[:3], leaf, *args[4:], heads=H).sum().backward()


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (16, 308, 512), (2, 37, 64)])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_block_int8_kernels_match_plain(gen, B, T, C, act):
    E = 4 * C
    args = (_rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1),
            _rn(gen, E, C, std=C ** -0.5), _rn(gen, E, std=0.02),
            _rn(gen, C, E, std=E ** -0.5), _rn(gen, C, std=0.02))
    args[0][0, 1] = 0
    reset_launches()
    got = fused_mlp.fused_ln_mlp_block_int8(*args, act=act)
    assert LAUNCHES == {"rowquant": 3, "layernorm_rowquant": 1, "gemm_i8": 2,
                        "fused_ln_mlp_block_int8": 1}
    want = fused_mlp.fused_ln_mlp_block_int8_plain(*args, act=act)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    bf16 = fused_mlp.fused_ln_mlp_block(*args, act=act)
    assert torch.nn.functional.cosine_similarity(got.float(), bf16.float(), dim=-1).min().item() >= 0.999


def test_int8_wrappers_reject_what_the_kernels_do_not_take(gen):
    xq, rs = kernels.rowquant(_rn(gen, 32, 64))
    wq, cs = kernels.rowquant(_rn(gen, 16, 64))
    b = torch.zeros(16, device="cuda")
    with pytest.raises(ValueError, match="torch.int8"):
        kernels.gemm_i8(xq.float(), rs, wq, cs, b)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.gemm_i8(xq[:, :40].contiguous(), rs, wq[:, :40].contiguous(), cs, b)
    with pytest.raises(ValueError, match="row_scale"):
        kernels.gemm_i8(xq, rs[:5], wq, cs, b)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        kernels.rowquant(_rn(gen, 4, 64).half())
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.layernorm_rowquant(_rn(gen, 4, 64), torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"))


def test_int8_engine_runs_every_sub_block_through_the_int8_kernels(gen):
    cfg = [
        "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
        "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
        "+running/audio=default", "worker=CLAP", "model.audio.encoder.layers=2",
        "model.text.encoder.layers=2", "running.audio.max_len=200", "model_file=",
    ]
    eng = InferenceEngine(cfg, batch_size=4, quantize="int8")  # the card is the default
    bf16 = InferenceEngine(cfg, batch_size=4)
    fb = np.random.default_rng(3).standard_normal((6, 200, 128)).astype(np.float32)
    texts = ["a dog barking", "rain", "a car", "wind", "birds"]
    reset_launches()
    got_a, got_t = eng.embed_audio(fb), eng.embed_texts(texts)
    assert LAUNCHES["fused_ln_attention_block_int8"] == LAUNCHES["fused_ln_mlp_block_int8"] == 8
    assert LAUNCHES["fused_ln_attention_block"] == LAUNCHES["fused_ln_mlp_block"] == 0
    with mock.patch.object(fused_attn, "fused_ln_attention_block_int8",
                           fused_attn.fused_ln_attention_block_int8_plain), \
         mock.patch.object(fused_mlp, "fused_ln_mlp_block_int8", fused_mlp.fused_ln_mlp_block_int8_plain):
        want_a, want_t = eng.embed_audio(fb), eng.embed_texts(texts)
    ref_a, ref_t = bf16.embed_audio(fb), bf16.embed_texts(texts)
    cos = lambda a, b: ((a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)).min()
    for got, want, ref in ((got_a, want_a, ref_a), (got_t, want_t, ref_t)):
        assert np.isfinite(got).all() and cos(got, want) >= 0.999 and cos(got, ref) >= 0.99


def test_int8_frozen_tower_in_a_train_step(gen):
    from vipant_tpu_torch.train import Trainer

    cfg = [
        "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
        "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
        "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=1000",
        "model.image.token_pack=4", "worker=CVAP", "model_file=", "running.batch_size=8",
        "model.image.encoder.layers=2", "model.audio.encoder.layers=2",
    ]
    tr = Trainer(cfg + ["model.image.int8_frozen=True"], steps_per_epoch=1000)
    ref = Trainer(cfg, steps_per_epoch=1000)
    r = np.random.default_rng(0)
    batch = tr.make_batch(r.standard_normal((8, 3, 224, 224)).astype(np.float32),
                          r.standard_normal((8, 1, 1000, 128)).astype(np.float32))
    frozen = {k: p.detach().clone() for k, p in tr.frozen.items()}
    reset_launches()
    m = tr.train_step(*batch)
    assert LAUNCHES["fused_ln_attention_block_int8"] == LAUNCHES["fused_ln_mlp_block_int8"] == 2
    assert LAUNCHES["fused_ln_attention_block"] == LAUNCHES["fused_ln_mlp_block"] == 2  # audio only
    assert LAUNCHES["fused_ln_attention_block_bwd"] == LAUNCHES["fused_ln_mlp_block_bwd"] == 2
    m_ref = ref.train_step(*batch)
    assert np.isfinite(float(m["loss"]))
    assert abs(float(m["loss"]) - float(m_ref["loss"])) <= 5e-2 * abs(float(m_ref["loss"]))
    for k, p in tr.frozen.items():
        assert torch.equal(p.detach(), frozen[k]), k
    with torch.no_grad():
        v8, v = tr.model.encode_image(batch[0]), ref.model.encode_image(batch[0])
    assert torch.nn.functional.cosine_similarity(v8.float(), v.float(), dim=-1).min().item() >= 0.99


# ---------------------------------------------------------------------------
# flash attention on separate q, k, v (cross-attention) and the probe kernels
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (B, Tq, Tk, H, bias): the flash kernel phase of chip_smoke.py, and ragged tails
    (64, 77, 61, 8, "none"),      # the captioning decoder's cross-attention
    (4, 77, 61, 8, "none"),
    (64, 32, 61, 8, "none"),      # the re-forward decoder
    (4, 32, 61, 8, "none"),
    (16, 971, 971, 12, "none"),   # a sequence the TPU's fused block refuses
    (64, 77, 77, 8, "causal"),
    (16, 200, 200, 12, "pack"),
    (3, 130, 70, 2, "random"),    # ragged on both axes, some entries masked
    (2, 1, 9, 2, "none"),
    # ragged tails of the backward's tiles: Tq 1, 17, 65, 130 against Tk 1, 63, 65, 705 (dq keeps K
    # and V resident up to 768 keys) and 971 (dq streams them)
    (2, 1, 63, 2, "random"),
    (2, 1, 705, 2, "none"),
    (2, 17, 1, 2, "none"),
    (2, 17, 705, 2, "random"),
    (2, 65, 65, 2, "random"),
    (2, 65, 971, 2, "random"),
    (2, 130, 63, 2, "random"),
    (2, 130, 971, 2, "none"),
]


def _flash_inputs(gen, B, Tq, Tk, H, kind):
    q, k, v, do = (_rn(gen, B, T, H, 64).bfloat16() for T in (Tq, Tk, Tk, Tq))
    if kind == "random":
        bias = _rn(gen, Tq, Tk)
        bias[torch.rand(Tq, Tk, generator=gen, device="cuda") < 0.2] = -1e30
    else:
        bias = _bias(kind, Tq)
        bias = None if bias is None else torch.clamp(bias.float(), min=-1e30).contiguous()
    return q, k, v, do, bias


@pytest.mark.parametrize("B,Tq,Tk,H,kind", FLASH_CASES)
def test_flash_attention_kernels_match_plain(gen, B, Tq, Tk, H, kind):
    q, k, v, do, bias = _flash_inputs(gen, B, Tq, Tk, H, kind)
    reset_launches()
    o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
    o0, lse0 = kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)
    _close(o, o0, "o")
    _close(lse, lse0, "lse")
    o2, lse2 = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # the same bits in every run
    tiles, rows = kernels.flash_fwd_plan(Tq, Tk)
    assert (tiles - 1) * rows < Tq <= tiles * rows and rows % 16 == 0
    plan = kernels.flash_bwd_plan(Tq, Tk)
    assert (plan.k_tiles - 1) * plan.k_rows < Tk <= plan.k_tiles * plan.k_rows and plan.k_rows % 16 == 0
    got = kernels.flash_attention_bwd(q, k, v, bias, o0, lse0, do, 0.125)
    want = kernels.flash_attention_bwd_plain(q, k, v, bias, o0, lse0, do, 0.125)
    for name, g, w in zip(("dq", "dk", "dv", "delta"), got, want):
        _close(g, w, name)
    again = kernels.flash_attention_bwd(q, k, v, bias, o0, lse0, do, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "dq, dk, dv must be bitwise repeatable"
    assert LAUNCHES == {"flash_attention_fwd": 2, "flash_attention_bwd": 2}
    if bias is not None:
        dbias = kernels.flash_attention_dbias(q, k, v, bias, lse0, want[3], do, 0.125)
        _close(dbias, kernels.flash_attention_dbias_plain(q, k, v, bias, lse0, want[3], do, 0.125), "dbias")
        again = kernels.flash_attention_dbias(q, k, v, bias, lse0, want[3], do, 0.125)
        assert torch.equal(dbias, again), "the bias grad must be bitwise repeatable"
        # small integers make every product exact, so the kernel's ds_raw is the plain version's bit
        # for bit and its sum must be the plain sum in the kernel's order
        qi, ki, vi, doi = (torch.randint(-2, 3, t.shape, generator=gen, device="cuda").to(t.dtype)
                           for t in (q, k, v, do))
        oi, lsei = kernels.flash_attention_fwd_plain(qi, ki, vi, bias, 0.125)
        deltai = kernels.flash_attention_bwd_plain(qi, ki, vi, bias, oi, lsei, doi, 0.125)[3]
        assert torch.equal(kernels.flash_attention_dbias(qi, ki, vi, bias, lsei, deltai, doi, 0.125),
                           kernels.flash_attention_dbias_ordered(qi, ki, vi, bias, lsei, deltai, doi, 0.125))
        assert LAUNCHES["flash_attention_dbias"] == 3


@pytest.mark.parametrize("Tq,Tk", [(77, 61), (200, 200), (971, 971), (5, 130)])
def test_flash_attention_fwd_row_masked_everywhere_is_uniform(gen, Tq, Tk):
    """A bias of -1e30 across a whole row gives the uniform row (m = -1e30),
    not NaN, and leaves the other rows as the plain version has them."""
    q, k, v = _rn(gen, 2, Tq, 2, 64).bfloat16(), _rn(gen, 2, Tk, 2, 64).bfloat16(), _rn(gen, 2, Tk, 2, 64).bfloat16()
    bias = torch.zeros(Tq, Tk, device="cuda")
    bias[Tq // 2] = -1e30
    o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
    o0, lse0 = kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _close(o, o0, "o")
    _close(lse, lse0, "lse")
    mean_v = v.float().mean(dim=1).bfloat16()  # [B, H, 64]
    torch.testing.assert_close(o[:, Tq // 2].float(), mean_v.float(), **TOL)


@pytest.mark.parametrize("kind", ["none", "pack"])
def test_flash_attention_layouts_are_bitwise_equal(gen, kind):
    """Contiguous q, k, v, the sections of a packed [B, T, 3C] tensor and
    transposed [B, H, T, D] views: no copy, the same bits."""
    B, T, H = 4, 200, 12
    packed = _rn(gen, B, T, 3 * H * 64).bfloat16()
    do = _rn(gen, B, T, H, 64).bfloat16()
    bias = _bias(kind, T)
    sections = packed.view(B, T, 3, H, 64).unbind(dim=2)
    assert not sections[1].is_contiguous()
    outs = []
    for q, k, v in (sections, tuple(t.contiguous() for t in sections),
                    tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in sections)):
        o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
        outs.append((o, lse, *kernels.flash_attention_bwd(q, k, v, bias, o, lse, do, 0.125)))
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0]))


@pytest.mark.parametrize("Tq,Tk,kind,bias_grad", [(77, 61, "none", False), (77, 77, "causal", False),
                                                  (200, 200, "pack", True)])
def test_flash_attention_op_backward_matches_plain(gen, Tq, Tk, kind, bias_grad):
    """Through the autograd boundary, as the cross-attention layer calls it."""
    from vipant_tpu_torch.ops import attention

    q, k, v, do, bias = _flash_inputs(gen, 4, Tq, Tk, 8, kind)
    outs = []
    for fn in (attention.flash_attention, attention.flash_attention_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        b = None if bias is None else bias.clone().requires_grad_()
        reset_launches()
        o = fn(*leaves, bias=b, bias_grad=bias_grad)
        grads = torch.autograd.grad(o, leaves + ([] if b is None else [b]), do)
        outs.append((o, *grads))
        if fn is attention.flash_attention:
            assert LAUNCHES == {"flash_attention_fwd": 1, "flash_attention_bwd": 1,
                                **({"flash_attention_dbias": 1} if bias_grad else {})}
        else:
            assert not LAUNCHES
    for g, w in zip(*outs):
        _close(g, w)
    if bias is not None:
        assert bool(outs[0][4].any()) == bias_grad  # zeros for a constant mask


def test_flash_wrappers_reject_what_the_kernels_do_not_take(gen):
    q, k, v = (_rn(gen, 2, 16, 2, 64).bfloat16() for _ in range(3))
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.flash_attention_fwd(q.float(), k, v, None, 0.125)
    with pytest.raises(ValueError, match="64"):
        kernels.flash_attention_fwd(q[..., :32], k[..., :32], v[..., :32], None, 0.125)
    with pytest.raises(ValueError, match="contiguous"):  # a strided last dim
        kernels.flash_attention_fwd(_rn(gen, 2, 16, 2, 128).bfloat16()[..., ::2], k, v, None, 0.125)
    with pytest.raises(ValueError, match="bias"):
        kernels.flash_attention_fwd(q, k, v, torch.zeros(16, 8, device="cuda"), 0.125)
    with pytest.raises(ValueError, match="k and v"):
        kernels.flash_attention_fwd(q, k[:, :8], v, None, 0.125)
    o, lse = kernels.flash_attention_fwd(q, k, v, None, 0.125)
    with pytest.raises(ValueError, match="do must be"):
        kernels.flash_attention_bwd(q, k, v, None, o, lse, o[:, :8], 0.125)


def _dot_operands(gen, M, K, N):
    """one seeded logical product a [M, K] . b [K, N], stored in each orientation"""
    A, B = _rn(gen, M, K).bfloat16(), _rn(gen, K, N).bfloat16()
    return {name: (A.t().contiguous() if ta else A, B.t().contiguous() if tb else B)
            for name, (ta, tb) in kernels.ORIENTATIONS.items()}


@pytest.mark.parametrize("orientation", ["NN", "NT", "TN", "TT"])
@pytest.mark.parametrize("case,M,K,N", DOT_CASES, ids=[c[0] for c in DOT_CASES])
def test_dot_variant_kernel_matches_the_fp32_product(gen, case, M, K, N, orientation):
    a, b = _dot_operands(gen, M, K, N)[orientation]
    reset_launches()
    got = kernels.dot_variant(a, b, orientation)
    assert LAUNCHES == {"dot_variant": 1}
    want = kernels.dot_variant_plain(a, b, orientation)
    _close(got, want, orientation)
    assert (got - want).abs().max().item() <= 1e-3, case  # fp32 sums of up to 1024 bf16 products
    assert torch.equal(got, kernels.dot_variant(a, b, orientation)), "two runs differ"
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.dot_variant(a[:24, :24].contiguous(), b[:24, :24].contiguous(), orientation)
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.dot_variant(a.float(), b, orientation)


@pytest.mark.parametrize("case,M,K,N", DOT_CASES, ids=[c[0] for c in DOT_CASES])
def test_dot_variant_orientations_agree_bitwise(gen, case, M, K, N):
    """The four storages of one logical product give the same bits (wgmma
    sums k in one order whatever the operands' major-ness); the launch is
    kernels.dot_plan's; K = 0 gives zeros."""
    import ctypes

    from vipant_tpu_torch.ops import _build

    plan = (ctypes.c_int * 3)()
    assert _build.library().vt_dot_plan(M, N, K, plan) == 0
    assert tuple(plan) == tuple(kernels.dot_plan(M, N, K))
    outs = {name: kernels.dot_variant(a, b, name) for name, (a, b) in _dot_operands(gen, M, K, N).items()}
    for name, out in outs.items():
        assert torch.equal(out, outs["NN"]), name
        ta, tb = kernels.ORIENTATIONS[name]
        a = torch.empty((0, M) if ta else (M, 0), dtype=torch.bfloat16, device="cuda")
        b = torch.empty((N, 0) if tb else (0, N), dtype=torch.bfloat16, device="cuda")
        zero = kernels.dot_variant(a, b, name)
        assert zero.shape == (M, N) and not zero.any(), name


def test_probe_fused_fwd_matches_plain_and_the_fused_block(gen):
    from vipant_tpu_torch.experiments import fused_block_probe as probe

    args = probe.make_inputs(batch=4, device="cuda")
    reset_launches()
    out, lse = probe.probe_fused_fwd(*args)
    assert LAUNCHES == {"gemm_bias_act": 2, "flash_attention_fwd": 1, "probe_fused_fwd": 1}
    want, lse_want = probe.probe_fused_fwd_plain(*args)
    _close(out, want, "out")
    _close(lse, lse_want, "lse")
    _close(out, fused_attn.fused_attention_block(*args, heads=probe.H), "fused_attention_block")


def test_captioning_step_and_caption_run_through_the_kernels(gen):
    """A 2 + 2 layer captioning model at full width: one training step and
    one caption batch launch the flash kernels and the fused sub-blocks."""
    from vipant_tpu_torch.train import Trainer

    cfg = ["+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
           "+model/text=transformer_decoder", "+model/loss=ce_lm", "+optimizer=standard",
           "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
           "running.audio.max_len=1000", "running.retrieval=False", "worker=CLAP", "model_file=",
           "model.image.encoder.layers=2", "model.text.layers=2", "model.text.max_len_dec=4"]
    tr = Trainer(cfg + ["running.batch_size=2", "optimizer.warmup_epoch=0"])
    r = np.random.default_rng(0)
    ids = np.zeros((2, 77), np.int64)
    ids[:, 0], ids[:, 1:4], ids[:, 4] = 49406, r.integers(1, 49406, (2, 3)), 49407
    batch = tr.make_batch(r.standard_normal((2, 1, 1000, 128)).astype(np.float32), ids)
    reset_launches()
    m = tr.train_step(*batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert LAUNCHES["flash_attention_fwd"] == LAUNCHES["flash_attention_bwd"] == 2
    assert "flash_attention_dbias" not in LAUNCHES
    assert LAUNCHES["fused_ln_attention_block_bwd"] == LAUNCHES["fused_ln_mlp_block_bwd"] == 4
    eng = InferenceEngine(cfg, batch_size=2)
    reset_launches()
    out = eng.caption(r.standard_normal((3, 1000, 128)).astype(np.float32))
    assert len(out) == 3 and all(isinstance(c, str) for c in out)
    assert LAUNCHES["fused_ln_mlp_block"] == 2 * (2 + 4 * 2)  # 2 chunks: tower, and 4 steps x 2 layers


PATCH_SHAPES = [  # (Cin, H, W, patch, stride): the image and audio grids, DeiT's audio and image
    (3, 224, 224, (32, 32), (32, 32)),
    (1, 1000, 128, (32, 32), (16, 24)),
    (1, 1000, 128, (16, 16), (10, 10)),  # a stride of 10
    (3, 224, 224, (16, 16), (16, 16)),
]


@pytest.mark.parametrize("Cin,H,W,patch,stride", PATCH_SHAPES)
@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_patch_gather_is_bitwise_its_plain_version(gen, Cin, H, W, patch, stride, B, x_dtype, dtype):
    x = _rn(gen, B, Cin, H, W).to(x_dtype)
    reset_launches()
    got = kernels.patch_gather(x, patch, stride, dtype)
    assert LAUNCHES == {"patch_gather": 1}
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, kernels.patch_gather_plain(x, patch, stride, dtype))
    assert torch.equal(got, kernels.patch_gather(x, patch, stride, dtype))  # the same bits every run


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_patch_gather_of_an_unaligned_input_is_bitwise_its_plain_version(gen, x_dtype):
    """A base 2 or 4 bytes past a 16-byte boundary."""
    buf = _rn(gen, 4 * 224 * 224 * 3 + 1).to(x_dtype)
    x = buf[1:].view(4, 3, 224, 224)
    got = kernels.patch_gather(x, (32, 32), (32, 32))
    assert torch.equal(got, kernels.patch_gather_plain(x, (32, 32), (32, 32)))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_patch_gather_reads_views_through_their_strides(gen, x_dtype):
    """The device frontend's fbanks cropped in time and a transposed view,
    bitwise their plain versions."""
    x = _rn(gen, 4, 1, 1030, 128).to(x_dtype)
    for view in (x[:, :, :1000], x[:, :, :128].transpose(2, 3)):
        got = kernels.patch_gather(view, (32, 32), (16, 24))
        assert torch.equal(got, kernels.patch_gather_plain(view, (32, 32), (16, 24)))


def test_patch_gather_rejects_what_the_kernel_does_not_take(gen):
    x = _rn(gen, 2, 1, 1000, 128)
    with pytest.raises(ValueError, match="grad"):
        kernels.patch_gather(x.requires_grad_(), (32, 32), (16, 24))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        kernels.patch_gather(x.detach().half(), (32, 32), (16, 24))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        kernels.patch_gather(x.detach(), (32, 32), (16, 24), torch.float16)
    with pytest.raises(ValueError, match="4096"):
        kernels.patch_gather(_rn(gen, 1, 1, 32, 4104), (32, 32), (16, 24))


@pytest.mark.parametrize("Cin,H,W,patch,stride", PATCH_SHAPES)
def test_vit_pre_encoder_on_the_card_matches_the_cpu(Cin, H, W, patch, stride):
    """The audio and image towers' first stage, bf16, fp32 input: one patch
    gather on the card, within the bf16 tolerance of the CPU's plain path."""
    from vipant_tpu_torch.nn.stages import ViTPreEncoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    enc = ViTPreEncoder(768, patch, stride, in_channels=3, dtype=torch.bfloat16)
    enc.init_weights(g)
    T = 1 + ((H - patch[0]) // stride[0] + 1) * ((W - patch[1]) // stride[1] + 1)
    x, pos, cls = torch.randn(4, Cin, H, W, generator=g), torch.randn(T, 768, generator=g) * 0.02, \
        torch.randn(768, generator=g) * 0.02
    with torch.no_grad():
        want = enc(x, pos, cls)
        enc.cuda()
        reset_launches()
        got = enc(x.cuda(), pos.cuda(), cls.cuda())
    assert LAUNCHES["patch_gather"] == 1
    _close(got.cpu(), want, f"ViTPreEncoder {Cin}x{H}x{W} {patch}/{stride}")
