"""The hand-written CUDA kernels (vipant_tpu_torch/csrc) against their plain
PyTorch versions on the card, at the serving and training paths' shapes.
Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest

Tolerances: atol = rtol = 2e-2 on bf16 outputs, one bf16 ulp of the output
plus a different fp32 summation order; max |d| <= 1e-2 * max |plain| on
fp32 grads (weight, bias and LayerNorm grads, the fp32 dqkv), which sum
over thousands of rows in another order. Int8 codes: equal except a share
of at most 1e-3 off by exactly one, scales to 1e-6 relative; the int32 sum
of gemm_i8 is exact (compared bitwise at unit scales)."""

from unittest import mock

import numpy as np
import pytest
import torch

from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
from vipant_tpu_torch.ops import LAUNCHES, fused_attn, fused_mlp, kernels, reset_launches
from vipant_tpu_torch.serve import InferenceEngine

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


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (1, 308, 512), (3, 37, 64)])
def test_layernorm_bwd_kernel_matches_plain(gen, B, T, C):
    x, w = _rn(gen, B, T, C).bfloat16(), 1 + _rn(gen, C, std=0.1)
    dh, res = _rn(gen, B, T, C), _rn(gen, B, T, C).bfloat16()
    for r in (res, None):
        got = kernels.layernorm_bwd(x, w, dh, r)
        want = kernels.layernorm_bwd_plain(x, w, dh, r)
        for name, g, wt in zip(("dx", "dw", "db"), got, want):
            _close(g, wt, name)


@pytest.mark.parametrize("M,N,K", [
    (1224, 2304, 768), (1224, 768, 3072), (111, 64, 256),
    (19584, 2304, 768), (19584, 768, 3072),  # the training step's audio batch, B = 64
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


@pytest.mark.parametrize("B,T,C,H,kind", [
    (4, 306, 768, 12, "none"),          # audio tower
    (64, 306, 768, 12, "none"),         # the training step's audio batch
    (1, 308, 512, 8, "causal_pack"),    # text tower, 4 captions packed
    (3, 37, 128, 2, "causal"),          # short ragged tail
])
def test_attention_bwd_kernel_matches_plain(gen, B, T, C, H, kind):
    qkv, do = _rn(gen, B, T, 3 * C).bfloat16(), _rn(gen, B, T, C).bfloat16()
    bias = fused_attn.canon_bias(_bias(kind, T))
    o, stats = kernels.attention_fwd(qkv, bias, H, 0.125, stats=True)
    _close(o, kernels.attention_plain(qkv, bias, H, 0.125), "o")
    got = kernels.attention_bwd(qkv, do, bias, H, 0.125, stats)
    want = kernels.attention_bwd_plain(qkv, do, bias, H, 0.125)
    _close(got[0], want[0], "dqkv")
    _close(got[1], want[1], "dqkv bf16")


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


# ---------------------------------------------------------------------------
# the int8 kernels
# ---------------------------------------------------------------------------

FLIP_SHARE = 1e-3


def _codes_close(got, want, what=""):
    """(codes, scale) pairs: scales to 1e-6 relative; codes equal except a
    share of at most 1e-3 that is off by exactly one (x / scale within an
    fp32 ulp of a half, rounded the other way by another division order)."""
    (q, s), (q0, s0) = got, want
    assert q.dtype == torch.int8 and q.shape == q0.shape and s.shape == s0.shape, what
    torch.testing.assert_close(s, s0, rtol=1e-6, atol=0, msg=what)
    d = (q.int() - q0.int()).abs()
    assert d.max().item() <= 1, f"{what}: a code is off by {d.max().item()}"
    assert (d != 0).float().mean().item() <= FLIP_SHARE, f"{what}: {(d != 0).float().mean().item()}"


@pytest.mark.parametrize("rows,K", [(1224, 768), (1224, 3072), (19584, 768), (2304, 768), (37, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowquant_kernel_matches_plain(gen, rows, K, dtype):
    x = (_rn(gen, rows, K) * 3).to(dtype)
    x[1] = 0  # an all-zero row: scale 1e-12, codes 0
    reset_launches()
    got = kernels.rowquant(x)
    assert LAUNCHES == {"rowquant": 1}
    _codes_close(got, kernels.rowquant_plain(x), "rowquant")
    assert (got[0][1] == 0).all() and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("B,T,C", [(4, 306, 768), (64, 306, 768), (1, 308, 512), (3, 37, 64)])
def test_layernorm_rowquant_kernel_matches_plain(gen, B, T, C):
    x = _rn(gen, B, T, C).bfloat16()
    x[0, 1] = 0
    w, b = 1 + _rn(gen, C, std=0.1), _rn(gen, C, std=0.1)
    got = kernels.layernorm_rowquant(x, w, b)
    # bitwise the chain layernorm_fwd -> rowquant: the LayerNorm code is shared
    q, s = kernels.rowquant(kernels.layernorm_fwd(x, w, b))
    assert torch.equal(got[0], q) and torch.equal(got[1], s)
    # against the plain LayerNorm a normalised value may round to the neighbouring bf16: its code
    # then moves by one, and where it is the row's largest, the scale by one bf16 ulp (2^-8)
    pq, ps = kernels.layernorm_rowquant_plain(x, w, b)
    d = (got[0].int() - pq.int()).abs()
    assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-2
    torch.testing.assert_close(got[1], ps, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("M,N,K", [(1224, 2304, 768), (1224, 768, 3072), (308, 1536, 512),
                                   (308, 512, 2048), (19584, 3072, 768), (111, 64, 256),
                                   (50, 24, 80)])  # K and N short of a tile, K not a multiple of 32
def test_gemm_i8_kernel_matches_plain(gen, M, N, K):
    xq, rs = kernels.rowquant(_rn(gen, M, K))
    wq, cs = kernels.rowquant(_rn(gen, N, K, std=K ** -0.5))
    b, res = _rn(gen, N, std=0.02), _rn(gen, M, N).bfloat16()
    if K == 3072:  # the largest sum there is: every code at its limit
        xq[0], wq[0] = 127, -127
    for kw in (dict(), dict(col_first=True), dict(residual=res), dict(act="quick_gelu", out_dtype=torch.float32),
               dict(act="gelu", out_dtype=torch.float32)):
        got = kernels.gemm_i8(xq, rs, wq, cs, b, **kw)
        want = kernels.gemm_i8_plain(xq, rs, wq, cs, b, **kw)
        _close(got, want, f"gemm_i8 {kw}")
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
