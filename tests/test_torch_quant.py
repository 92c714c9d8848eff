"""The port's int8 path (vipant_tpu_torch/ops/quant.py, the ``*_int8``
sub-blocks, ``int8_frozen`` and ``quantize="int8"``) against the JAX package:
the same numpy inputs through ``vipant_tpu.ops.quant`` and the Pallas int8
kernels, which run in interpret mode on the CPU, and through the port's
plain versions.

Tolerances. The quantizers on fp32 inputs are exact: codes and scales
equal. A sub-block differs only where a value lands within an fp32 ulp of a
rounding boundary in one framework and not the other (XLA's and PyTorch's
rsqrt, sigmoid, erf and exp differ in the last bit): a code then flips by
one, which moves an output by about scale * |w| ~ 1e-3 at these widths, and
in bf16 a value may round to the neighbouring bf16 first. So fp32 outputs
are held to atol = 5e-3 and bf16 outputs to atol = rtol = 3e-2 (one bf16
ulp of an O(1) output, 2e-2, plus a flipped code). In fp32, where every
rounding to the activations' type is a no-op, at most 1 % of the elements
may differ by more than 2e-5: apart from flips the two agree to fp32
rounding (measured here: max |d| 1e-6). In bf16 a last-bit difference in a
softmax probability can move a bf16 rounding and with it the codes of a
whole token, so no share is held there. Towers and engines (two layers)
are held to cosine >= 0.999 per embedding.

On a CUDA device the same ops launch the hand-written kernels:
test_torch_kernels_gpu.py holds them to these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vipant_tpu.nn.heads import VisionTower as JaxVisionTower
from vipant_tpu.ops import fused_attn as jax_fa
from vipant_tpu.ops import fused_mlp as jax_fm
from vipant_tpu.ops import quant as jax_quant
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.nn.heads import VisionTower, build_image_head
from vipant_tpu_torch.nn.layers import causal_mask
from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels, quant
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer

B, C, H, E = 3, 64, 4, 256
ATOL = {"float32": 5e-3, "bfloat16": 3e-2}
TINY = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
    "+running/audio=default", "worker=CLAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "model.text.width=64", "model.text.embed_dim=32",
    "model.text.encoder.layers=2", "model.text.heads=4", "running.audio.max_len=100",
    "model_file=", "eval=True",
]
FLAGSHIP_TINY = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "model.image.token_pack=4", "running.batch_size=4",
    "optimizer.warmup_epoch=0", "model_file=", "compute_dtype=float32",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_int8(monkeypatch):
    """The JAX modules dispatch to the int8 Pallas kernels on the TPU backend
    only: name the backend ``tpu`` and interpret the kernels, as
    tests/test_quant.py does."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        yield


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _close(got, want, dtype):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=ATOL[dtype] if dtype == "bfloat16" else 0)
    if dtype == "float32":  # apart from flipped codes: fp32 rounding
        assert (np.abs(got - want) > 2e-5).mean() <= 0.01


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 48), (64, 256), (3, 40, 64)])
def test_quantize_rows_equals_jax(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 3
    x[..., 1, :] = 0.0  # an all-zero row: scale 1e-12, codes 0
    q, s = quant.quantize_rows(t(x))
    jq, js = jax_quant.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (*shape[:-1], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[..., 1, :] == 0).all() and np.isfinite(s.numpy()).all()
    kq, ks = kernels.rowquant(t(x))  # the wrapper takes the plain version on the CPU
    assert torch.equal(kq, q) and torch.equal(ks, s)


@pytest.mark.parametrize("shape", [(37, 48), (64, 256)])
def test_quantize_cols_equals_jax(shape):
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32) * 0.1
    q, s = quant.quantize_cols(t(w))
    jq, js = jax_quant.quantize_cols(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.shape == (1, shape[1])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # a weight in the torch [out, in] layout: its rows are the output columns
    rq, rs = kernels.rowquant_plain(t(w.T))
    assert torch.equal(rq.t(), q) and torch.equal(rs.t(), s)


def test_round_is_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]])
    q, s = quant.quantize_rows(x)  # scale = 1 + 1e-12 = 1 in fp32
    assert s.item() == 1.0 and q.tolist() == [[127, 0, 2, 2, 0, -2, 126]]


def test_int_matmul_plain_is_exact_beyond_fp32():
    """K * 127^2 passes 2^24 at K = 3072: the product must be an integer one."""
    xq = torch.full((2, 3072), 127, dtype=torch.int8)
    wq = torch.full((3, 3072), -127, dtype=torch.int8)
    got = kernels.int_matmul_plain(xq, wq)
    assert got.dtype == torch.float32 and (got == float(np.float32(-3072 * 127 * 127))).all()


# ---------------------------------------------------------------------------
# the sub-blocks against the Pallas int8 kernels
# ---------------------------------------------------------------------------


def _mlp_params(T, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)
    p = dict(x=f(B, T, C, std=0.5), lns=1 + f(C, std=0.1), lnb=f(C, std=0.1),
             wfc=f(C, E, std=C ** -0.5), bfc=f(E, std=0.02),
             wproj=f(E, C, std=E ** -0.5), bproj=f(C, std=0.02))
    p["x"][0, 2] = 0.0  # an all-zero token
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("T", [40, 37])
def test_ln_mlp_block_int8_matches_pallas(T, act, dtype):
    p = _mlp_params(T, seed=T + len(act))
    want = jax_fm.fused_ln_mlp_block_int8(
        jnp.asarray(p["x"], getattr(jnp, dtype)),
        *(jnp.asarray(p[k]) for k in ("lns", "lnb", "wfc", "bfc", "wproj", "bproj")), act=act)
    got = fused_mlp.fused_ln_mlp_block_int8(
        t(p["x"]).to(getattr(torch, dtype)), t(p["lns"]), t(p["lnb"]), t(p["wfc"].T),
        t(p["bfc"]), t(p["wproj"].T), t(p["bproj"]), act=act)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, C)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


def _attn_params(T, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)
    p = dict(x=f(B, T, C, std=0.5), lns=1 + f(C, std=0.1), lnb=f(C, std=0.1),
             wqkv=f(C, 3, C, std=C ** -0.5), bqkv=f(3, C, std=0.02),
             wout=f(C, C, std=C ** -0.5), bout=f(C, std=0.02))
    p["x"][1, 3] = 0.0  # an all-zero token
    return p


def _segment_mask(T, seg):
    ids = np.arange(T) // seg
    return np.where(ids[:, None] == ids[None, :], 0.0, -1e30).astype(np.float32)


def _bias(kind, T):
    if kind == "none":
        return None
    causal = causal_mask(T).numpy()
    return causal if kind == "causal" else causal + _segment_mask(T, 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ln", [True, False], ids=["ln_residual", "bare"])
@pytest.mark.parametrize("kind", ["none", "causal", "causal_pack"])
@pytest.mark.parametrize("T", [40, 37])
def test_attention_block_int8_matches_pallas(T, kind, ln, dtype):
    p, bias = _attn_params(T, seed=T + len(kind)), _bias(kind, T)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else t(bias)
    jx, tx = jnp.asarray(p["x"], jdt), t(p["x"]).to(tdt)
    tw = (t(p["wqkv"].reshape(C, 3 * C).T), t(p["bqkv"].reshape(-1)), t(p["wout"].T), t(p["bout"]))
    jw = tuple(jnp.asarray(p[k]) for k in ("wqkv", "bqkv", "wout", "bout"))
    if ln:
        want = jax_fa.fused_ln_attention_block_int8(
            jx, jnp.asarray(p["lns"]), jnp.asarray(p["lnb"]), *jw, bias=jb, heads=H)
        got = fused_attn.fused_ln_attention_block_int8(
            tx, t(p["lns"]), t(p["lnb"]), *tw, bias=tb, heads=H)
    else:
        want = jax_fa.fused_attention_block_int8(jx, *jw, bias=jb, heads=H)
        got = fused_attn.fused_attention_block_int8(tx, *tw, bias=tb, heads=H)
    assert got.dtype == tdt and got.shape == (B, T, C)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("block", ["mlp", "ln_attention", "attention"])
def test_int8_blocks_are_forward_only(block):
    """A gradient through an int8 sub-block raises, as the JAX functions
    have no VJP (tests/test_quant.py::test_int8_fused_mlp_is_forward_only)."""
    if block == "mlp":
        p = _mlp_params(8, 0)
        args = [t(p["x"]), t(p["lns"]), t(p["lnb"]), t(p["wfc"].T), t(p["bfc"]),
                t(p["wproj"].T), t(p["bproj"])]
        fn = fused_mlp.fused_ln_mlp_block_int8
    else:
        p = _attn_params(8, 0)
        args = [t(p["x"])] + ([t(p["lns"]), t(p["lnb"])] if block == "ln_attention" else []) + [
            t(p["wqkv"].reshape(C, 3 * C).T), t(p["bqkv"].reshape(-1)), t(p["wout"].T), t(p["bout"])]
        fn = (fused_attn.fused_ln_attention_block_int8 if block == "ln_attention"
              else fused_attn.fused_attention_block_int8)
    kw = {} if block == "mlp" else {"heads": H}
    with torch.no_grad():
        assert torch.isfinite(fn(*args, **kw)).all()  # forward alone is fine
    args[3].requires_grad_()
    out = fn(*args, **kw)
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()


# ---------------------------------------------------------------------------
# the scope, the frozen tower, the engine, the trainer
# ---------------------------------------------------------------------------


def test_int8_scope_is_a_context_not_a_global():
    assert not quant.int8_fwd_enabled()
    with quant.int8_fwd_context():
        assert quant.int8_fwd_enabled()
        with quant.int8_fwd_context(False):
            assert not quant.int8_fwd_enabled()
        assert quant.int8_fwd_enabled()
    assert not quant.int8_fwd_enabled()
    with pytest.raises(KeyError):
        with quant.int8_fwd_context():
            raise KeyError("the scope closes on an exception too")
    assert not quant.int8_fwd_enabled()


def test_int8_engine_does_not_leak_into_a_bf16_engine():
    fb = np.random.default_rng(3).standard_normal((4, 100, 128)).astype(np.float32)
    bf16 = InferenceEngine(TINY, batch_size=4, device="cpu")
    int8 = InferenceEngine(TINY, batch_size=4, device="cpu", quantize="int8")
    before = bf16.embed_audio(fb)
    quantized = int8.embed_audio(fb)
    after = bf16.embed_audio(fb)
    assert not quant.int8_fwd_enabled()
    np.testing.assert_array_equal(before, after)  # bitwise the bf16 result
    assert not np.array_equal(before, quantized)  # and int8 really ran
    assert _cos(before, quantized).min() >= 0.99


def test_int8_frozen_tower_matches_jax(pallas_int8):
    kw = dict(width=64, embed_dim=32, resolution=64, heads=4, layers=2, patch_size=32)
    x = np.random.default_rng(8).standard_normal((4, 3, 64, 64)).astype(np.float32)
    jtower = JaxVisionTower(int8_frozen=True, token_pack=2, dtype=jnp.float32, **kw)
    variables = JaxVisionTower(dtype=jnp.float32, **kw).init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jtower.apply(variables, jnp.asarray(x)), np.float32)

    tower = VisionTower(int8_frozen=True, token_pack=2, **kw)
    tower.load_state_dict({k: t(np.asarray(v)) for k, v in
                           from_jax.tower_state_dict(variables["params"]).items()})
    with torch.no_grad():
        got = tower(t(x)).numpy()
        bf16 = VisionTower(token_pack=2, **kw)
        bf16.load_state_dict(tower.state_dict())
        ref = bf16(t(x)).numpy()
    assert _cos(got, want).min() >= 0.999, _cos(got, want)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert not np.array_equal(got, ref) and _cos(got, ref).min() > 0.99  # tests/test_quant.py:331


def test_int8_frozen_is_rejected_on_a_resnet_backbone():
    from vipant_tpu_torch.config import compose

    cfg = compose(["+model/image=rn50_val", "model.image.int8_frozen=True"])
    with pytest.raises(ValueError, match="int8_frozen"):
        build_image_head(cfg.model.image)


def test_int8_frozen_on_a_trainable_tower_raises_in_the_backward():
    kw = dict(width=64, embed_dim=32, resolution=64, heads=4, layers=1, patch_size=32)
    tower = VisionTower(int8_frozen=True, **kw)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32))
    out = tower(x)  # nothing is checked up front
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_engine_matches_jax(pallas_int8, dtype):
    cfg = TINY + [f"compute_dtype={dtype}"]
    jeng = JaxEngine(cfg, batch_size=4, quantize="int8")
    params = {k: v for k, v in jeng.variables["params"].items() if k in ("audio", "text", "loss")}
    eng = InferenceEngine(cfg, batch_size=4, device="cpu", quantize="int8")
    from_jax.load_params(eng.model, params)
    fb = np.random.default_rng(0).standard_normal((6, 100, 128)).astype(np.float32)
    texts = ["a dog barking", "heavy rain", "a car horn", "birds", "wind"]
    for got, want in ((eng.embed_audio(fb), jeng.embed_audio(fb)),
                      (eng.embed_texts(texts), jeng.embed_texts(texts))):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _cos(got, want).min() >= 0.999, _cos(got, want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    bf16 = InferenceEngine(cfg, batch_size=4, device="cpu")
    from_jax.load_params(bf16.model, params)
    assert _cos(eng.embed_audio(fb), bf16.embed_audio(fb)).min() >= 0.99


def test_trainer_step_with_int8_frozen_image_tower():
    tr = Trainer(FLAGSHIP_TINY + ["model.image.int8_frozen=True"], device="cpu")
    assert tr.model.image.int8_frozen and not tr.model.audio.int8_frozen
    ref = Trainer(FLAGSHIP_TINY, device="cpu")  # same seed: same init
    r = np.random.default_rng(0)
    batch = tr.make_batch(r.standard_normal((4, 3, 224, 224)).astype(np.float32),
                          r.standard_normal((4, 1, 100, 128)).astype(np.float32))
    frozen = {k: p.detach().clone() for k, p in tr.frozen.items()}
    moved = {k: p.detach().clone() for k, p in tr.trainable.items()}
    m, m_ref = tr.train_step(*batch), ref.train_step(*batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert any(k.startswith("image.") for k in frozen)
    for k, p in tr.frozen.items():
        assert torch.equal(p.detach(), frozen[k]) and p.grad is None, k
    assert any(not torch.equal(p.detach(), moved[k]) for k, p in tr.trainable.items())
    # the int8 image features move the loss a little, and only a little
    assert float(m["loss"]) != float(m_ref["loss"])
    assert abs(float(m["loss"]) - float(m_ref["loss"])) <= 5e-2 * abs(float(m_ref["loss"]))
