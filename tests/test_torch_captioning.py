"""The port's audio captioning (vipant_tpu_torch: cross-attention layers,
``SeqGenerationHead``, ``LMLossHead``, ``CLAP.forward_caption`` / ``decode``,
the captioning ``Trainer`` step and ``InferenceEngine.caption``) against the
JAX package on the tiny captioning config of tests/test_captioning.py (audio
tower width 64, 2 layers, 100 frames; decoder width 32, 4 heads, 2 layers,
``max_len_dec`` 8), both from one JAX init carried over by the bridge
(vipant_tpu_torch/ckpt/from_jax.py). The same numpy inputs go through both.

On the CPU the JAX modules run their XLA paths and the port the plain
versions of its kernels. Tolerances: fp32 module outputs and logits atol =
1e-4 (rtol 1e-4 on the loss), decoded ids equal, per-step decode logits atol
= 2e-4 (as tests/test_captioning.py holds the JAX decoders to each other);
training: loss and grad_norm rtol 1e-5, grads rtol 1e-3 with atol = 1e-3 *
max |grad|, updated params atol 1e-6 (tests/test_torch_train.py's bars). In
bf16 the XLA path adds biases in bf16 where the port follows the Pallas
kernels (fp32 bias before the rounding), so modules are held to atol = rtol
= 5e-2 on O(1) outputs and the step to rtol 2e-2 on the loss and cosine >=
0.99 per grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.config import compose
from vipant_tpu.models import build_main_model as jax_build, init_model
from vipant_tpu.models import tunable_mask as jax_tunable_mask
from vipant_tpu.nn import layers as jl
from vipant_tpu.nn.losses import LMLossHead as JaxLMLossHead
from vipant_tpu.nn.seqgen import SeqGenerationHead as JaxSeqGen
from vipant_tpu.nn.stages import ViTPostEncoder as JaxViTPost
from vipant_tpu.optim import build_optimizer as jax_build_optimizer
from vipant_tpu.optim.partition import merge_params, partition_params as jax_partition
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu.train import TrainState as JaxState, make_train_step
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.models import build_main_model, tunable_mask
from vipant_tpu_torch.nn import layers as tl
from vipant_tpu_torch.nn.heads import VisionTower
from vipant_tpu_torch.nn.losses import LMLossHead
from vipant_tpu_torch.nn.seqgen import SeqGenerationHead
from vipant_tpu_torch.nn.stages import ViTPostEncoder
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer, apply_gradients, loss_and_grads

CAPTION_TINY = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_decoder", "+model/loss=ce_lm", "+optimizer=standard",
    "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=100", "worker=CLAP", "model.image.width=64",
    "model.image.embed_dim=32", "model.image.encoder.layers=2", "model.image.heads=4",
    "model.text.width=32", "model.text.heads=4", "model.text.layers=2", "model.text.mem_width=64",
    "model.text.max_len_dec=8", "model.text.embed_dim=32", "running.retrieval=False",
    "model_file=",
]
B, STEPS, SPE = 4, 2, 10
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype, *extra):
    return compose(CAPTION_TINY + [f"compute_dtype={dtype}", "optimizer.warmup_epoch=0",
                                   f"running.batch_size={B}", *extra])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _f32(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.detach().float().numpy()


def _ids(rng, n, ctx=77, vocab=49408):
    """Token ids as the tokenizer lays them out: sot, words, eot, zero pad."""
    ids = np.zeros((n, ctx), np.int64)
    for row in ids:
        k = int(rng.integers(3, 12))
        row[0], row[1:1 + k], row[1 + k] = vocab - 2, rng.integers(1, vocab - 2, k), vocab - 1
    return ids


def _load_block(module, params, inside=None):
    """JAX params of one residual block (or, with ``inside``, of one of its
    sub-modules) into the port's module, through the decoder bridge."""
    tree = {"transformer": {"block_0": params if inside is None else {inside: params}}}
    prefix = "transformer.resblocks.0." + ("" if inside is None else inside + ".")
    sd = {k[len(prefix):]: torch.tensor(v)
          for k, v in from_jax.decoder_state_dict(_np(tree)).items()}
    module.load_state_dict(sd)
    return module


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 9, 32)).astype(np.float32)
    mem = r.standard_normal((2, 5, 32)).astype(np.float32)
    jm = jl.MultiHeadAttention(num_heads=4, dtype=_jdt(dtype), n_layers=2)
    jx, jmem = jnp.asarray(x, _jdt(dtype)), jnp.asarray(mem, _jdt(dtype))
    params = jm.init(jax.random.PRNGKey(0), jx, kv=jmem)["params"]
    params = jax.tree_util.tree_map(  # non-zero biases
        lambda a: a + 0.1 * jnp.asarray(r.standard_normal(a.shape), a.dtype), params)
    want = jm.apply({"params": params}, jx, kv=jmem)
    tm = _load_block(tl.MultiHeadAttention(32, 4, cross=True), params, inside="cross_attn")
    tx, tmem = torch.tensor(x, dtype=_tdt(dtype)), torch.tensor(mem, dtype=_tdt(dtype))
    np.testing.assert_allclose(_f32(tm(tx, kv=tmem)), _f32(want), **TOL[dtype])

    # decode: memory projected once (None values), then reused
    jout, jstate = jm.apply({"params": params}, jx[:, :1], kv=jmem,
                            decode_state={"k": None, "v": None})
    tout, tstate = tm(tx[:, :1], kv=tmem, decode_state={"k": None, "v": None})
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL[dtype])
    np.testing.assert_allclose(_f32(tstate["k"]), _f32(jstate["k"]), **TOL[dtype])
    tout2, _ = tm(tx[:, 1:2], kv=tmem, decode_state=tstate)
    jout2, _ = jm.apply({"params": params}, jx[:, 1:2], kv=jmem, decode_state=jstate)
    np.testing.assert_allclose(_f32(tout2), _f32(jout2), **TOL[dtype])
    with pytest.raises(ValueError, match="self-attention"):
        tm(tx, tl.LayerNorm(32), kv=tmem)
    with pytest.raises(ValueError, match="cross"):
        tm(tx)
    # q, k and v stay three weight leaves, as in the JAX tree: LARS scales each by its own ratio
    assert {n for n, _ in tm.named_parameters()} == {
        "q_proj_weight", "k_proj_weight", "v_proj_weight", "in_proj_bias", "out_proj.weight",
        "out_proj.bias"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_self_attention_decode_state_matches_jax(dtype):
    """Three cached positions: outputs, caches and ``pos`` of every step."""
    r = np.random.default_rng(1)
    L, H, D = 6, 4, 8
    x = r.standard_normal((2, 3, 32)).astype(np.float32)
    lns, lnb = (1 + 0.1 * r.standard_normal(32)).astype(np.float32), (0.1 * r.standard_normal(32)).astype(np.float32)
    jm = jl.MultiHeadAttention(num_heads=H, dtype=_jdt(dtype), n_layers=2)
    jx = jnp.asarray(x, _jdt(dtype))
    params = jm.init(jax.random.PRNGKey(1), jx)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(r.standard_normal(a.shape), a.dtype), params)
    tm = _load_block(tl.MultiHeadAttention(32, H), params, inside="attn")
    ln = tl.LayerNorm(32)
    ln.load_state_dict({"weight": torch.tensor(lns), "bias": torch.tensor(lnb)})
    jstate = {"k": jnp.zeros((2, L, H, D), _jdt(dtype)), "v": jnp.zeros((2, L, H, D), _jdt(dtype)),
              "pos": jnp.int32(0)}
    tstate = {"k": torch.zeros(2, L, H, D, dtype=_tdt(dtype)),
              "v": torch.zeros(2, L, H, D, dtype=_tdt(dtype)), "pos": 0}
    tx = torch.tensor(x, dtype=_tdt(dtype))
    for t in range(3):
        jout, jstate = jm.apply({"params": params}, jx[:, t:t + 1],
                                ln_residual=(jnp.asarray(lns), jnp.asarray(lnb)), decode_state=jstate)
        tout, tstate = tm(tx[:, t:t + 1], ln, decode_state=tstate)
        np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL[dtype])
        np.testing.assert_allclose(_f32(tstate["k"]), _f32(jstate["k"]), **TOL[dtype])
        np.testing.assert_allclose(_f32(tstate["v"]), _f32(jstate["v"]), **TOL[dtype])
        assert tstate["pos"] == int(jstate["pos"]) == t + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_block_matches_jax(dtype):
    """ResidualAttentionBlock(cross_attn): the causal fused self-attention,
    ln_c + cross-attention + residual, the fused MLP; forward and one
    decode position."""
    r = np.random.default_rng(2)
    T, S, C, H = 7, 5, 32, 4
    x = r.standard_normal((2, T, C)).astype(np.float32)
    mem = r.standard_normal((2, S, C)).astype(np.float32)
    jb = jl.ResidualAttentionBlock(num_heads=H, dtype=_jdt(dtype), cross_attn=True, n_layers=2)
    jx, jmem = jnp.asarray(x, _jdt(dtype)), jnp.asarray(mem, _jdt(dtype))
    params = jb.init(jax.random.PRNGKey(2), jx, jl.causal_mask(T), jmem)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(r.standard_normal(a.shape), a.dtype), params)
    want = jb.apply({"params": params}, jx, jl.causal_mask(T), jmem)
    tb = _load_block(tl.ResidualAttentionBlock(C, H, n_layers=2, cross_attn=True), params)
    tx, tmem = torch.tensor(x, dtype=_tdt(dtype)), torch.tensor(mem, dtype=_tdt(dtype))
    got = tb(tx, tl.causal_mask(T), tmem)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])

    L = 4
    jstate = {"self": {"k": jnp.zeros((2, L, H, C // H), _jdt(dtype)),
                       "v": jnp.zeros((2, L, H, C // H), _jdt(dtype)), "pos": jnp.int32(0)},
              "mem": {"k": None, "v": None}}
    tstate = {"self": {"k": torch.zeros(2, L, H, C // H, dtype=_tdt(dtype)),
                       "v": torch.zeros(2, L, H, C // H, dtype=_tdt(dtype)), "pos": 0},
              "mem": {"k": None, "v": None}}
    jout, _ = jb.apply({"params": params}, jx[:, :1], None, jmem, decode_state=jstate)
    tout, tnew = tb(tx[:, :1], None, tmem, decode_state=tstate)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL[dtype])
    # one position alone is the full forward's first row (causal)
    np.testing.assert_allclose(_f32(tout), _f32(got[:, :1]), **TOL[dtype])
    assert tnew["self"]["pos"] == 1 and tnew["mem"]["k"].shape == (2, S, H, C // H)
    with pytest.raises(ValueError, match="memory"):
        tb(tx)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_post_encoder_require_feature_matches_jax(dtype):
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 1 + 6, 16)).astype(np.float32)
    jm = JaxViTPost(width=16, embed_dim=8, dtype=_jdt(dtype))
    jx = jnp.asarray(x, _jdt(dtype))
    params = jm.init(jax.random.PRNGKey(3), jx)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(r.standard_normal(a.shape), a.dtype), params)
    tm = ViTPostEncoder(16, 8)
    tm.load_state_dict({k[len("post_encoder."):]: torch.tensor(v) for k, v in
                        from_jax.tower_state_dict(_np({"post": params})).items()})
    tx = torch.tensor(x, dtype=_tdt(dtype))
    jemb, jfeat = jm.apply({"params": params}, jx, require_feature=True, grid=(3, 2))
    emb, feat = tm(tx, require_feature=True, grid=(3, 2))
    assert feat.shape == (2, 3, 2, 16)
    np.testing.assert_allclose(_f32(emb), _f32(jemb), **TOL[dtype])
    np.testing.assert_allclose(_f32(feat), _f32(jfeat), **TOL[dtype])
    np.testing.assert_allclose(_f32(tm(tx)), _f32(jm.apply({"params": params}, jx)), **TOL[dtype])
    assert tm(tx, require_feature=True)[1].shape == (2, 6, 16)


def test_patchout_with_require_feature_raises_loudly():
    tower = VisionTower(width=16, embed_dim=8, resolution=(64, 64), heads=2, layers=1,
                        patch_size=32, patchout=0.5)
    with pytest.raises(ValueError, match="patchout"):
        tower(torch.zeros(1, 3, 64, 64), train=True, require_feature=True)
    # without require_feature, training with patchout runs (tests/test_torch_backbones.py)
    assert tower(torch.zeros(1, 3, 64, 64), train=True).shape == (1, 8)


@pytest.mark.parametrize("scaling", [True, False])
def test_lm_loss_head_matches_jax(scaling):
    """Pad targets ignored, an all-pad row, an all-pad batch (mean over 1)."""
    r = np.random.default_rng(4)
    logits = r.standard_normal((3, 6, 20)).astype(np.float32)
    targets = r.integers(1, 20, (3, 6))
    targets[0, 3:] = 0
    targets[1] = 0  # an all-pad row
    jm = JaxLMLossHead(scaling=scaling)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(targets))
    tm = LMLossHead(scaling=scaling)
    assert (tm.logit_scale is not None) == scaling == ("params" in params)
    if scaling:
        assert float(tm.logit_scale.detach()) == pytest.approx(float(params["params"]["logit_scale"]))
    for lg, tg in ((logits, targets), (logits.astype(np.float32), np.zeros_like(targets))):
        want = float(jm.apply(params, jnp.asarray(lg), jnp.asarray(tg)))
        got = float(tm(torch.tensor(lg), torch.tensor(tg)))
        assert np.isfinite(got) and got == pytest.approx(want, rel=1e-5, abs=1e-6)
    bf = float(tm(torch.tensor(logits).bfloat16(), torch.tensor(targets)))
    want = float(jm.apply(params, jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets)))
    assert bf == pytest.approx(want, rel=1e-5)  # fp32 log-softmax of the same bf16 logits


# ---------------------------------------------------------------------------
# SeqGenerationHead
# ---------------------------------------------------------------------------

V, L = 100, 7
HEAD = dict(width=32, layers=2, heads=4, ctx_len=16, vocab_size=V, embed_dim=32, mem_width=24,
            max_len_dec=L)


@pytest.fixture(scope="module", params=DTYPES)
def heads(request):
    """(dtype, JAX head, its variables, the port's head with the same
    weights, a feature grid [3, 3, 2, 24])."""
    dtype = request.param
    r = np.random.default_rng(5)
    feat = r.standard_normal((3, 3, 2, 24)).astype(np.float32)
    ids = r.integers(0, V, (3, 16))
    jh = JaxSeqGen(**HEAD, dtype=_jdt(dtype))
    variables = jh.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(feat))
    th = SeqGenerationHead(**HEAD, dtype=_tdt(dtype))
    sd = from_jax.decoder_state_dict(_np(variables["params"]))
    assert set(sd) == set(th.state_dict())
    th.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return dtype, jh, variables, th, feat, ids


def test_seqgen_forward_matches_jax(heads):
    dtype, jh, variables, th, feat, ids = heads
    jz, jlogits = jh.apply(variables, jnp.asarray(ids), jnp.asarray(feat), normalized=True)
    z, logits = th(torch.tensor(ids), torch.tensor(feat), normalized=True)
    assert logits.shape == (3, 15, V) and z.shape == (3, 32)
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), **TOL[dtype])
    np.testing.assert_allclose(_f32(z), _f32(jz), **TOL[dtype])
    jm = jh.apply(variables, jnp.asarray(feat), False, method="_memory")
    np.testing.assert_allclose(_f32(th._memory(torch.tensor(feat), time_first=False)), _f32(jm),
                               **TOL[dtype])


@pytest.mark.parametrize("method", ["greedy_decode", "greedy_decode_kv"])
def test_greedy_decoders_match_jax(heads, method):
    dtype, jh, variables, th, feat, _ = heads
    jids, jlogits = jh.apply(variables, jnp.asarray(feat), sot_token=1, method=method)
    ids, logits = getattr(th, method)(torch.tensor(feat), sot_token=1)
    assert ids.shape == (3, L + 1) and logits.shape == (3, L, V)
    if dtype == "float32":
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=2e-4, rtol=2e-4)
    else:  # bf16 logits tie and flip: the first step, which no earlier choice feeds
        np.testing.assert_allclose(_f32(logits[:, 0]), _f32(jlogits[:, 0]), **TOL[dtype])


def test_kv_cache_decode_matches_the_full_reforward(heads):
    dtype, _, _, th, feat, _ = heads
    ids_a, logits_a = th.greedy_decode(torch.tensor(feat), sot_token=1)
    ids_b, logits_b = th.greedy_decode_kv(torch.tensor(feat), sot_token=1)
    if dtype == "float32":
        np.testing.assert_array_equal(ids_a.numpy(), ids_b.numpy())
        np.testing.assert_allclose(_f32(logits_a), _f32(logits_b), atol=2e-4, rtol=2e-4)
    else:
        np.testing.assert_allclose(_f32(logits_a[:, 0]), _f32(logits_b[:, 0]), **TOL[dtype])


@pytest.mark.parametrize("beam,alpha", [(1, 0.0), (4, 0.0), (4, 0.6), (3, 1.0)])
def test_beam_decode_matches_jax(heads, beam, alpha):
    dtype, jh, variables, th, feat, _ = heads
    if dtype != "float32":  # bf16 logits tie and flip a beam: ids are compared in fp32
        ids, scores = th.beam_decode_kv(torch.tensor(feat), beam=beam, sot_token=1, eot_token=2,
                                        length_penalty=alpha)
        assert ids.shape == (3, L + 1) and bool((ids[:, 0] == 1).all())
        assert scores.shape == (3,) and bool(torch.isfinite(scores).all())
        return
    jids, jscores = jh.apply(variables, jnp.asarray(feat), beam=beam, sot_token=1, eot_token=2,
                             length_penalty=alpha, method="beam_decode_kv")
    ids, scores = th.beam_decode_kv(torch.tensor(feat), beam=beam, sot_token=1, eot_token=2,
                                    length_penalty=alpha)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-4, rtol=1e-4)
    if beam == 1:
        greedy, _ = th.greedy_decode_kv(torch.tensor(feat), sot_token=1)
        np.testing.assert_array_equal(ids.numpy(), greedy.numpy())


# ---------------------------------------------------------------------------
# the model, the training step, the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_init():
    cfg = _cfg("float32")
    return init_model(cfg, jax_build(cfg))["params"]


def test_build_and_bridge_cover_the_captioning_model(jax_init):
    cfg = _cfg("float32")
    model = build_main_model(cfg)
    assert model.text is None and model.loss is None and model.decoder is not None
    assert sorted(jax_init) == ["audio", "decoder", "lm_loss"]
    sd = from_jax.model_state_dict(_np(jax_init))
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(own[k].shape) == np.shape(v) for k, v in sd.items())
    with pytest.raises(KeyError, match="q, k and v"):
        partial = {"transformer": {"block_0": {"cross_attn": {"q": {"bias": np.zeros(4)}}}}}
        from_jax.decoder_state_dict(partial)


@pytest.mark.parametrize("extra", [
    [], ["model.audio.freeze=True"], ["model.text.freeze=False"],
    ["running.excl_modules.amodules=[pre_encoder,misc]", "running.excl_modules.lmodules=[transformer]"],
], ids=["default", "audio_frozen", "text_unfrozen", "excl_modules"])
def test_tunable_mask_matches_jax(jax_init, extra):
    """``model.text.freeze`` is true in transformer_decoder.yaml and does not
    freeze the decoder: the rule keys on the name ``decoder``."""
    cfg = _cfg("float32", *extra)
    want = from_jax.model_state_dict(jax_tunable_mask(cfg, jax_init), convert=False)
    got = tunable_mask(cfg, build_main_model(cfg))
    assert got == {k: bool(v) for k, v in want.items()}
    assert all(v for k, v in got.items() if k.startswith(("decoder.", "lm_loss.")))
    assert all(got[k] for k in got if k.startswith("audio.")) == (not extra or "text" in extra[0])


@pytest.fixture(scope="module", params=DTYPES)
def runs(request, jax_init):
    """Two captioning steps on the same batch in JAX and in the port from
    one init: (dtype, per-step JAX records, per-step port records, init,
    trainer)."""
    dtype = request.param
    cfg = _cfg(dtype)
    r = np.random.default_rng(0)
    audios = r.standard_normal((B, 1, 100, 128)).astype(np.float32)
    ids = _ids(r, B)

    model = jax_build(cfg)
    trainable, frozen = jax_partition(jax_init, jax_tunable_mask(cfg, jax_init))
    tx, _ = jax_build_optimizer(cfg.optimizer, steps_per_epoch=SPE)
    state = JaxState.create(trainable, tx, frozen_params=frozen)

    def adapter(model, variables, batch, rngs):  # tests/test_captioning.py's
        return model.apply(variables, *batch, retrieval=False, train=True, rngs=rngs)

    step = make_train_step(model, tx, loss_adapter=adapter, donate=False)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, f, a, t: model.apply(
        {"params": merge_params(p, f)}, a, t, retrieval=False, train=True)))
    want = []
    for _ in range(STEPS):
        _, grads = grad_fn(state.params, state.frozen_params, audios, ids)
        state, m = step(state, audios, ids)
        want.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         grads=from_jax.model_state_dict(_np(grads)),
                         params=from_jax.model_state_dict(_np(state.params))))

    tr = Trainer(cfg, device="cpu", steps_per_epoch=SPE)
    from_jax.load_params(tr.model, jax_init)
    init = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    batch = tr.make_batch(audios, ids)
    assert batch[1].dtype == torch.int64 and tr.state.loss_kwargs == {"retrieval": False}
    got = []
    for _ in range(STEPS):
        loss, grads = loss_and_grads(tr.state, *batch)
        m = {"loss": loss, **apply_gradients(tr.state, grads)}
        got.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        grads={k: g.float().numpy() for k, g in grads.items()},
                        params={k: p.detach().numpy().copy() for k, p in tr.trainable.items()}))
    return dtype, want, got, init, tr


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("i", range(STEPS))
def test_caption_loss_and_grad_norm_match_jax(runs, i):
    dtype, want, got, _, _ = runs
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got[i]["loss"] == pytest.approx(want[i]["loss"], rel=tol)
    assert got[i]["grad_norm"] == pytest.approx(want[i]["grad_norm"], rel=tol if i == 0 else 10 * tol)


@pytest.mark.parametrize("i", range(STEPS))
def test_every_caption_grad_matches_jax(runs, i):
    dtype, want, got, _, tr = runs
    assert sorted(got[i]["grads"]) == sorted(want[i]["grads"]) == sorted(tr.trainable)
    for k, w in want[i]["grads"].items():
        g = got[i]["grads"][k]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * np.abs(w).max(), err_msg=k)
        elif np.abs(w).max() > 0:
            assert _cos(g, w) >= 0.99, k
    # the loss does not reach text_proj: a zero grad, not a missing one
    assert not got[i]["grads"]["decoder.text_proj"].any()
    assert not want[i]["grads"]["decoder.text_proj"].any()


@pytest.mark.parametrize("i", range(STEPS))
def test_updated_caption_params_match_jax(runs, i):
    dtype, want, got, init, _ = runs
    for k, w in want[i]["params"].items():
        g, p0 = got[i]["params"][k], init[k].numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        if np.abs(w - p0).max() > 1e3 * np.spacing(np.abs(p0).max()):
            assert _cos(g - p0, w - p0) >= (0.999 if dtype == "float32" else 0.99), k


def test_everything_is_trainable_and_moves(runs):
    _, _, _, init, tr = runs
    assert not tr.frozen and set(tr.trainable) == set(init)
    moved = [k for k, p in tr.trainable.items() if not torch.equal(p.detach(), init[k])]
    assert any(k.startswith("audio.") for k in moved)
    assert any(k.startswith("decoder.transformer.resblocks.1.cross_attn.") for k in moved)
    assert "lm_loss.logit_scale" in moved
    assert tr.state.step == STEPS


def test_retrieval_flag_follows_the_jax_adapter():
    """``running.retrieval`` decides only when the model has a text tower."""
    tr = Trainer(_cfg("float32", "running.retrieval=True"), device="cpu")
    assert tr.state.loss_kwargs == {"retrieval": True}  # as the JAX adapter: the flag wins
    clap = [o for o in CAPTION_TINY if "transformer_decoder" not in o and "ce_lm" not in o
            and not o.startswith("model.text.")]
    tr = Trainer(compose(clap + ["+model/text=transformer_val", "+model/loss=ce",
                                 "model.text.width=32", "model.text.heads=4",
                                 "model.text.encoder.layers=2"]), device="cpu")
    assert tr.state.loss_kwargs == {"retrieval": True} and tr.model.decoder is None


def test_caption_overfits_four_clips_with_adam():
    """4 fixed (fbank, caption) pairs, Adam at lr 2e-3: the LM loss falls
    below 0.5x its start in 30 steps."""
    cfg = _cfg("float32", "optimizer.use_lars=False", "optimizer.warmup=False", "optimizer.lr=2.0e-3")
    tr = Trainer(cfg, device="cpu")
    r = np.random.default_rng(1)
    batch = tr.make_batch(r.standard_normal((B, 1, 100, 128)).astype(np.float32), _ids(r, B))
    losses = [float(tr.train_step(*batch)["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.5 * losses[0], losses


@pytest.fixture(scope="module", params=DTYPES)
def engines(request):
    dtype = request.param
    cfg = CAPTION_TINY + [f"compute_dtype={dtype}", "eval=True"]
    jeng = JaxEngine(cfg, batch_size=4)
    eng = InferenceEngine(cfg, batch_size=4, device="cpu")
    from_jax.load_params(eng.model, _np(jeng.variables["params"]))
    return dtype, jeng, eng


@pytest.mark.parametrize("beam", [0, 1, 3])
def test_engine_caption_matches_jax(engines, beam):
    """6 clips at batch 4: the last chunk is padded by repeating its last
    row and trimmed."""
    dtype, jeng, eng = engines
    fb = np.random.default_rng(2).standard_normal((6, 100, 128)).astype(np.float32)
    got = eng.caption(fb, beam=beam)
    assert len(got) == 6 and all(isinstance(c, str) for c in got)
    if dtype == "float32":
        assert got == jeng.caption(fb, beam=beam)
        assert got[:5] == eng.caption(fb[:5], beam=beam)  # padding does not leak into real rows
    if beam == 1:
        assert got == eng.caption(fb, beam=0)


def test_engine_decode_logits_match_jax(engines):
    dtype, jeng, eng = engines
    fb = np.random.default_rng(3).standard_normal((4, 1, 100, 128)).astype(np.float32)
    jids, jlogits = jeng.model.apply(jeng.variables, jnp.asarray(fb), method="decode")
    with torch.no_grad():
        ids, logits = eng.model.decode(torch.tensor(fb))
    if dtype == "float32":
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=2e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(_f32(logits[:, 0]), _f32(jlogits[:, 0]), **TOL[dtype])


def test_engine_caption_int8_and_refusals(engines):
    dtype, _, eng = engines
    cfg = CAPTION_TINY + [f"compute_dtype={dtype}"]
    eng8 = InferenceEngine(cfg, batch_size=2, device="cpu", quantize="int8")
    eng8.model.load_state_dict(eng.model.state_dict())
    fb = np.random.default_rng(4).standard_normal((2, 100, 128)).astype(np.float32)
    out = eng8.caption(fb)
    assert len(out) == 2 and all(isinstance(c, str) for c in out)
    assert eng.caption(np.zeros((0, 100, 128), np.float32)) == []
    retrieval = InferenceEngine(
        [o for o in CAPTION_TINY if "transformer_decoder" not in o and "ce_lm" not in o
         and not o.startswith("model.text.")]
        + ["+model/text=transformer_val", "+model/loss=ce", "model.text.width=32",
           "model.text.heads=4", "model.text.encoder.layers=2"], batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="captioning"):
        retrieval.caption(fb)
