"""The port's serving slice (vipant_tpu_torch/serve.py) against the JAX
package's InferenceEngine on the tiny CLAP config of tests/test_serve.py.

The port's engine takes the JAX engine's weights through the bridge
(vipant_tpu_torch/ckpt/from_jax.py), either from the JAX params directly or
from a written ``model.npz``. On the CPU the JAX model runs its XLA path,
which adds biases in the compute dtype, while the port follows the Pallas
kernels' order (fp32 bias before rounding). So the parity is tight in
fp32 (max |d| <= 1e-4) and only within cosine >= 0.99 with the same
zero-shot predictions in bf16."""

import os

import numpy as np
import pytest

from vipant_tpu.ckpt.orbax_io import _flatten
from vipant_tpu.ckpt.reference_export import export_text_sd, export_visual_sd
from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.serve import InferenceEngine

TINY = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
    "+running/audio=default", "worker=CLAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "model.text.width=64", "model.text.embed_dim=32",
    "model.text.encoder.layers=2", "model.text.heads=4", "running.audio.max_len=100",
    "model_file=", "eval=True",
]
CVAP = [o for o in TINY if not o.startswith(("worker", "+model/text", "model.text"))] + [
    "+model/text=dummy", "worker=CVAP"]
CLASSES = {"dog": ["the sound of a dog", "a dog barking"], "rain": ["rain falling"],
           "car": ["a car passing by"]}
TEXTS = ["a dog barking", "heavy rain", "a car horn", "birds", "wind"]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines(request, tmp_path_factory):
    """(JAX engine, port engine loaded from JAX params, port engine loaded
    from model.npz), all at batch 4 with the default token_pack=4."""
    cfg = TINY + [f"compute_dtype={request.param}"]
    jeng = JaxEngine(cfg, batch_size=4)
    params = {k: v for k, v in jeng.variables["params"].items() if k in ("audio", "text", "loss")}
    direct = InferenceEngine(cfg, batch_size=4, device="cpu")
    from_jax.load_params(direct.model, params)
    root = tmp_path_factory.mktemp("export")
    os.makedirs(root / "run" / "step")
    np.savez(str(root / "run" / "step" / "model.npz"), **dict(_flatten("", params)))
    npz = InferenceEngine(
        [o for o in cfg if o != "model_file="]
        + [f"model_root={root}", "model_name=run", "model_file=step"], batch_size=4, device="cpu")
    return request.param, jeng, direct, npz


def _fbanks(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 100, 128)).astype(np.float32)


def _check(dtype, got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
        assert cos.min() >= 0.99, cos


@pytest.mark.parametrize("which", ["direct", "npz"])
def test_embed_audio_matches_jax(engines, which):
    dtype, jeng, direct, npz = engines
    eng = direct if which == "direct" else npz
    fb = _fbanks(6, 0)  # 6 = 4 + a ragged chunk of 2
    got = eng.embed_audio(fb)
    _check(dtype, got, jeng.embed_audio(fb))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-2)
    # padding does not leak into real rows: other chunking, same rows
    np.testing.assert_allclose(got[:5], eng.embed_audio(fb[:5]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["direct", "npz"])
def test_embed_texts_matches_jax(engines, which):
    dtype, jeng, direct, npz = engines
    eng = direct if which == "direct" else npz
    _check(dtype, eng.embed_texts(TEXTS, prompt="the sound of "),
           jeng.embed_texts(TEXTS, prompt="the sound of "))


def test_zero_shot_matches_jax(engines):
    dtype, jeng, direct, _ = engines
    fb = _fbanks(5, 1)
    got, want = direct.zero_shot(fb, CLASSES), jeng.zero_shot(fb, CLASSES)
    assert got["classes"] == want["classes"]
    assert got["prediction"] == want["prediction"]
    np.testing.assert_allclose(got["probs"].sum(1), 1.0, rtol=1e-5)
    atol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got["scores"], want["scores"], atol=atol, rtol=0)


@pytest.mark.parametrize("cfg,method,make", [
    (TINY, "embed_texts", lambda: TEXTS[:4]),
    (CVAP, "embed_images",
     lambda: np.random.default_rng(2).standard_normal((8, 3, 224, 224)).astype(np.float32)),
], ids=["text", "image"])
def test_token_pack_is_exact(cfg, method, make):
    """Packing k items per attention call behind the block-diagonal mask
    gives the unpacked tower's embeddings (fp32)."""
    cfg = cfg + ["compute_dtype=float32"]
    packed = InferenceEngine(cfg, batch_size=4, token_pack=4, device="cpu")
    plain = InferenceEngine(cfg, batch_size=4, token_pack=1, device="cpu")
    tower = packed.model.text if method == "embed_texts" else packed.model.image
    assert tower.token_pack == 4
    inputs = make()
    np.testing.assert_allclose(getattr(packed, method)(inputs), getattr(plain, method)(inputs),
                               atol=1e-5, rtol=0)


def test_bridge_matches_reference_export():
    """from_jax emits exactly the keys and values of the JAX package's
    reference exporter, and the port model holds every one of them."""
    jeng = JaxEngine(TINY, batch_size=4)
    params = jeng.variables["params"]
    for got, want in ((from_jax.tower_state_dict(params["audio"]), export_visual_sd(params["audio"])),
                      (from_jax.tower_state_dict(params["text"]), export_text_sd(params["text"]))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)
    model_keys = set(InferenceEngine(TINY, batch_size=4, device="cpu").model.state_dict())
    assert set(from_jax.model_state_dict(params)) == model_keys


def test_engine_rejects_what_is_not_ported():
    with pytest.raises(ValueError):
        InferenceEngine(TINY, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match=r"must equal the number of ranks \(1\)"):  # ported: needs 2 ranks
        InferenceEngine(TINY, model_parallel=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        InferenceEngine([o for o in TINY if o != "model_file="] + ["model_file=missing"],
                        device="cpu")
    eng = InferenceEngine(TINY, batch_size=4, device="cpu")
    assert eng.embed_audio(np.zeros((0, 100, 128), np.float32)).shape == (0, 32)
