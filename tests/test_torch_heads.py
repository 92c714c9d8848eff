"""The legacy head names of the port's config groups (``+model/image=vit``,
``+model/audio=vit``, ``+model/text=transformer``: ``ImageHead``,
``NaiveCLIPAudioHead``, ``TextHead``) build the same towers as the CLIP
heads, in the port as in the JAX package.

Both packages are built from the same overrides at a small size (2 layers,
width 64); the JAX params are carried across with ``ckpt/from_jax.py`` and
the port's embeddings are held to the JAX engine's in fp32 at the serve
parity tests' tolerance (max |d| <= 1e-4)."""

import numpy as np
import pytest

from vipant_tpu.serve import InferenceEngine as JaxEngine
from vipant_tpu_torch.ckpt import from_jax
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.models import build_main_model
from vipant_tpu_torch.serve import InferenceEngine

SMALL = [
    "+running=clotho", "+model/image=vit", "+model/audio=vit", "+model/loss=ce",
    "+optimizer=standard", "+running/audio=default",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "model.audio.width=64", "running.audio.max_len=100",
    "model_file=", "eval=True", "compute_dtype=float32",
]
CLAP = SMALL + ["+model/text=transformer", "worker=CLAP", "model.text.width=64",
                "model.text.heads=4", "model.text.encoder.layers=2"]
CVAP = SMALL + ["+model/text=dummy", "worker=CVAP"]
TEXTS = ["a dog barking", "heavy rain", "a car horn", "birds", "wind"]


def _fbanks(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 100, 128)).astype(np.float32)


@pytest.mark.parametrize("overrides,heads", [
    (CLAP, {"image": "ImageHead", "audio": "NaiveCLIPAudioHead", "text": "TextHead"}),
    (CVAP, {"image": "ImageHead", "audio": "NaiveCLIPAudioHead", "text": "DummyHead"}),
], ids=["CLAP", "CVAP"])
def test_legacy_groups_compose_and_build(overrides, heads):
    cfg = compose(overrides)
    assert {k: cfg.model[k].name for k in heads} == heads
    model = build_main_model(cfg)
    assert model is not None


def _port_engine(cfg, jeng):
    params = {k: v for k, v in jeng.variables["params"].items() if k in ("audio", "text", "loss")}
    eng = InferenceEngine(cfg, batch_size=4, device="cpu")
    from_jax.load_params(eng.model, params)
    return eng


def test_legacy_clap_embeddings_match_jax():
    jeng = JaxEngine(CLAP, batch_size=4)
    eng = _port_engine(CLAP, jeng)
    fb = _fbanks(5)
    for got, want in ((eng.embed_audio(fb), jeng.embed_audio(fb)),
                      (eng.embed_texts(TEXTS), jeng.embed_texts(TEXTS))):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_legacy_cvap_audio_embeddings_match_jax():
    jeng = JaxEngine(CVAP, batch_size=4)
    eng = _port_engine(CVAP, jeng)
    fb = _fbanks(6, seed=1)
    got, want = eng.embed_audio(fb), jeng.embed_audio(fb)
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
