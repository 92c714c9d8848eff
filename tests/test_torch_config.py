"""The port keeps its own copies of the config composer, the BPE tokenizer
and the registry (it imports nothing of the JAX package); they must stay
equal to the JAX package's on everything the port's tests and smoke run."""

import os

import numpy as np
import pytest

from vipant_tpu import config as jax_config
from vipant_tpu import tokenizer as jax_tokenizer
from vipant_tpu.utils import Registry as JaxRegistry
from vipant_tpu_torch import config, tokenizer
from vipant_tpu_torch.utils import Registry, as_config

CLAP = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
    "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=1000", "worker=CLAP", "model_file=",
]
FLAGSHIP = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=1000",
    "model.image.token_pack=4", "worker=CVAP", "model_file=", "model.image.int8_frozen=True",
]
TINY = CLAP[:7] + [
    "worker=CLAP", "model.image.width=64", "model.image.embed_dim=32",
    "model.image.encoder.layers=2", "model.image.heads=4", "model.text.width=64",
    "model.text.embed_dim=32", "model.text.encoder.layers=2", "model.text.heads=4",
    "running.audio.max_len=100", "model_file=", "eval=True", "compute_dtype=bfloat16",
]
PROMPTS = ["the sound of a dog barking", "heavy rain on a roof", "a car passing by",
           "birds singing in the morning", "people talking in a crowded room",
           "a dog barking", "rain falling", "the sound of a car", "", "Caf\u00e9 &amp; bar!!"]


@pytest.mark.parametrize("overrides", [CLAP, FLAGSHIP, TINY, []], ids=["clap", "flagship", "tiny", "default"])
def test_compose_equals_the_jax_package(overrides):
    got, want = config.compose(list(overrides)), jax_config.compose(list(overrides))
    assert got.to_dict(resolve=True) == want.to_dict(resolve=True)
    assert got.to_dict(resolve=False) == want.to_dict(resolve=False)
    # a config object of the JAX package is taken by the entry points as the port's own
    assert as_config(want).to_dict(resolve=True) == got.to_dict(resolve=True)
    assert isinstance(as_config(want), config.Config) and as_config(got) is got


def test_default_yaml_trees_are_the_same_files():
    def tree(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                if f.endswith(".yaml"):
                    path = os.path.join(d, f)
                    out[os.path.relpath(path, root)] = config.load_yaml(path)
        return out

    got, want = tree(config.DEFAULTS_DIR), tree(jax_config.DEFAULTS_DIR)
    assert config.DEFAULTS_DIR != jax_config.DEFAULTS_DIR and len(got) > 20
    assert got == want


@pytest.mark.parametrize("ctx", [77, 16])
def test_tokenize_equals_the_jax_package(ctx):
    got = tokenizer.tokenize(PROMPTS, context_length=ctx)
    want = jax_tokenizer.tokenize(PROMPTS, context_length=ctx)
    assert got.dtype == want.dtype and got.shape == (len(PROMPTS), ctx)
    np.testing.assert_array_equal(got, want)
    assert tokenizer.tokenize(PROMPTS[:3], as_list=True) == jax_tokenizer.tokenize(PROMPTS[:3], as_list=True)
    assert os.path.dirname(tokenizer._VOCAB_PATH) != os.path.dirname(jax_tokenizer._VOCAB_PATH)


def test_registry_behaves_as_the_jax_package_s():
    for cls in (Registry, JaxRegistry):
        reg = cls("THINGS")

        @reg.register()
        class A:
            pass

        reg.register(int, name="Int")
        assert reg.get("A") is A and reg.get("Int") is int and "A" in reg
        assert sorted(reg) == ["A", "Int"] and reg.name == "THINGS"
        with pytest.raises(KeyError):
            reg.get("missing")
        with pytest.raises(KeyError):
            reg.register(A)
