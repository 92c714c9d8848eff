"""The hand-written CUDA kernels (vipant_tpu_torch/csrc) against their plain
PyTorch versions on the card, at the serving path's shapes. Every test here
needs a CUDA device and skips without one. This file imports no JAX, so it
runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest

Tolerance: atol = rtol = 2e-2 on bf16 outputs, one bf16 ulp of the output
plus a different fp32 summation order."""

from unittest import mock

import numpy as np
import pytest
import torch

from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
from vipant_tpu_torch.ops import LAUNCHES, fused_attn, fused_mlp, kernels, reset_launches
from vipant_tpu_torch.serve import InferenceEngine

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


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
