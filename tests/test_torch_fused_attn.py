"""The port's attention sub-block (vipant_tpu_torch/ops/fused_attn.py)
against the JAX package's Pallas kernel, which runs in interpret mode on
the CPU. Same numpy inputs through both; weights converted from the JAX
[C, 3, C] qkv layout to torch's [3C, C].

fp32 inputs: atol = rtol = 2e-4, as tests/test_fused_attn.py holds the
Pallas kernel to its XLA reference. bf16 inputs: atol = rtol = 2e-2, one
bf16 ulp of an O(1) output plus a different fp32 summation order.

On a CUDA device the same ops launch the hand-written kernels:
test_torch_kernels_gpu.py holds them to these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import fused_attn as jax_fa
from vipant_tpu_torch.nn.layers import causal_mask
from vipant_tpu_torch.ops import fused_attn, kernels

B, C, H = 3, 64, 4
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def segment_mask(T, seg):
    """Additive block-diagonal [T, T] mask (-1e30 across segments of length
    ``seg``, the last one ragged): token packing's bias."""
    ids = np.arange(T) // seg
    return np.where(ids[:, None] == ids[None, :], 0.0, -1e30).astype(np.float32)


def make_bias(kind, T):
    if kind == "none":
        return None
    causal = causal_mask(T).numpy()
    return causal if kind == "causal" else causal + segment_mask(T, 10)


def make(T, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)
    return dict(
        x=f(B, T, C, std=0.5), lns=1 + f(C, std=0.1), lnb=f(C, std=0.1),
        wqkv=f(C, 3, C, std=C ** -0.5), bqkv=f(3, C, std=0.02),
        wout=f(C, C, std=C ** -0.5), bout=f(C, std=0.02),
    )


def run_both(p, bias, dtype, ln):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    jx = jnp.asarray(p["x"], jdt)
    tx = torch.from_numpy(p["x"]).to(tdt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tw = (t(p["wqkv"].reshape(C, 3 * C).T), t(p["bqkv"].reshape(-1)), t(p["wout"].T), t(p["bout"]))
    jw = tuple(jnp.asarray(p[k]) for k in ("wqkv", "bqkv", "wout", "bout"))
    if ln:
        want = jax_fa.fused_ln_attention_block(
            jx, jnp.asarray(p["lns"]), jnp.asarray(p["lnb"]), *jw, bias=jb, heads=H)
        got = fused_attn.fused_ln_attention_block(
            tx, t(p["lns"]), t(p["lnb"]), *tw, bias=tb, heads=H)
    else:
        want = jax_fa.fused_attention_block(jx, *jw, bias=jb, heads=H)
        got = fused_attn.fused_attention_block(tx, *tw, bias=tb, heads=H)
    assert got.dtype == tdt and got.shape == (B, p["x"].shape[1], C)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("ln", [True, False], ids=["ln_residual", "bare"])
@pytest.mark.parametrize("kind", ["none", "causal", "causal_pack"])
@pytest.mark.parametrize("T", [40, 37])
def test_attention_block_matches_pallas_fp32(T, kind, ln):
    p = make(T, seed=T)
    got, want = run_both(p, make_bias(kind, T), "float32", ln)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("kind", ["none", "causal", "causal_pack"])
@pytest.mark.parametrize("T", [40, 37])
def test_ln_attention_block_matches_pallas_bf16(T, kind):
    p = make(T, seed=100 + T)
    got, want = run_both(p, make_bias(kind, T), "bfloat16", ln=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def test_canon_bias_keeps_causal_plus_pack_finite():
    """-inf (causal) + -1e30 (pack) is -inf; clamped to -1e30 no softmax row
    becomes NaN, and the masked probabilities are exactly 0."""
    T = 40
    bias = torch.from_numpy(make_bias("causal_pack", T))
    assert torch.isinf(bias).any()
    cb = fused_attn.canon_bias(bias)
    assert cb.dtype == torch.float32 and torch.isfinite(cb).all() and cb.min() == -1e30
    qkv = torch.randn(2, T, 3 * C, generator=torch.Generator().manual_seed(0))
    o = kernels.attention_plain(qkv, cb, H, 0.25)
    assert torch.isfinite(o).all()
    # query 0 of each segment attends only to itself: its output is its own v
    for s in range(0, T, 10):
        torch.testing.assert_close(o[:, s], qkv[:, s, 2 * C:], rtol=0, atol=1e-6)


def test_backward_raises_until_the_training_kernels_land():
    p = make(40)
    x = torch.from_numpy(p["x"]).requires_grad_()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = fused_attn.fused_ln_attention_block(
        x, t(p["lns"]), t(p["lnb"]), t(p["wqkv"].reshape(C, -1).T), t(p["bqkv"].reshape(-1)),
        t(p["wout"].T), t(p["bout"]), heads=H)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        out.sum().backward()
