"""The port's attention sub-block (vipant_tpu_torch/ops/fused_attn.py)
against the JAX package's Pallas kernels, which run in interpret mode on
the CPU: the forward, and the grads of every input through the backward
kernel (``jax.vjp``). Same numpy inputs and cotangent through both; weights
and their grads converted between the JAX [C, 3, C] qkv layout and torch's
[3C, C].

Forward, fp32 inputs: atol = rtol = 2e-4, as tests/test_fused_attn.py holds
the Pallas kernel to its XLA reference. bf16 inputs: atol = rtol = 2e-2,
one bf16 ulp of an O(1) output plus a different fp32 summation order.
Grads, fp32: rtol = 5e-3 and atol = 5e-3 * max |ref| per grad, as
tests/test_fused_attn.py holds the Pallas backward. bf16: dx at atol = rtol
= 2e-2, each param grad within a relative Frobenius error of 2e-2 (the
param grads sum bf16 products over all rows).

On a CUDA device the same ops launch the hand-written kernels:
test_torch_kernels_gpu.py holds them to these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import fused_attn as jax_fa
from vipant_tpu_torch.nn.layers import causal_mask
from vipant_tpu_torch.ops import fused_attn, kernels

B, C, H = 3, 64, 4
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def grads_both(p, bias, dtype, ln, seed=0):
    """(port grads, JAX grads) of (x, [lns, lnb,] wqkv, bqkv, wout, bout)
    for one seeded cotangent, as fp32 numpy in torch layouts."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    T = p["x"].shape[1]
    g = np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)
    names = (("x", "lns", "lnb") if ln else ("x",)) + ("wqkv", "bqkv", "wout", "bout")
    jb = None if bias is None else jnp.asarray(bias)
    op = jax_fa.fused_ln_attention_block if ln else jax_fa.fused_attention_block
    jargs = [jnp.asarray(p[k], jdt if k == "x" else jnp.float32) for k in names]
    out, vjp = jax.vjp(lambda *a: op(*a, bias=jb, heads=H), *jargs)
    want = vjp(jnp.asarray(g, jdt))
    to_torch = {"wqkv": lambda a: a.reshape(C, 3 * C).T, "bqkv": lambda a: a.reshape(-1),
                "wout": lambda a: a.T}
    want = {k: to_torch.get(k, lambda a: a)(np.asarray(w.astype(jnp.float32)))
            for k, w in zip(names, want)}
    leaves = {k: torch.from_numpy(np.ascontiguousarray(to_torch.get(k, lambda a: a)(p[k])))
              for k in names}
    leaves["x"] = leaves["x"].to(tdt)
    leaves = {k: v.requires_grad_() for k, v in leaves.items()}
    tb = None if bias is None else torch.from_numpy(bias)
    top = fused_attn.fused_ln_attention_block if ln else fused_attn.fused_attention_block
    top(*leaves.values(), bias=tb, heads=H).backward(torch.from_numpy(g).to(tdt))
    got = {k: v.grad.float().numpy() for k, v in leaves.items()}
    assert leaves["x"].grad.dtype == tdt
    return got, want


def assert_grads_close(got, want, dtype):
    for k in want:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       atol=5e-3 * np.abs(want[k]).max(), err_msg=k)
        elif k == "x":
            np.testing.assert_allclose(got[k], want[k], atol=2e-2, rtol=2e-2, err_msg=k)
        else:
            rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            assert rel <= 2e-2, f"{k}: relative Frobenius error {rel:.3e}"


@pytest.mark.parametrize("ln", [True, False], ids=["ln_residual", "bare"])
@pytest.mark.parametrize("kind", ["none", "causal", "causal_pack"])
@pytest.mark.parametrize("T", [40, 37])
def test_attention_block_grads_match_pallas_fp32(T, kind, ln):
    got, want = grads_both(make(T, seed=T), make_bias(kind, T), "float32", ln, seed=T)
    assert_grads_close(got, want, "float32")


@pytest.mark.parametrize("kind", ["none", "causal", "causal_pack"])
@pytest.mark.parametrize("T", [40, 37])
def test_ln_attention_block_grads_match_pallas_bf16(T, kind):
    got, want = grads_both(make(T, seed=200 + T), make_bias(kind, T), "bfloat16", True, seed=T)
    assert_grads_close(got, want, "bfloat16")


def test_ln_attention_block_grads_match_pallas_saved_qkv():
    """T >= 128: the JAX forward stashes qkv and its backward kernel reads it
    (``_want_save_qkv``) instead of recomputing the projection."""
    T = 130
    assert jax_fa._want_save_qkv(B, T, C)
    got, want = grads_both(make(T, seed=7), make_bias("causal_pack", T), "float32", True)
    assert_grads_close(got, want, "float32")
