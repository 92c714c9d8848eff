"""The port's MLP sub-block (vipant_tpu_torch/ops/fused_mlp.py) against the
JAX package's Pallas kernels in interpret mode on the CPU, both activations:
the forward, and the grads of every input through the backward kernel
(``jax.vjp``). Same numpy inputs and cotangent; dense kernels and their
grads converted between [in, out] and torch's [out, in]. Tolerances as in
test_torch_fused_attn.py: forward 2e-4 for fp32 inputs, 2e-2 (one bf16 ulp
plus summation order) for bf16; grads rtol = 5e-3, atol = 5e-3 * max |ref|
in fp32, and in bf16 dx at atol = rtol = 2e-2 and each param grad within a
relative Frobenius error of 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import fused_mlp as jax_fm
from vipant_tpu_torch.ops import fused_mlp, kernels

B, C, E = 3, 64, 256
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


def make(T, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)
    return dict(
        x=f(B, T, C, std=0.5), lns=1 + f(C, std=0.1), lnb=f(C, std=0.1),
        wfc=f(C, E, std=C ** -0.5), bfc=f(E, std=0.02),
        wproj=f(E, C, std=E ** -0.5), bproj=f(C, std=0.02),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("T", [40, 37])
def test_ln_mlp_block_matches_pallas(T, act, dtype):
    p = make(T, seed=T + len(act))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = jax_fm.fused_ln_mlp_block(
        jnp.asarray(p["x"], getattr(jnp, dtype)),
        *(jnp.asarray(p[k]) for k in ("lns", "lnb", "wfc", "bfc", "wproj", "bproj")), act=act)
    got = fused_mlp.fused_ln_mlp_block(
        t(p["x"]).to(getattr(torch, dtype)), t(p["lns"]), t(p["lnb"]), t(p["wfc"].T),
        t(p["bfc"]), t(p["wproj"].T), t(p["bproj"]), act=act)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, C)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("T", [40, 37])
def test_ln_mlp_block_grads_match_pallas(T, act, dtype):
    p = make(T, seed=300 + T + len(act))
    names = ("x", "lns", "lnb", "wfc", "bfc", "wproj", "bproj")
    g = np.random.default_rng(T).standard_normal((B, T, C)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(p[k], jdt if k == "x" else jnp.float32) for k in names]
    _, vjp = jax.vjp(lambda *a: jax_fm.fused_ln_mlp_block(*a, act=act), *jargs)
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]
    want = [w.T if k in ("wfc", "wproj") else w for k, w in zip(names, want)]
    leaves = [torch.from_numpy(np.ascontiguousarray(p[k].T if k in ("wfc", "wproj") else p[k]))
              for k in names]
    leaves[0] = leaves[0].to(tdt)
    leaves = [t.requires_grad_() for t in leaves]
    fused_mlp.fused_ln_mlp_block(*leaves, act=act).backward(torch.from_numpy(g).to(tdt))
    assert leaves[0].grad.dtype == tdt
    for k, leaf, w in zip(names, leaves, want):
        got = leaf.grad.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, w, rtol=5e-3, atol=5e-3 * np.abs(w).max(), err_msg=k)
        elif k == "x":
            np.testing.assert_allclose(got, w, atol=2e-2, rtol=2e-2, err_msg=k)
        else:
            rel = np.linalg.norm(got - w) / np.linalg.norm(w)
            assert rel <= 2e-2, f"{k}: relative Frobenius error {rel:.3e}"


def test_activations_match_their_definitions():
    a = torch.linspace(-6, 6, 101, dtype=torch.float64)
    torch.testing.assert_close(kernels.act_plain(a, "quick_gelu"), a * torch.sigmoid(1.702 * a))
    torch.testing.assert_close(kernels.act_plain(a, "gelu"),
                               torch.nn.functional.gelu(a, approximate="none"))
    for act in ("quick_gelu", "gelu"):
        want, = torch.autograd.grad(kernels.act_plain(a.requires_grad_(), act).sum(), a)
        torch.testing.assert_close(kernels.act_grad_plain(a.detach(), act), want)
    with pytest.raises(ValueError, match="activation"):
        fused_mlp.fused_ln_mlp_block_plain(
            torch.zeros(1, 2, C), torch.ones(C), torch.zeros(C), torch.zeros(E, C),
            torch.zeros(E), torch.zeros(C, E), torch.zeros(C), act="relu")
