"""The port's attention on separate q, k, v (vipant_tpu_torch/ops/attention.py)
against the JAX package's Pallas kernels (vipant_tpu/ops/attention.py), which
run in interpret mode on the CPU: the forward, the grads of q, k, v through
the backward kernel, and the bias grad. Same numpy inputs and cotangent
through both. On the CPU the port runs the kernels' plain versions; on a
CUDA device the same ops launch the hand-written kernels, which
test_torch_kernels_gpu.py holds to these plain versions there.

Tolerances. fp32: forward max |d| <= 2e-5 and grads <= 5e-4, as
tests/test_attention.py holds the Pallas kernel to XLA's attention. bf16:
atol = rtol = 2e-2 on outputs and grads (one bf16 ulp of an O(1) value plus
another fp32 summation order); the fp32 bias grad of bf16 inputs within
2e-2 * max |ref| (it sums products rounded to bf16 over all items and
heads). Unequal lengths, which the Pallas kernel does not take, are held to
``jax.nn.dot_product_attention``, what the JAX package computes there:
fp32 2e-5 forward and 5e-4 grads.

The probe functions of vipant_tpu_torch/experiments/fused_block_probe.py are
held to the Pallas kernels of experiments/fused_block_probe.py (imported by
path, interpret mode, B reduced to 2): the product in four orientations to
max |d| <= 1e-4 (fp32 sums of 128 bf16 products), the fused forward at atol
= rtol = 2e-2 on the bf16 output and 1e-3 on the fp32 logsumexp.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vipant_tpu.ops import attention as jax_attn
from vipant_tpu_torch.experiments import fused_block_probe as probe
from vipant_tpu_torch.nn.layers import causal_mask
from vipant_tpu_torch.ops import attention as attn
from vipant_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is fastest, and keeps
    this file from oversubscribing the cores when the suite runs in
    several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(B, Tq, Tk, H, D, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return f(B, Tq, H, D), f(B, Tk, H, D), f(B, Tk, H, D), f(B, Tq, H, D)


def make_bias(kind, T, seed=1):
    if kind == "none":
        return None
    if kind == "causal_inf":  # -inf above the diagonal: clamped on both sides
        return causal_mask(T).numpy()
    r = np.random.default_rng(seed)
    bias = (0.5 * r.standard_normal((T, T))).astype(np.float32)
    bias[r.random((T, T)) < 0.2] = -1e30
    bias[np.arange(T), np.arange(T)] = 0.0  # no row masked everywhere
    return bias


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def jax_run(q, k, v, g, bias, dtype, causal=False, bias_grad=True, reference=False):
    """(out, dq, dk, dv, dbias) of the JAX package: the Pallas kernels in
    interpret mode, or with ``reference`` ``jax.nn.dot_product_attention``."""
    dt = _jdt(dtype)
    args = [jnp.asarray(a, dt) for a in (q, k, v)]
    b = None if bias is None else jnp.asarray(bias)

    def fn(q, k, v, b):
        if reference:
            return jax.nn.dot_product_attention(q, k, v, bias=None if b is None else b[None, None])
        return jax_attn.flash_attention(q, k, v, bias=b, causal=causal, bias_grad=bias_grad)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *args, b)
        grads = vjp(jnp.asarray(g, dt))
    return [None if a is None else np.asarray(a, np.float32) for a in (out, *grads)]


def torch_run(q, k, v, g, bias, dtype, causal=False, bias_grad=True, views=None):
    dt = _tdt(dtype)
    q, k, v = (torch.tensor(a, dtype=dt, requires_grad=True) for a in (q, k, v))
    b = None if bias is None else torch.tensor(bias, requires_grad=True)
    qv, kv, vv = (q, k, v) if views is None else views(q, k, v)
    out = attn.flash_attention(qv, kv, vv, bias=b, causal=causal, bias_grad=bias_grad)
    leaves = [q, k, v] + ([] if b is None else [b])
    grads = list(torch.autograd.grad(out, leaves, torch.tensor(g, dtype=dt)))
    if b is None:
        grads.append(None)
    return [None if a is None else a.detach().float().numpy() for a in (out, *grads)]


def check(got, want, dtype, bias_rel=None):
    names = ("out", "dq", "dk", "dv", "dbias")
    for name, g, w in zip(names, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.shape == w.shape and np.isfinite(g).all(), name
        if name == "dbias" and dtype == "bfloat16":
            assert np.abs(g - w).max() <= 2e-2 * max(np.abs(w).max(), 1e-6), name
            continue
        tol = FWD_TOL[dtype] if name == "out" else GRAD_TOL[dtype]
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol if dtype == "bfloat16" else 0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,bias", [
    (77, 64, "none"), (77, 64, "random"), (77, 64, "causal_inf"), (130, 16, "random"),
    (50, 16, "none"), (33, 64, "random"),
], ids=lambda v: str(v))
def test_flash_attention_matches_pallas(dtype, T, D, bias):
    """Forward, dq, dk, dv and the bias grad, ragged T included."""
    q, k, v, g = make(2, T, T, 2, D)
    b = make_bias(bias, T)
    check(torch_run(q, k, v, g, b, dtype), jax_run(q, k, v, g, b, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["causal", "causal+bias"])
def test_causal_flag_matches_pallas(dtype, with_bias):
    q, k, v, g = make(2, 40, 40, 2, 16, seed=2)
    b = make_bias("random", 40) if with_bias else None
    check(torch_run(q, k, v, g, b, dtype, causal=True), jax_run(q, k, v, g, b, dtype, causal=True),
          dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_grad_off_gives_zeros_and_the_same_grads(dtype):
    q, k, v, g = make(2, 40, 40, 2, 16, seed=3)
    b = make_bias("random", 40)
    got = torch_run(q, k, v, g, b, dtype, bias_grad=False)
    check(got, jax_run(q, k, v, g, b, dtype, bias_grad=False), dtype)
    assert not got[4].any()
    on = torch_run(q, k, v, g, b, dtype, bias_grad=True)
    assert on[4].any()
    for a, c in zip(got[:4], on[:4]):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", ["none", "random"])
def test_flash_attention_matches_the_4d_pallas_kernels(monkeypatch, dtype, bias):
    """``VIPANT_ATTN=4d`` sends the JAX op to ``_attend4`` ([B, T, H, D]
    blocks, always with the bias grad): the port's one kernel covers it."""
    monkeypatch.setenv("VIPANT_ATTN", "4d")
    q, k, v, g = make(2, 64, 64, 2, 64, seed=4)
    b = make_bias(bias, 64)
    check(torch_run(q, k, v, g, b, dtype), jax_run(q, k, v, g, b, dtype), dtype)


@pytest.mark.parametrize("Tq,Tk", [(77, 61), (32, 61), (1, 9), (70, 130)])
def test_unequal_lengths_match_xla_attention(Tq, Tk):
    """Cross-attention shapes: the JAX package computes these with
    ``jax.nn.dot_product_attention`` (its Pallas kernel needs Tq = Tk)."""
    q, k, v, g = make(2, Tq, Tk, 2, 16, seed=5)
    r = np.random.default_rng(6)
    b = (0.5 * r.standard_normal((Tq, Tk))).astype(np.float32)
    for bias in (None, b):
        check(torch_run(q, k, v, g, bias, "float32"),
              jax_run(q, k, v, g, bias, "float32", reference=True), "float32")


@pytest.mark.parametrize("layout", ["packed", "transposed"])
def test_strided_views_give_the_contiguous_result(layout):
    """Sections of a packed [B, T, 3C] projection and [B, H, T, D] views."""
    B, T, H, D = 2, 20, 2, 16
    q, k, v, g = make(B, T, T, H, D, seed=7)

    def views(q, k, v):
        if layout == "packed":
            return torch.stack((q, k, v), dim=2).reshape(B, T, 3 * H * D).view(B, T, 3, H, D).unbind(2)
        return tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))

    want = torch_run(q, k, v, g, None, "float32")
    got = torch_run(q, k, v, g, None, "float32", views=views)
    for a, c in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, c)


def test_dispatcher_defaults_and_refusals():
    q, k, v, g = make(1, 12, 12, 2, 16, seed=8)
    b = make_bias("random", 12)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tb = torch.tensor(b, requires_grad=True)
    # attention(): bias_grad=False by default, [1, 1, T, T] biases squeezed
    out = attn.attention(tq.requires_grad_(), tk, tv, bias=tb[None, None])
    (db,) = torch.autograd.grad(out.sum(), [tb], allow_unused=True)
    assert db is not None and not db.any()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  attn.flash_attention(tq, tk, tv, bias=tb).detach().numpy())
    (db,) = torch.autograd.grad(attn.flash_attention(tq, tk, tv, bias=tb).sum(), [tb])
    assert db.any()  # flash_attention(): bias_grad=True by default
    with pytest.raises(ValueError, match="boolean"):
        attn.attention(tq, tk, tv, mask=torch.ones(12, 12, dtype=torch.bool))
    with pytest.raises(ValueError, match="bias"):
        attn.attention(tq, tk, tv, bias=torch.zeros(2, 12, 12))
    with pytest.raises(ValueError, match="causal"):
        attn.flash_attention(tq, tk[:, :5], tv[:, :5], causal=True)


def test_a_row_masked_everywhere_is_uniform_not_nan():
    """The -1e30 clamp: a fully masked row attends uniformly (the XLA path
    of the JAX package, which does not clamp, gives NaN there)."""
    q, k, v, _ = make(1, 6, 6, 1, 16, seed=9)
    bias = np.zeros((6, 6), np.float32)
    bias[2] = -np.inf
    out = attn.flash_attention(*(torch.tensor(a) for a in (q, k, v)), bias=torch.tensor(bias))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, 2, 0].numpy(), v[0, :, 0].mean(0), atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), bias=jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Tq,Tk,bias", [(9, 9, True), (7, 11, True), (7, 11, False)])
def test_plain_backward_gradcheck_float64(Tq, Tk, bias):
    """The plain backward chain (lse recompute, delta from o, separate bias
    grad) is the true gradient of the plain forward: float64, where every
    rounding to the activations' dtype is a no-op."""
    r = np.random.default_rng(10)
    t = lambda *s: torch.tensor(r.standard_normal(s), dtype=torch.float64, requires_grad=True)
    q, k, v = t(2, Tq, 2, 8), t(2, Tk, 2, 8), t(2, Tk, 2, 8)
    args = (q, k, v) + ((t(Tq, Tk),) if bias else ())
    fn = lambda q, k, v, b=None: attn.flash_attention(q, k, v, bias=b)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_fused_block_probe", os.path.join(ROOT, "experiments", "fused_block_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_dot_variants_match_the_pallas_probe(jax_probe):
    report = jax_probe.probe_dot_variants(True)
    assert all(v.startswith("ok") for v in report.values()), report
    dims = {"NN": ((1,), (0,)), "NT": ((1,), (1,)), "TN": ((0,), (0,)), "TT": ((0,), (1,))}
    assert probe.probe_dot_variants("cpu") == {k: 0.0 for k in dims}  # on the CPU: the plain version
    for name, d in dims.items():
        a, b = probe.dot_variant_inputs(name)
        got = kernels.dot_variant(a, b, name).numpy()
        assert got.shape == (256, 384) and got.dtype == np.float32
        ja, jb = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (a, b))
        want = jax.lax.dot_general(ja, jb, (d, ((), ())), preferred_element_type=jnp.float32)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0, err_msg=name)
    with pytest.raises(ValueError):
        kernels.dot_variant(a, b, "XX")


def test_probe_fused_fwd_matches_the_pallas_probe(jax_probe):
    Bs = 2
    x, wqkv, bqkv, wout, bout = jax_probe.make_inputs()
    out, lse = jax_probe.fused_fwd(x[:Bs], wqkv, bqkv, wout, bout, interpret=True)
    got, got_lse = probe.probe_fused_fwd(*probe.make_inputs(batch=Bs))
    assert got.dtype == torch.bfloat16 and got_lse.shape == (Bs, probe.H, probe.T)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-3, rtol=1e-3)
    # the same function as the fused sub-block without LN and residual
    from vipant_tpu_torch.ops.fused_attn import fused_attention_block

    block = fused_attention_block(*probe.make_inputs(batch=Bs), heads=probe.H)
    np.testing.assert_allclose(got.float().numpy(), block.float().numpy(), atol=2e-2, rtol=2e-2)
