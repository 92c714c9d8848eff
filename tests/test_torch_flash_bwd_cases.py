"""The plans of the flash-attention backward and bias grad
(``kernels.flash_bwd_plan``, ``kernels.dbias_split``), the bias grad summed
in the kernel's order (``kernels.flash_attention_dbias_ordered``), and the
shapes ``chip_smoke.py`` holds the kernels to on the card
(``FLASH_CASES``), checked on the CPU.

- ``flash_bwd_plan`` puts every query row in one dq block and every key in
  one dk, dv block of whole 16-row warps, at every case and at any length
  from 1 to 1100;
- ``dbias_split`` puts every (item, head) pair in one chunk, none empty, and
  gives the bias grad at least one block on every SM at the two shapes with
  a bias;
- ``flash_attention_dbias_ordered`` is within fp32 rounding of the exact
  (float64) sum of the same terms, as the plain version is: per entry
  |sum - exact| <= n * 2^-24 * sum |terms| for n = B * H terms, and the two
  within twice that of each other, at small sizes of each bias kind;
- on the CPU ``flash_attention_bwd`` and ``flash_attention_dbias`` return
  their plain versions bitwise and launch nothing, at every case (B and H
  cut to 2, Tq, Tk and the bias as the case has them);
- the grads of the public ``flash_attention`` at the captioning decoder's
  cross shape (Tq 77, Tk 61, head dim 64; two items, two heads) match the
  JAX package's ``jax.nn.dot_product_attention`` (what it computes for
  unequal lengths) from the same numpy inputs: fp32 forward max |d| <= 2e-5
  and grads <= 5e-4, the tolerances of tests/test_torch_attention.py.

The kernels themselves run only on a CUDA device
(tests/test_torch_kernels_gpu.py)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
from vipant_tpu_torch.ops import LAUNCHES, attention, kernels, reset_launches

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo root's smoke script: its case lists)

FLASH_CASES = chip_smoke.FLASH_CASES
IDS = [c[0] for c in FLASH_CASES]
U = 2.0 ** -24  # the fp32 unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    oversubscribing the cores when the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_cover(tiles, rows, T, most):
    assert tiles >= 1 and rows % 16 == 0 and 16 <= rows <= most
    assert (tiles - 1) * rows < T <= tiles * rows  # every row in one block, no block empty


def _check_plan(Tq, Tk):
    plan = kernels.flash_bwd_plan(Tq, Tk)
    _check_cover(plan.q_tiles, plan.q_rows, Tq, kernels.FLASH_MAX_Q)
    _check_cover(plan.k_tiles, plan.k_rows, Tk, kernels.FLASH_BWD_MAX_K)
    if Tk <= 64:
        assert plan.q_rows <= kernels.FLASH_ONE_TILE_Q
    assert kernels.flash_bwd_plan(Tq, Tk) == plan  # a function of the shapes alone
    return plan


@pytest.mark.parametrize("case,B,Tq,Tk,H,kind", FLASH_CASES, ids=IDS)
def test_flash_bwd_plan_covers_every_row_and_key_once(case, B, Tq, Tk, H, kind):
    plan = _check_plan(Tq, Tk)
    if (Tq, Tk) == (77, 61):  # the captioning step's cross-attention: one block of 5 warps a head each way
        assert plan == (1, 80, 1, 64)


def test_flash_bwd_plan_covers_any_length():
    for T in range(1, 1101):
        for other in (1, 61, 64, 65, 971):
            _check_plan(T, other)
            _check_plan(other, T)


def _check_split(BH, Tq, Tk):
    chunks, per = kernels.dbias_split(BH, Tq, Tk)
    assert chunks >= 1 and per >= 1
    assert (chunks - 1) * per < BH <= chunks * per  # every pair in one chunk, none empty
    covered = [bh for c in range(chunks) for bh in range(c * per, min(c * per + per, BH))]
    assert covered == list(range(BH))
    return chunks, per


@pytest.mark.parametrize("case,B,Tq,Tk,H,kind", FLASH_CASES, ids=IDS)
def test_dbias_split_covers_the_heads_once_and_fills_the_card(case, B, Tq, Tk, H, kind):
    chunks, _ = _check_split(B * H, Tq, Tk)
    blocks = -(-Tq // kernels.FLASH_TILE) * -(-Tk // kernels.FLASH_TILE) * chunks
    if kind is not None:  # the shapes whose bias grad a path takes
        assert blocks >= kernels.SM_COUNT, f"{case}: {blocks} blocks for {kernels.SM_COUNT} SMs"


def test_dbias_split_covers_any_head_count():
    for BH in (1, 2, 3, 7, 16, 96, 192, 513, 4096):
        for Tq, Tk in ((1, 1), (77, 61), (77, 77), (200, 200), (971, 971)):
            _check_split(BH, Tq, Tk)


def _bias(kind, Tq, Tk, rng):
    """The CPU twin of ``chip_smoke.flash_bias``, and a random bias with
    some entries masked"""
    if kind is None:
        return None
    if kind == "causal":
        return torch.clamp(causal_mask(Tq), min=-1e30).contiguous()
    if kind == "pack":
        return pack_tokens(torch.zeros(4, Tq // 4, 1), 4)[1]
    b = torch.tensor(0.5 * rng.standard_normal((Tq, Tk)), dtype=torch.float32)
    b[torch.tensor(rng.random((Tq, Tk)) < 0.2)] = -1e30
    b[:, 0] = 0.0  # no row masked everywhere
    return b


def _inputs(B, Tq, Tk, H, kind, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, 64)), dtype=torch.float32).to(dtype)
                   for T in (Tq, Tk, Tk, Tq))
    return q, k, v, do, _bias(kind, Tq, Tk, rng)


@pytest.mark.parametrize("kind,T", [("pack", 40), ("causal", 33), ("random", 29)])
def test_dbias_ordered_is_within_fp32_rounding_of_the_exact_sum(kind, T):
    B, H = 3, 5
    q, k, v, do, bias = _inputs(B, T, T, H, kind, seed=11)
    o, lse = kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)
    delta = kernels.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, 0.125)[3]
    ordered = kernels.flash_attention_dbias_ordered(q, k, v, bias, lse, delta, do, 0.125)
    plain = kernels.flash_attention_dbias_plain(q, k, v, bias, lse, delta, do, 0.125)
    terms = kernels._flash_ds_raw(q, k, v, bias, lse, delta, do, 0.125)[1].double()
    exact, mag = terms.sum(dim=(0, 1)), terms.abs().sum(dim=(0, 1))
    n = B * H
    assert ordered.dtype == plain.dtype == torch.float32 and ordered.shape == (T, T)
    assert bool(((ordered.double() - exact).abs() <= n * U * mag).all())
    assert bool(((plain.double() - exact).abs() <= n * U * mag).all())
    assert bool(((ordered - plain).double().abs() <= 2 * n * U * mag).all())
    assert bool(ordered.any())


def test_dbias_ordered_adds_the_chunks_of_the_split_in_turn(monkeypatch):
    """Terms spread over forty binary orders of magnitude, so that fp32
    sums depend on their order: the ordered sum is, bit for bit, each chunk
    of ``dbias_split`` added in turn from zero (numpy float32), then the
    chunks in turn from zero."""
    B, Tq, Tk, H = 16, 3, 5, 12
    rng = np.random.default_rng(15)
    terms = (rng.standard_normal((B * H, Tq, Tk)) * 2.0 ** rng.integers(-20, 20, (B * H, Tq, Tk)))
    terms = terms.astype(np.float32)
    monkeypatch.setattr(kernels, "_flash_ds_raw",
                        lambda *a: (None, torch.tensor(terms).view(B, H, Tq, Tk)))
    q, k = torch.zeros(B, Tq, H, 64), torch.zeros(B, Tk, H, 64)
    got = kernels.flash_attention_dbias_ordered(q, k, k, None, None, None, None, 0.125)
    chunks, per = kernels.dbias_split(B * H, Tq, Tk)
    assert chunks > 1
    want = np.zeros((Tq, Tk), np.float32)
    for c in range(chunks):
        part = np.zeros((Tq, Tk), np.float32)
        for bh in range(c * per, min(c * per + per, B * H)):
            part = part + terms[bh]
        want = want + part
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case,B,Tq,Tk,H,kind", FLASH_CASES, ids=IDS)
def test_wrappers_take_the_plain_versions_on_the_cpu(case, B, Tq, Tk, H, kind):
    q, k, v, do, bias = _inputs(2, Tq, Tk, 2, kind, seed=13)
    o, lse = kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)
    reset_launches()
    got = kernels.flash_attention_bwd(q, k, v, bias, o, lse, do, 0.125)
    want = kernels.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if bias is not None:
        assert torch.equal(kernels.flash_attention_dbias(q, k, v, bias, lse, got[3], do, 0.125),
                           kernels.flash_attention_dbias_plain(q, k, v, bias, lse, got[3], do, 0.125))
    assert not LAUNCHES


def _jax_grads(q, k, v, g, bias):
    """(out, dq, dk, dv, dbias) of ``jax.nn.dot_product_attention``."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    b = None if bias is None else jnp.asarray(bias)
    fn = lambda q, k, v, b: jax.nn.dot_product_attention(q, k, v, bias=None if b is None else b[None, None])
    out, vjp = jax.vjp(fn, *args, b)
    return [None if a is None else np.asarray(a, np.float32) for a in (out, *vjp(jnp.asarray(g)))]


@pytest.mark.parametrize("with_bias", [False, True], ids=["no bias", "bias"])
def test_cross_attention_grads_match_the_jax_package(with_bias):
    rng = np.random.default_rng(14)
    q, k, v, g = (rng.standard_normal((2, T, 2, 64)).astype(np.float32) for T in (77, 61, 61, 77))
    bias = (0.5 * rng.standard_normal((77, 61))).astype(np.float32) if with_bias else None
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    out = attention.flash_attention(tq, tk, tv, bias=tb)
    leaves = [tq, tk, tv] + ([] if tb is None else [tb])
    got = [out, *torch.autograd.grad(out, leaves, torch.tensor(g))]
    want = _jax_grads(q, k, v, g, bias)
    for name, a, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        a = a.detach().numpy()
        assert a.shape == w.shape and np.isfinite(a).all(), name
        tol = 2e-5 if name == "out" else 5e-4
        np.testing.assert_allclose(a, w, atol=tol, rtol=0, err_msg=name)
