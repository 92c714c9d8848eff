"""The shapes ``chip_smoke.py`` holds ``rowquant`` to on the card
(``ROWQUANT_CASES``: the four weights of each int8 tower width, the fp32
attention context and act(a) of every int8 tower and batch, which
``experiments/kernel_times.py`` also times) and the plan its wrapper
launches, checked on the CPU: every case is one the wrapper takes, read as
16-byte vectors; together they cover every int8 tower of the smoke's
configurations, so a width that an int8 path runs cannot go untested on the
card; ``kernels.rowquant_plan`` picks an instance whose registers hold the
row (scalar loads where a row is no whole number of 16-byte vectors, the
row read twice past the widest instance) and gives the batch-64 shapes a
full card. The plain quantizer is bitwise the JAX package's at the paths'
widths (a few rows, the real K), so the kernels, held bitwise to it on the
card, compute the JAX package's codes. The kernels' arithmetic for a code
(the product by the IEEE reciprocal where it proves the rounding, the IEEE
division elsewhere) is mirrored in numpy float32 and gives the division's
codes on random rows, on values a few ulps from the half-way points, and
at extreme scales.

The kernels themselves run only on a CUDA device
(tests/test_torch_kernels_gpu.py); on the CPU each wrapper takes its plain
version, which the last tests check at a small analogue of every case."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import quant as jax_quant
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo root's smoke script: its case lists)

RQ_CASES = chip_smoke.ROWQUANT_CASES
ITEMSIZE = {"bf16": 2, "fp32": 4}
DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}
INT8_TOWERS = [("CLAP_FULL", ("audio", "text")), ("FLAGSHIP", ("image",))]  # quantize="int8", int8_frozen


def _width(name, tower):
    return int(getattr(compose(getattr(chip_smoke, name)).model, tower).width)


def _check_plan(rows, K, itemsize):
    """The plan's instance holds the row (or reads it twice past the widest),
    and its grid covers the rows or fills the card."""
    plan = kernels.rowquant_plan(rows, K, itemsize)
    assert plan.per_load in (1, 16 // itemsize)
    assert (plan.per_load > 1) == (K * itemsize % 16 == 0)
    loads = -(-K // plan.per_load)
    fits = [s for s in kernels.ROWQUANT_SHAPES if 32 * s[0] * s[1] >= loads]
    assert (plan.warps, plan.vecs) == (fits[0] if fits else (4, 0))  # the smallest that holds it
    per_block = kernels.ROWQUANT_BLOCK_WARPS // plan.warps
    cap = kernels.SM_COUNT * kernels.rowquant_blocks_per_sm(plan.vecs)
    assert 1 <= plan.blocks <= cap
    assert plan.blocks == cap or (plan.blocks - 1) * per_block < rows <= plan.blocks * per_block
    assert kernels.rowquant_plan(rows, K, itemsize) == plan  # a function of the shapes alone
    return plan


@pytest.mark.parametrize("case,rows,K,dtype", RQ_CASES, ids=[c[0] for c in RQ_CASES])
def test_every_rowquant_case_is_one_the_kernel_reads_as_vectors(case, rows, K, dtype):
    assert rows > 0 and K > 0 and dtype in ITEMSIZE
    plan = _check_plan(rows, K, ITEMSIZE[dtype])
    assert plan.per_load == 16 // ITEMSIZE[dtype] and plan.vecs > 0  # 16-byte vectors, in registers


@pytest.mark.parametrize("name,towers", INT8_TOWERS)
def test_rowquant_cases_cover_every_int8_tower_of_the_smoke_configs(name, towers):
    have = {(rows, K, dtype) for _, rows, K, dtype in RQ_CASES}
    acts = {(K, dtype) for _, _, K, dtype in RQ_CASES if dtype == "fp32"}
    for tower in towers:
        C = _width(name, tower)
        weights = {(3 * C, C, "bf16"), (C, C, "bf16"), (4 * C, C, "fp32"), (C, 4 * C, "fp32")}
        assert weights <= have, f"{name} {tower} width {C}: no case for {sorted(weights - have)}"
        assert {(C, "fp32"), (4 * C, "fp32")} <= acts, f"{name} {tower}: no context or act(a) case"


def test_every_int8_tower_is_a_layernorm_case():
    """layernorm_rowquant is held at every LAYERNORM_CASES case, which holds
    every int8 tower's rows (kernel_times.py times it there)."""
    ln = {(rows, C) for _, rows, C in chip_smoke.LAYERNORM_CASES}
    for case, rows, C in chip_smoke.INT8_TOWERS:
        assert (rows, C) in ln, case
        assert any(r == rows and K == C for _, r, K, _ in RQ_CASES), case  # its context
        assert any(r == rows and K == 4 * C for _, r, K, _ in RQ_CASES), case  # its act(a)


@pytest.mark.parametrize("K,itemsize", [(37, 2), (100, 2), (37, 4), (63, 4), (701, 2)])
def test_rowquant_plan_takes_scalar_loads_where_a_row_is_no_whole_number_of_vectors(K, itemsize):
    plan = _check_plan(300, K, itemsize)
    assert plan.per_load == 1 and plan.vecs > 0


def test_rowquant_plan_reads_vectors_wherever_a_row_is_a_whole_number_of_them():
    assert kernels.rowquant_plan(300, 100, 4).per_load == 4  # 400 bytes: 25 vectors
    assert kernels.rowquant_plan(300, 64, 2).per_load == 8


@pytest.mark.parametrize("K,itemsize,shape", [(768, 2, (1, 3)), (512, 2, (1, 2)), (768, 4, (1, 6)),
                                              (512, 4, (1, 4)), (3072, 4, (4, 6)), (2048, 4, (2, 8)),
                                              (3076, 4, (4, 0)), (6144, 2, (4, 6)), (6152, 2, (4, 0))])
def test_rowquant_plan_shapes(K, itemsize, shape):
    """The paths' widths in registers (act(a) at 3072 fp32 over 4 warps), and
    past 32 * 4 * 6 loads the row read twice."""
    assert _check_plan(19584, K, itemsize)[:2] == shape


@pytest.mark.parametrize("case,rows,K,dtype", [c for c in RQ_CASES if c[1] >= 64 * 77],
                         ids=[c[0] for c in RQ_CASES if c[1] >= 64 * 77])
def test_rowquant_plan_fills_the_card_at_the_batch_64_shapes(case, rows, K, dtype):
    plan = kernels.rowquant_plan(rows, K, ITEMSIZE[dtype])
    assert plan.blocks == kernels.SM_COUNT * kernels.rowquant_blocks_per_sm(plan.vecs)
    assert plan.blocks * kernels.ROWQUANT_BLOCK_WARPS // plan.warps < rows  # every group walks rows


@pytest.mark.parametrize("itemsize", [2, 4])
def test_rowquant_plan_covers_any_shape(itemsize):
    for rows in (1, 2, 3, 4, 5, 37, 300, 1224, 19584, 100000):
        for K in (1, 7, 8, 37, 64, 100, 256, 768, 1000, 2048, 3072, 4096, 5000, 8201, 20000):
            _check_plan(rows, K, itemsize)


def _small(rows):
    return 3 + rows % 29  # a ragged CPU-sized row count


@pytest.mark.parametrize("case,rows,K,dtype", RQ_CASES, ids=[c[0] for c in RQ_CASES])
def test_rowquant_wrapper_takes_the_plain_version_on_the_cpu(case, rows, K, dtype):
    r = np.random.default_rng(rows + K)
    x = torch.from_numpy(3 * r.standard_normal((2, _small(rows), K)).astype(np.float32)).to(DTYPE[dtype])
    kernels.reset_launches()
    q, s = kernels.rowquant(x)
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == (*x.shape[:-1], 1)
    want = kernels.rowquant_plain(x)
    assert torch.equal(q, want[0]) and torch.equal(s, want[1])
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("case,rows,C", chip_smoke.INT8_TOWERS, ids=[c[0] for c in chip_smoke.INT8_TOWERS])
def test_layernorm_rowquant_wrapper_takes_the_plain_version_on_the_cpu(case, rows, C):
    r = np.random.default_rng(rows + C)
    x = torch.from_numpy(r.standard_normal((_small(rows), C)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(1 + 0.1 * r.standard_normal(C).astype(np.float32))
    b = torch.from_numpy(0.1 * r.standard_normal(C).astype(np.float32))
    kernels.reset_launches()
    got = kernels.layernorm_rowquant(x, w, b)
    want = kernels.rowquant_plain(kernels.layernorm_plain(x, w, b))  # rowquant(layernorm_fwd(x))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("case,rows,K,dtype", RQ_CASES, ids=[c[0] for c in RQ_CASES])
def test_rowquant_plain_is_the_jax_quantizer_at_the_paths_widths(case, rows, K, dtype):
    """A few rows at the real K. An activation row is ``quantize_rows``'s; a
    weight [out, in] row is an output column of ``quantize_cols`` on the JAX
    package's [in, out] layout, cast to bf16 first where the path casts it."""
    r = np.random.default_rng(K + ITEMSIZE[dtype])
    x = r.standard_normal((_small(rows), K)).astype(np.float32) * (0.05 if " W" in case else 3.0)
    x[1] = 0.0  # an all-zero row: scale 1e-12, codes 0
    tx = torch.from_numpy(x).to(DTYPE[dtype])
    q, s = kernels.rowquant_plain(tx)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    if " W" in case:
        jq, js = jax_quant.quantize_cols(jx.T)
        jq, js = np.asarray(jq).T, np.asarray(js).T
    else:
        jq, js = jax_quant.quantize_rows(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[1] == 0).all()


def _codes_by_reciprocal(x):
    """``quant.cu``'s ``put_codes`` in numpy float32 (IEEE operations): where
    the product p by the IEEE reciprocal of the scale is further than
    0.5 - 2^-14 from its nearest integer, the low byte of p + 1.5 * 2^23;
    elsewhere the IEEE division, rounded half to even and clipped. Returns
    the codes and the share of values that took the division."""
    units = np.float32(1.5 * 2 ** 23)
    s = np.abs(x).max(axis=-1, keepdims=True) / np.float32(127) + np.float32(1e-12)
    p = x * (np.float32(1) / s)
    m = p + units
    near = ~(np.abs(p - (m - units)) < np.float32(0.5 - 2 ** -14))
    codes = (m.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    codes[near] = np.clip(np.rint(x / s), -127, 127).astype(np.int8)[near]
    return codes, near.mean()


@pytest.mark.parametrize("kind", ["normal", "half_way", "extreme_scales", "tiny"])
def test_the_reciprocal_product_gives_the_divisions_codes(kind):
    """The kernels divide only where the product by the reciprocal cannot
    prove the rounding; their codes are the division's (the argument is in
    ``quant.cu``'s ``code_by_product``), here on 400,000 values of each
    kind."""
    r = np.random.default_rng(["normal", "half_way", "extreme_scales", "tiny"].index(kind))
    rows, K = 500, 800
    if kind == "normal":
        x = (3 * r.standard_normal((rows, K))).astype(np.float32)
    else:
        s = (0.25 + 4 * r.random((rows, 1))).astype(np.float32)
        if kind == "extreme_scales":
            s = s * np.float32(10.0) ** r.integers(-30, 30, (rows, 1)).astype(np.float32)
        if kind == "tiny":
            s = s * np.float32(1e-38)
        k = r.integers(-127, 127, (rows, K)).astype(np.float32) + np.float32(0.5)
        x = (k * s).astype(np.float32)
        x = (x.view(np.int32) + r.integers(-3, 4, (rows, K)).astype(np.int32)).view(np.float32)
        x[:, 0] = np.float32(127) * s[:, 0]
    x[1] = 0
    codes, took_division = _codes_by_reciprocal(x)
    want = np.clip(np.rint(x / (np.abs(x).max(axis=-1, keepdims=True) / np.float32(127) + np.float32(1e-12))),
                   -127, 127).astype(np.int8)
    np.testing.assert_array_equal(codes, want)
    want_t, _ = kernels.rowquant_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(codes, want_t.numpy())  # and the plain version's
    if kind == "half_way":
        assert took_division > 0.01  # the division did run here
    if kind == "normal":
        assert took_division < 1e-3
