"""The plan and the shapes of ``dot_variant`` (the probe's P1, the product
in four operand orientations), checked on the CPU.

- ``kernels.dot_plan`` is pure and cached, and its blocks cover every
  element of the [M, N] output exactly once, at every ``chip_smoke.DOT_CASES``
  case and at edge shapes (M or N = 16, K = 0, K = 16); its stages hold all
  of K where K fits them and are none at K = 0;
- its constants are those of ``csrc/dot_variants.cu`` (the card's test of
  ``vt_dot_plan`` holds the two launches equal there);
- at every case and orientation the JAX probe's own Pallas kernel
  (``experiments/fused_block_probe.py::_dot_variant_kernel``, interpret
  mode) and the port's ``kernels.dot_variant`` on the CPU give the same
  product from the same seeded numpy operands: max |d| <= 1e-4, fp32 sums
  of up to 1024 bf16 products (values up to ~160) in another order;
- at K = 0 the port gives an [M, N] of zeros in every orientation.

The kernel itself runs only on a CUDA device
(tests/test_torch_kernels_gpu.py, chip_smoke.py's probe phase)."""

import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vipant_tpu_torch.ops import LAUNCHES, kernels, reset_launches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the repo root's smoke script: its case list)

DOT_CASES = chip_smoke.DOT_CASES
EDGES = [("M16", 16, 64, 384), ("N16", 256, 64, 16), ("M16 N16", 16, 128, 16), ("K0", 256, 0, 384),
         ("K16", 80, 16, 48)]
DIMS = {"NN": ((1,), (0,)), "NT": ((1,), (1,)), "TN": ((0,), (0,)), "TT": ((0,), (1,))}  # dot_general's


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_fused_block_probe", os.path.join(ROOT, "experiments", "fused_block_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dot_plan_is_pure_and_cached():
    kernels.dot_plan.cache_clear()
    first = kernels.dot_plan(256, 384, 128)
    assert kernels.dot_plan(256, 384, 128) is first
    assert kernels.dot_plan.cache_info().hits == 1
    assert first == (64, 1, 24) and first == kernels.dot_plan.__wrapped__(256, 384, 128)


@pytest.mark.parametrize("case,M,K,N", DOT_CASES + EDGES, ids=[c[0] for c in DOT_CASES + EDGES])
def test_dot_plan_covers_every_output_tile_once(case, M, K, N):
    plan = kernels.dot_plan(M, N, K)
    bm = bn = plan.bn
    grid_n, grid_m = -(-N // bn), -(-M // bm)  # the kernel's grid: (column tiles, row tiles)
    assert plan.blocks == grid_n * grid_m
    seen = np.zeros((M, N), np.int64)
    for by in range(grid_m):
        for bx in range(grid_n):
            seen[by * bm:(by + 1) * bm, bx * bn:(bx + 1) * bn] += 1  # rows past M, columns past N left out
    assert (seen == 1).all()
    steps = -(-K // kernels.DOT_STEP)
    assert plan.stages == min(steps, kernels.DOT_MAX_STAGES)
    assert (plan.stages == 0) == (K == 0)
    if K <= kernels.DOT_STEP * kernels.DOT_MAX_STAGES:  # all of K asked for at once
        assert plan.stages * kernels.DOT_STEP >= K


def test_dot_plan_constants_match_the_kernel_source():
    src = open(os.path.join(ROOT, "vipant_tpu_torch", "csrc", "dot_variants.cu")).read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("BM") == const("BN") == kernels.DOT_TILE
    assert const("BK") == kernels.DOT_STEP
    assert const("kMaxStages") == kernels.DOT_MAX_STAGES


@pytest.mark.parametrize("orientation", list(DIMS))
@pytest.mark.parametrize("case,M,K,N", DOT_CASES, ids=[c[0] for c in DOT_CASES])
def test_dot_variant_matches_the_pallas_probe_kernel(jax_probe, case, M, K, N, orientation):
    ta, tb = kernels.ORIENTATIONS[orientation]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K, M) if ta else (M, K)).astype(np.float32)
    b = rng.standard_normal((N, K) if tb else (K, N)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = pl.pallas_call(functools.partial(jax_probe._dot_variant_kernel, dims=DIMS[orientation]),
                          out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True)(ja, jb)
    reset_launches()
    got = kernels.dot_variant(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), orientation)
    assert not LAUNCHES  # on the CPU: the plain version
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0, err_msg=case)


def test_dot_variant_of_k0_is_zeros():
    M, N = 80, 48
    for orientation, (ta, tb) in kernels.ORIENTATIONS.items():
        a = torch.ones((0, M) if ta else (M, 0), dtype=torch.bfloat16)
        b = torch.ones((N, 0) if tb else (0, N), dtype=torch.bfloat16)
        got = kernels.dot_variant(a, b, orientation)
        assert got.shape == (M, N) and got.dtype == torch.float32 and not got.any(), orientation
