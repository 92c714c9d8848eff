"""The row split of the port's weight-grad kernel (``gemm_wgrad``), on the
CPU: the plan ``wgrad_split`` for every product shape of the training
paths, and a plain emulation of "one partial product per row chunk, added in
order" against the one-product plain version.

The kernel itself runs only on a CUDA device (tests/test_torch_kernels_gpu.py);
what it sums in which order is decided here, in Python."""

import numpy as np
import pytest
import torch

from vipant_tpu_torch.ops import kernels
from vipant_tpu_torch.ops.kernels import SM_COUNT, WGRAD_STEP, WGRAD_TILE, wgrad_split

# (M rows, [(N1, N2) of dWout, dWqkv, dWproj, dWfc]) of one layer's backward
AUDIO = [(768, 768), (2304, 768), (768, 3072), (3072, 768)]
DECODER = [(512, 512), (1536, 512), (512, 2048), (2048, 512)]
STEP_SHAPES = (
    [(64 * 306, n1, n2) for n1, n2 in AUDIO]         # VA step and int8-frozen VA step: audio tower, B = 64
    + [(64 * 77, n1, n2) for n1, n2 in DECODER]      # captioning step: the decoder, B = 64, ctx 77
    + [(16 * 306, n1, n2) for n1, n2 in AUDIO]       # the B = 16 grad checks
    + [(16 * 77, n1, n2) for n1, n2 in DECODER]
    + [(50 * 306, n1, n2) for n1, n2 in AUDIO]       # AT step: audio tower, B = 50 (no multiple of 128)
    + [(64 * 50, n1, n2) for n1, n2 in AUDIO]        # trimodal step: the tied image tower, B = 64, T 50
)


def chunked_wgrad(a, b):
    """``gemm_wgrad_plain`` summed as the kernel sums: one partial product
    per row chunk of ``wgrad_split``, the partials added in order."""
    S, rows = wgrad_split(a.shape[0], a.shape[1], b.shape[1])
    a, b = kernels.acc(a), kernels.acc(b)
    y = torch.matmul(a[:rows].t(), b[:rows])
    for c in range(1, S):
        y = y + torch.matmul(a[c * rows:(c + 1) * rows].t(), b[c * rows:(c + 1) * rows])
    return y


def _blocks(M, N1, N2):
    S, rows = wgrad_split(M, N1, N2)
    return S * -(-N1 // WGRAD_TILE) * -(-N2 // WGRAD_TILE)


def _covers(M, S, rows):
    """S chunks of `rows` rows (whole pipeline steps), none empty, the last
    possibly short, cover [0, M) exactly."""
    assert S >= 1 and rows >= WGRAD_STEP and rows % WGRAD_STEP == 0
    edges = [min(c * rows, M) for c in range(S + 1)]
    assert edges[0] == 0 and edges[-1] == M
    assert all(a < b for a, b in zip(edges, edges[1:]))


@pytest.mark.parametrize("M,N1,N2", STEP_SHAPES)
def test_every_training_product_fills_the_card(M, N1, N2):
    S, rows = wgrad_split(M, N1, N2)
    _covers(M, S, rows)
    assert _blocks(M, N1, N2) >= SM_COUNT


@pytest.mark.parametrize("M", [1, 63, 64, 65, 127, 128, 200, 1224, 3200, 4928, 19584])
@pytest.mark.parametrize("N1,N2", [(768, 768), (3072, 768), (512, 1536), (8, 24), (136, 264)])
def test_chunks_cover_the_rows_exactly(M, N1, N2):
    S, rows = wgrad_split(M, N1, N2)
    _covers(M, S, rows)
    assert S <= -(-M // WGRAD_STEP)
    assert wgrad_split(M, N1, N2) == (S, rows)  # a function of the shapes only


@pytest.mark.parametrize("M", [1, 5, 63, 64])
def test_fewer_rows_than_one_chunk_is_one_chunk(M):
    assert wgrad_split(M, 768, 768) == (1, WGRAD_STEP)


def test_a_split_never_leaves_an_sm_idle_for_want_of_chunks():
    # 36 output tiles: without a split 96 SMs would idle; with it every SM has a block
    assert _blocks(19584, 768, 768) >= SM_COUNT > 36
    # too few rows for that many blocks: the finest split there is
    S, rows = wgrad_split(130, 64, 64)
    assert (S, rows) == (3, WGRAD_STEP)


@pytest.mark.parametrize("M,N1,N2", [(19584, 96, 64), (4928, 64, 200), (1224, 136, 72), (63, 8, 24), (1, 16, 8)])
def test_partials_summed_in_order_match_the_one_product(M, N1, N2):
    """fp32, atol 1e-5 * sqrt(M): the two differ only in the order of an
    fp32 sum of M products of unit-variance values."""
    r = np.random.default_rng(M)
    a = torch.from_numpy(r.standard_normal((M, N1)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((M, N2)).astype(np.float32))
    got, want = chunked_wgrad(a, b), kernels.gemm_wgrad_plain(a, b)
    assert got.shape == want.shape == (N1, N2) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * M ** 0.5)
    assert torch.equal(got, chunked_wgrad(a, b))


def test_chunked_sum_is_exact_on_small_integers():
    r = np.random.default_rng(0)
    a = torch.from_numpy(r.integers(-3, 4, (4928, 128)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(r.integers(-3, 4, (4928, 72)).astype(np.float32)).bfloat16()
    assert wgrad_split(4928, 128, 72)[0] > 1
    assert torch.equal(chunked_wgrad(a, b), kernels.gemm_wgrad_plain(a, b))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    r = np.random.default_rng(1)
    a = torch.from_numpy(r.standard_normal((2, 100, 24)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(r.standard_normal((2, 100, 40)).astype(np.float32)).bfloat16()
    kernels.reset_launches()
    assert torch.equal(kernels.gemm_wgrad(a, b), kernels.gemm_wgrad_plain(a, b))
    assert kernels.LAUNCHES["gemm_wgrad"] == 0
