"""The row shapes ``chip_smoke.py`` holds ``layernorm_fwd`` and
``layernorm_rowquant`` to on the card (``LAYERNORM_CASES``) and the bias
grads it holds ``colsum`` to (``COLSUM_CASES``), which
``experiments/kernel_times.py`` also times, checked on the CPU: every case
is one the wrapper takes (the LayerNorm kernels hold a row in a warp's
registers as 16-byte vectors: C % 8 == 0, C <= 2048; ``colsum`` reads rows
of whole 16-byte vectors), and together they cover every tower width of the
smoke's configurations (the bias grads of the trained towers), so a width
that a path runs cannot go untested on the card. ``colsum_split`` covers the
rows once and gives a training step's bias grad enough blocks for the
card's 132 SMs, and a sum in the kernel's order (``colsum_ordered``) is the
plain sum within fp32 rounding.

The kernels themselves run only on a CUDA device
(tests/test_torch_kernels_gpu.py); on the CPU each wrapper takes its plain
version, which the last tests check at a small analogue of every case."""

import os
import sys

import numpy as np
import pytest
import torch

from vipant_tpu_torch.config import compose
from vipant_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo root's smoke script: its case lists)

LN_CASES = chip_smoke.LAYERNORM_CASES
CS_CASES = chip_smoke.COLSUM_CASES
ITEMSIZE = {"bf16": 2, "fp32": 4}
DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}
TOWERS = [("CLAP_FULL", ("audio", "text")), ("FLAGSHIP", ("audio", "image")),
          ("CAPTION_FULL", ("audio", "text"))]
TRAINED = [("FLAGSHIP", ("audio",)), ("CAPTION_FULL", ("audio", "text"))]  # the towers with a backward


def _width(name, tower):
    return int(getattr(compose(getattr(chip_smoke, name)).model, tower).width)


@pytest.mark.parametrize("case,rows,C", LN_CASES, ids=[c[0] for c in LN_CASES])
def test_every_layernorm_case_is_one_the_kernels_take(case, rows, C):
    assert rows > 0 and C % 8 == 0 and 0 < C <= kernels.LN_MAX_C
    kernels._ln_width(C)  # the wrappers' own check


@pytest.mark.parametrize("C", [12, 0, 2056, 4096])
def test_the_layernorm_width_check_refuses_what_a_warp_cannot_hold(C):
    with pytest.raises(ValueError, match="multiple of 8 and at most 2048"):
        kernels._ln_width(C)


@pytest.mark.parametrize("name,towers", TOWERS)
def test_layernorm_cases_cover_every_tower_of_the_smoke_configs(name, towers):
    have = {C for _, _, C in LN_CASES}
    for tower in towers:
        assert _width(name, tower) in have, f"{name} {tower}: no LayerNorm case at its width"


def test_cases_hold_the_at_step_at_its_own_rows():
    """The AT step (``chip_smoke.LA_FULL`` at its batch of 50): the audio tower
    at 15,300 rows, the frozen text tower at 50 x 77 and at eval 250 x 77
    (5 captions a clip); the audio tower's bias grads."""
    B = int(compose(chip_smoke.LA_FULL).running.batch_size)
    assert {(B * 306, 768), (B * 77, 512), (5 * B * 77, 512)} <= {(r, C) for _, r, C in LN_CASES}
    assert {(B * 306, 768, "bf16"), (B * 306, 2304, "fp32"), (B * 306, 3072, "bf16")} <= {
        c[1:] for c in CS_CASES}


def test_cases_hold_the_tied_image_tower_of_the_trimodal_step():
    """The trimodal step's image tower (``chip_smoke.VAL_TIED``), its encoder
    tied to the trained audio tower: 64 x 50 rows, unpacked; its bias grads."""
    cfg = compose(chip_smoke.VAL_TIED)
    im = cfg.model.image
    M = int(cfg.running.batch_size) * (1 + (int(im.resolution) // int(im.pre_encoder.patch_size)) ** 2)
    C = int(im.width)
    assert (M, C) in {(r, C_) for _, r, C_ in LN_CASES}
    assert {(M, C, "bf16"), (M, 3 * C, "fp32"), (M, 4 * C, "bf16")} <= {c[1:] for c in CS_CASES}


def test_cases_hold_the_backbone_steps_at_their_own_rows():
    """``backbone_phase``'s DeiT step (audio trained at 64 x 1,190 rows, image
    frozen at 64 x 198) and patchout step (64 x 229): their LayerNorm rows
    and the trained towers' bias grads."""
    from test_torch_gemm_cases import backbone_rows

    audio, image, patch = backbone_rows()
    assert {(audio, 768), (image, 768), (patch, 768)} <= {(r, C) for _, r, C in LN_CASES}
    for M in (audio, patch):
        assert {(M, 768, "bf16"), (M, 2304, "fp32"), (M, 3072, "bf16")} <= {c[1:] for c in CS_CASES}


def test_the_decode_runs_layernorm_at_every_batch():
    C = _width("CAPTION_FULL", "text")
    decode = {(rows, C_) for case, rows, C_ in LN_CASES if "decode T=1" in case}
    assert {(M, C) for M in (4, 16, 64, 256)} <= decode  # batch 4 and 64, greedy and beam = 4


@pytest.mark.parametrize("case,rows,N,dtype", CS_CASES, ids=[c[0] for c in CS_CASES])
def test_every_colsum_case_is_one_the_kernel_takes(case, rows, N, dtype):
    assert rows > 0 and N > 0 and N % (16 // ITEMSIZE[dtype]) == 0  # rows of whole 16-byte vectors


@pytest.mark.parametrize("name,towers", TRAINED)
def test_colsum_cases_cover_every_trained_tower(name, towers):
    have = {(N, dtype) for _, _, N, dtype in CS_CASES}
    for tower in towers:
        C = _width(name, tower)
        want = {(C, "bf16"), (3 * C, "fp32"), (4 * C, "bf16")}  # dbout and dbproj, dbqkv, dbfc
        assert want <= have, f"{name} {tower} width {C}: no case for {sorted(want - have)}"


def _check_split(rows, N, itemsize):
    S, per = kernels.colsum_split(rows, N, itemsize)
    assert S >= 1 and per >= 1 and per % kernels.COLSUM_WARPS == 0
    assert (S - 1) * per < rows <= S * per  # every row in exactly one chunk, none empty
    assert kernels.colsum_split(rows, N, itemsize) == (S, per)  # a function of the shapes alone
    return S * -(-N * itemsize // kernels.COLSUM_STRIP)


@pytest.mark.parametrize("case,rows,N,dtype", CS_CASES, ids=[c[0] for c in CS_CASES])
def test_colsum_split_covers_the_rows_once_and_fills_the_card(case, rows, N, dtype):
    blocks = _check_split(rows, N, ITEMSIZE[dtype])
    if rows >= 64 * 77:  # the training steps' bias grads
        assert blocks >= kernels.SM_COUNT, f"{case}: {blocks} blocks for {kernels.SM_COUNT} SMs"


@pytest.mark.parametrize("itemsize", [2, 4])
def test_colsum_split_covers_any_row_count(itemsize):
    for rows in (1, 7, 8, 9, 63, 64, 65, 111, 1000, 4928, 19584, 100000):
        for N in (8, 24, 512, 768, 2304, 3072):
            _check_split(rows, N, itemsize)


@pytest.mark.parametrize("case,rows,N,dtype", CS_CASES, ids=[c[0] for c in CS_CASES])
def test_colsum_in_the_kernels_order_is_the_plain_sum(case, rows, N, dtype):
    """At the case's row count (its width cut to 24 columns, for memory), the
    sum in colsum_split's chunks and the kernel's order and the plain sum are
    each within the fp32 rounding bound of the exact sum, (rows - 1) * 2^-24
    * sum |x| per column."""
    r = np.random.default_rng(rows + N)
    x = torch.from_numpy(r.standard_normal((rows, 24)).astype(np.float32)).to(DTYPE[dtype])
    exact = x.double().sum(0)
    bound = (rows - 1) * 2.0 ** -24 * x.double().abs().sum(0) + 1e-30
    for got in (kernels.colsum_ordered(x), kernels.colsum_plain(x)):
        assert got.dtype == torch.float32 and got.shape == (24,)
        assert ((got.double() - exact).abs() <= bound).all()


def _small_ln(rows, C):
    """A CPU-sized analogue of a [rows, C] LayerNorm: a ragged row count, C
    cut by 32 (a tower of width 24 or 16)."""
    return 3 + rows % 29, C // 32


@pytest.mark.parametrize("case,rows,C", LN_CASES, ids=[c[0] for c in LN_CASES])
def test_layernorm_wrappers_take_the_plain_version_on_the_cpu(case, rows, C):
    m, c = _small_ln(rows, C)
    r = np.random.default_rng(rows + C)
    x = torch.from_numpy(r.standard_normal((2, m, c)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(1 + 0.1 * r.standard_normal(c).astype(np.float32))
    b = torch.from_numpy(0.1 * r.standard_normal(c).astype(np.float32))
    dh = torch.from_numpy(r.standard_normal((2, m, c)).astype(np.float32))
    kernels.reset_launches()
    got = kernels.layernorm_fwd(x, w, b)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, kernels.layernorm_plain(x, w, b))
    for g, want in zip(kernels.layernorm_rowquant(x, w, b), kernels.layernorm_rowquant_plain(x, w, b)):
        assert torch.equal(g, want)
    for g, want in zip(kernels.layernorm_bwd(x, w, dh, x), kernels.layernorm_bwd_plain(x, w, dh, x)):
        assert torch.equal(g, want)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("case,rows,N,dtype", CS_CASES, ids=[c[0] for c in CS_CASES])
def test_colsum_wrapper_takes_the_plain_version_on_the_cpu(case, rows, N, dtype):
    m, n = 3 + rows % 29, N // 32
    r = np.random.default_rng(rows + N)
    x = torch.from_numpy(r.standard_normal((2, m, n)).astype(np.float32)).to(DTYPE[dtype])
    kernels.reset_launches()
    got = kernels.colsum(x)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert torch.equal(got, kernels.colsum_plain(x))
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("C", sorted({c for _, _, c in LN_CASES}))
def test_layernorm_statistics_do_not_depend_on_the_summation_order(C):
    """The plain LayerNorm takes its statistics in float64, as the kernels
    do (``rows.cuh``), each in its own order: with the row's columns (and w,
    b) permuted, its bf16 output and int8 codes are the same values, bit for
    bit, at rows of the paths' widths with a spread of magnitudes."""
    r = np.random.default_rng(C)
    x = r.standard_normal((256, C)) * np.exp(r.uniform(-4, 4, (256, 1)))  # rows of 1e-2 to 1e2
    x[:, 0] *= 50  # a row's largest value, whose rounding sets the int8 scale
    x[1] = 0
    x = torch.from_numpy(x.astype(np.float32)).bfloat16()
    w = torch.from_numpy(1 + 0.1 * r.standard_normal(C).astype(np.float32))
    b = torch.from_numpy(0.1 * r.standard_normal(C).astype(np.float32))
    perm = torch.from_numpy(r.permutation(C))
    assert torch.equal(kernels.layernorm_plain(x, w, b)[:, perm],
                       kernels.layernorm_plain(x[:, perm], w[perm], b[perm]))
    q, s = kernels.layernorm_rowquant_plain(x, w, b)
    qp, sp = kernels.layernorm_rowquant_plain(x[:, perm], w[perm], b[perm])
    assert torch.equal(q[:, perm], qp) and torch.equal(s, sp)
