"""The product shapes ``chip_smoke.py`` holds ``gemm_bias_act``,
``gemm_dgrad`` and ``gemm_i8`` to on the card (``GEMM_FWD_CASES``,
``GEMM_DGRAD_CASES``, ``GEMM_I8_CASES``, which
``experiments/kernel_times.py`` also times), checked on the CPU: every
case is one the wrapper takes, and together they cover the four products
of every tower the smoke's configurations build (forward, data grad of the
trained towers, int8), so a width that a path runs cannot go untested on
the card.

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
import chip_smoke  # noqa: E402  (the repo root's smoke script: its case list)

CASES = chip_smoke.GEMM_FWD_CASES
DGRAD_CASES = chip_smoke.GEMM_DGRAD_CASES
I8_CASES = chip_smoke.GEMM_I8_CASES
TRAINED = [("FLAGSHIP", ("audio",)), ("CAPTION_FULL", ("audio", "text")),  # the towers with a backward
           ("VAL_TIED", ("audio", "image"))]
INT8 = [("CLAP_FULL", ("audio", "text")), ("FLAGSHIP", ("image",)), ("CAPTION_FULL", ("audio", "text"))]


@pytest.mark.parametrize("case,M,N,K,act,res,pre", CASES, ids=[c[0] for c in CASES])
def test_every_case_is_one_the_kernel_takes(case, M, N, K, act, res, pre):
    assert M > 0 and N > 0 and K > 0 and K % 8 == 0  # TMA's 16-byte row stride
    assert act in kernels.ACTS
    assert not (res and pre)  # no path asks for both


def _products(C):
    """(N, K) of a transformer layer's four forward products at width C:
    qkv, out-projection, fc, proj (the MLP is 4 C wide)."""
    return {(3 * C, C), (C, C), (4 * C, C), (C, 4 * C)}


@pytest.mark.parametrize("name,towers", [
    ("CLAP_FULL", ("audio", "text")),
    ("FLAGSHIP", ("audio", "image")),
    ("CAPTION_FULL", ("audio", "text")),
])
def test_cases_cover_every_tower_of_the_smoke_configs(name, towers):
    cfg = compose(getattr(chip_smoke, name))
    have = {(N, K) for _, _, N, K, *_ in CASES}
    for tower in towers:
        C = int(getattr(cfg.model, tower).width)
        missing = _products(C) - have
        assert not missing, f"{name} {tower} width {C}: no case for (N, K) in {sorted(missing)}"


def _at_rows():
    """Rows of the AT step (``chip_smoke.LA_FULL`` at its config's own batch):
    the audio tower, the frozen text tower, the text tower at eval (k
    captions a clip)."""
    cfg = compose(chip_smoke.LA_FULL)
    B = int(cfg.running.batch_size)
    assert B == chip_smoke.LA_B == 50
    return B * 306, B * int(cfg.model.text.ctx_len), 5 * B * int(cfg.model.text.ctx_len)


def test_cases_hold_the_at_step_at_its_own_rows():
    audio, text, text_eval = _at_rows()
    have = {(M, N, K, pre) for _, M, N, K, _, _, pre in CASES}
    for M, C in ((audio, 768), (text, 512), (text_eval, 512)):
        assert {(M, N, K, False) for N, K in _products(C)} <= have, M
    assert (audio, 3072, 768, True) in have  # the MLP backward's recomputed fc
    dgrad = {(M, N, K, act) for _, M, N, K, act, _ in DGRAD_CASES}
    assert {(audio, N, K) for N, K in _dgrad_products(768)} <= {c[:3] for c in dgrad}
    assert {act for M, N, K, act in dgrad if (M, N, K) == (audio, 3072, 768)} == {"quick_gelu", "gelu"}


def _tied_image_rows():
    """Rows and width of the trimodal step's image tower (``chip_smoke.VAL_TIED``
    at its config's batch): its encoder is tied to the trained audio tower,
    so it runs a backward, unpacked, at T = 1 + grid."""
    cfg = compose(chip_smoke.VAL_TIED)
    assert "encoder" in list(cfg.running.siamese.amodules) and bool(cfg.running.siamese.alive)
    im = cfg.model.image
    T = 1 + (int(im.resolution) // int(im.pre_encoder.patch_size)) ** 2
    return int(cfg.running.batch_size) * T, int(im.width)


def test_cases_hold_the_tied_image_tower_at_its_own_rows():
    M, C = _tied_image_rows()
    assert (M, C) == (64 * 50, 768)
    have = {(M_, N, K, pre) for _, M_, N, K, _, _, pre in CASES}
    assert {(M, N, K, False) for N, K in _products(C)} <= have
    assert (M, 4 * C, C, True) in have  # the MLP backward's recomputed fc
    dgrad = {c[1:4] for c in DGRAD_CASES}
    assert {(M, N, K) for N, K in _dgrad_products(C)} <= dgrad


def test_the_decode_runs_the_decoder_mlp_at_every_batch():
    C = int(compose(chip_smoke.CAPTION_FULL).model.text.width)
    decode = {(M, N, K) for case, M, N, K, *_ in CASES if "decode T=1" in case}
    for M in (4, 16, 64, 256):  # batch 4 and 64, greedy and beam = 4
        assert {(M, 4 * C, C), (M, C, 4 * C)} <= decode


def test_wrapper_takes_the_plain_version_on_the_cpu():
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((2, 5, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(r.standard_normal((24, 64)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(r.standard_normal(24).astype(np.float32))
    kernels.reset_launches()
    assert torch.equal(kernels.gemm_bias_act(x, w, b, "gelu"), kernels.gemm_bias_act_plain(x, w, b, "gelu"))
    assert kernels.LAUNCHES["gemm_bias_act"] == 0


@pytest.mark.parametrize("case,M,N,K,act,rounded", DGRAD_CASES, ids=[c[0] for c in DGRAD_CASES])
def test_every_dgrad_case_is_one_the_wrapper_takes(case, M, N, K, act, rounded):
    assert M > 0 and K > 0 and K % 8 == 0 and N > 0 and N % 8 == 0  # TMA's 16-byte row strides
    assert act in kernels.ACTS
    assert rounded or act == "none"  # the act-grad product feeds the next product in bf16


@pytest.mark.parametrize("case,M,N,K,act,res,f32,col_first", I8_CASES, ids=[c[0] for c in I8_CASES])
def test_every_i8_case_is_one_the_wrapper_takes(case, M, N, K, act, res, f32, col_first):
    assert M > 16 and K % 16 == 0 and N % 8 == 0  # the wrapper's rule; torch._int_mm's M > 16
    assert act in kernels.ACTS
    assert not (res and f32)  # the residual is added to a bf16 result
    assert not (col_first and act != "none")  # only the qkv projection scales its columns first


def _dgrad_products(C):
    """(N, K) of a transformer layer's four data-grad products at width C:
    dy [M, K] . w [K, N] for do = g.Wout, dh = dqkv.Wqkv, da = gy.Wproj,
    dh = da.Wfc."""
    return {(C, C), (C, 3 * C), (4 * C, C), (C, 4 * C)}


@pytest.mark.parametrize("name,towers", TRAINED)
def test_dgrad_cases_cover_every_trained_tower(name, towers):
    cfg = compose(getattr(chip_smoke, name))
    have = {(N, K) for _, _, N, K, *_ in DGRAD_CASES}
    for tower in towers:
        C = int(getattr(cfg.model, tower).width)
        missing = _dgrad_products(C) - have
        assert not missing, f"{name} {tower} width {C}: no case for (N, K) in {sorted(missing)}"
        grads = {act for _, _, N, K, act, _ in DGRAD_CASES if (N, K) == (4 * C, C)}
        assert grads == set(kernels.ACTS) - {"none"}, f"{name} {tower}: activation grads {grads}"


@pytest.mark.parametrize("name,towers", INT8)
def test_i8_cases_cover_every_int8_tower(name, towers):
    cfg = compose(getattr(chip_smoke, name))
    have = {(N, K) for _, _, N, K, *_ in I8_CASES}
    for tower in towers:
        C = int(getattr(cfg.model, tower).width)
        missing = _products(C) - have
        assert not missing, f"{name} {tower} width {C}: no case for (N, K) in {sorted(missing)}"


def _small(M, N, K):
    """A CPU-sized analogue of an [M x N x K] product: a ragged row count,
    N and K cut by 32 (a tower of width 24 or 16)."""
    return 3 + M % 29, N // 32, K // 32


@pytest.mark.parametrize("case,M,N,K,act,rounded", DGRAD_CASES, ids=[c[0] for c in DGRAD_CASES])
def test_dgrad_wrapper_takes_the_plain_version_on_the_cpu(case, M, N, K, act, rounded):
    m, n, k = _small(M, N, K)
    r = np.random.default_rng(M + N + K)
    dy = torch.from_numpy(r.standard_normal((2, m, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(r.standard_normal((k, n)).astype(np.float32)).bfloat16()
    a = None if act == "none" else torch.from_numpy(r.standard_normal((2, m, n)).astype(np.float32))
    kernels.reset_launches()
    got = kernels.gemm_dgrad(dy, w, rounded, act, a)
    assert got.shape == (2, m, n) and got.dtype == (torch.bfloat16 if rounded else torch.float32)
    assert torch.equal(got, kernels.gemm_dgrad_plain(dy, w, rounded, act, a))
    assert kernels.LAUNCHES["gemm_dgrad"] == 0


@pytest.mark.parametrize("case,M,N,K,act,res,f32,col_first", I8_CASES, ids=[c[0] for c in I8_CASES])
def test_i8_wrapper_takes_the_plain_version_on_the_cpu(case, M, N, K, act, res, f32, col_first):
    m, n, k = _small(M, N, K)
    r = np.random.default_rng(M + N + K)
    xq, rs = kernels.rowquant_plain(torch.from_numpy(r.standard_normal((2, m, k)).astype(np.float32)))
    wq, cs = kernels.rowquant_plain(torch.from_numpy(r.standard_normal((n, k)).astype(np.float32)))
    b = torch.from_numpy(r.standard_normal(n).astype(np.float32))
    residual = torch.from_numpy(r.standard_normal((2, m, n)).astype(np.float32)).bfloat16() if res else None
    kw = dict(act=act, residual=residual, out_dtype=torch.float32 if f32 else torch.bfloat16,
              col_first=col_first)
    kernels.reset_launches()
    got = kernels.gemm_i8(xq, rs, wq, cs, b, **kw)
    assert got.shape == (2, m, n) and got.dtype == kw["out_dtype"]
    assert torch.equal(got, kernels.gemm_i8_plain(xq, rs, wq, cs, b, **kw))
    assert kernels.LAUNCHES["gemm_i8"] == 0
