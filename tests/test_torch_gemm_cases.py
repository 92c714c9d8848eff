"""The product shapes ``chip_smoke.py`` holds ``gemm_bias_act`` to on the
card (``GEMM_FWD_CASES``, which ``experiments/kernel_times.py`` also times),
checked on the CPU: every case is one the kernel takes, and together they
cover the four products of every tower the smoke's configurations build,
so a width that a path runs cannot go untested on the card.

The kernel itself runs only on a CUDA device (tests/test_torch_kernels_gpu.py);
on the CPU the wrapper takes its plain version."""

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
