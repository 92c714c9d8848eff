"""The plans of ``layernorm_bwd`` and ``flash_attention_fwd`` and the shapes
``chip_smoke.py`` holds them to on the card (``LAYERNORM_BWD_CASES``,
``FLASH_CASES``), checked on the CPU.

- ``kernels.layernorm_bwd_split`` covers every row once at every case and
  gives a training shape at least one block of warps on every SM;
- ``kernels.layernorm_bwd_ordered``, the weight and bias grads summed in the
  kernel's order, is within fp32 rounding of the exact sums, as the plain
  version is: |sum - exact| <= (rows + 64) * 2^-24 * sum |terms| per column;
- through two layers of width 64 (attention then MLP sub-block, each with
  its LayerNorm), the grads of every LayerNorm scale and shift with the
  kernel's order match the JAX package's Pallas kernels in interpret mode:
  fp32 at rtol = 5e-3, atol = 5e-3 * max |ref|, and bf16 activations within
  a relative Frobenius error of 2e-2, the tolerances of
  test_torch_fused_attn.py and test_torch_fused_mlp.py;
- ``kernels.flash_fwd_plan`` puts every query row in one block of whole
  16-row warps at every case;
- ``LAYERNORM_BWD_CASES`` has a case at every trained tower's width and at
  the timed step's rows;
- on the CPU both wrappers take their plain versions and launch nothing.

The kernels themselves run only on a CUDA device
(tests/test_torch_kernels_gpu.py)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipant_tpu.ops import fused_attn as jax_fa
from vipant_tpu.ops import fused_mlp as jax_fm
from vipant_tpu_torch.config import compose
from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo root's smoke script: its case lists)

LNB_CASES = chip_smoke.LAYERNORM_BWD_CASES
FLASH_CASES = chip_smoke.FLASH_CASES
TRAINED = [("FLAGSHIP", "audio", 306), ("CAPTION_FULL", "audio", 306), ("CAPTION_FULL", "text", 77)]
ORDERED_OPS = kernels.PLAIN_OPS._replace(layernorm_bwd=kernels.layernorm_bwd_ordered)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    oversubscribing the cores when the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_split(rows, C):
    warps, per = kernels.layernorm_bwd_split(rows, C)
    assert warps >= 1 and per >= 1
    assert (warps - 1) * per < rows <= warps * per  # every row in one warp, none empty
    assert kernels.layernorm_bwd_split(rows, C) == (warps, per)  # a function of the shapes alone
    return warps, per


@pytest.mark.parametrize("case,rows,C", LNB_CASES, ids=[c[0] for c in LNB_CASES])
def test_layernorm_bwd_split_covers_the_rows_once_and_fills_the_card(case, rows, C):
    warps, _ = _check_split(rows, C)
    blocks = -(-warps // kernels.LN_BWD_WARPS)
    if rows >= 64 * 77:  # the timed training steps
        assert blocks >= kernels.SM_COUNT, f"{case}: {blocks} blocks for {kernels.SM_COUNT} SMs"


def test_layernorm_bwd_split_covers_any_row_count():
    for rows in (1, 2, 3, 7, 31, 32, 33, 300, 1000, 1584, 1585, 4928, 19584, 100000):
        for C in (8, 256, 512, 768, 1024, 1280, 2048):
            _check_split(rows, C)


def _ln_inputs(rows, C, seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((rows, C)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(1 + 0.1 * r.standard_normal(C).astype(np.float32))
    dh = torch.from_numpy(r.standard_normal((rows, C)).astype(np.float32))
    res = torch.from_numpy(r.standard_normal((rows, C)).astype(np.float32)).bfloat16()
    return x, w, dh, res


@pytest.mark.parametrize("case,rows,C", LNB_CASES, ids=[c[0] for c in LNB_CASES])
def test_layernorm_bwd_in_the_kernels_order_is_the_plain_sum(case, rows, C):
    """At the case's width and an eighth of its rows (ragged, several rows a
    warp at the training shapes), both orders are within fp32 rounding of
    the exact sums of the same fp32 terms, and dx is the plain version's."""
    m = rows // 8 + 3
    x, w, dh, res = _ln_inputs(m, C, rows + C)
    dx, dw, db = kernels.layernorm_bwd_ordered(x, w, dh, res)
    dx0, dw0, db0 = kernels.layernorm_bwd_plain(x, w, dh, res)
    assert torch.equal(dx, dx0)
    xhat, _ = kernels._ln_stats(x)
    for got, want, terms in ((dw, dw0, dh * xhat), (db, db0, dh)):
        assert got.dtype == torch.float32 and got.shape == (C,)
        exact = terms.double().sum(0)
        bound = (m + 64) * 2.0 ** -24 * terms.double().abs().sum(0) + 1e-30
        assert ((got.double() - exact).abs() <= bound).all()
        assert ((want.double() - exact).abs() <= bound).all()


def test_layernorm_bwd_ordered_adds_the_warps_rows_in_order():
    """Small integers sum exactly in any order: the mirror's result is then
    the exact sum, so it drops or repeats no row, also past the last warp."""
    for rows, C in ((1, 8), (37, 16), (1585, 8), (4928, 16)):
        r = np.random.default_rng(rows)
        dh = torch.from_numpy(r.integers(-3, 4, (rows, C)).astype(np.float32))
        x = torch.from_numpy(r.standard_normal((rows, C)).astype(np.float32)).bfloat16()
        db = kernels.layernorm_bwd_ordered(x, torch.ones(C), dh)[2]
        assert torch.equal(db, dh.sum(0))


def _two_layers_jax(p, x, act):
    for l in range(2):
        a, m = p[f"attn{l}"], p[f"mlp{l}"]
        x = jax_fa.fused_ln_attention_block(x, a["lns"], a["lnb"], a["wqkv"], a["bqkv"], a["wout"], a["bout"],
                                            heads=4)
        x = jax_fm.fused_ln_mlp_block(x, m["lns"], m["lnb"], m["wfc"], m["bfc"], m["wproj"], m["bproj"], act=act)
    return x


def _two_layers_torch(p, x, act):
    for l in range(2):
        a, m = p[f"attn{l}"], p[f"mlp{l}"]
        x = fused_attn._FusedAttention.apply(x, a["lns"], a["lnb"], a["wqkv"], a["bqkv"], a["wout"], a["bout"],
                                             None, 4, ORDERED_OPS)
        x = fused_mlp._FusedLNMLP.apply(x, m["lns"], m["lnb"], m["wfc"], m["bfc"], m["wproj"], m["bproj"], act,
                                        ORDERED_OPS)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_layers_layernorm_grads_in_the_kernels_order_match_pallas(dtype):
    B, T, C, E, act = 3, 37, 64, 256, "quick_gelu"
    r = np.random.default_rng(9)
    f = lambda *s, std=1.0: (r.standard_normal(s) * std).astype(np.float32)
    jp, tp = {}, {}
    for l in range(2):
        a = dict(lns=1 + f(C, std=0.1), lnb=f(C, std=0.1), wqkv=f(C, 3, C, std=C ** -0.5),
                 bqkv=f(3, C, std=0.02), wout=f(C, C, std=C ** -0.5), bout=f(C, std=0.02))
        m = dict(lns=1 + f(C, std=0.1), lnb=f(C, std=0.1), wfc=f(C, E, std=C ** -0.5), bfc=f(E, std=0.02),
                 wproj=f(E, C, std=E ** -0.5), bproj=f(C, std=0.02))
        jp[f"attn{l}"], jp[f"mlp{l}"] = ({k: jnp.asarray(v) for k, v in d.items()} for d in (a, m))
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
        tp[f"attn{l}"] = dict(lns=t(a["lns"]), lnb=t(a["lnb"]), wqkv=t(a["wqkv"].reshape(C, 3 * C).T),
                              bqkv=t(a["bqkv"].reshape(-1)), wout=t(a["wout"].T), bout=t(a["bout"]))
        tp[f"mlp{l}"] = dict(lns=t(m["lns"]), lnb=t(m["lnb"]), wfc=t(m["wfc"].T), bfc=t(m["bfc"]),
                             wproj=t(m["wproj"].T), bproj=t(m["bproj"]))
    x, g = f(B, T, C, std=0.5), f(B, T, C)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda p: _two_layers_jax(p, jnp.asarray(x, jdt), act), jp)
    want, = vjp(jnp.asarray(g, jdt))
    out = _two_layers_torch(tp, torch.from_numpy(x).to(tdt), act)
    out.backward(torch.from_numpy(g).to(tdt))
    for blk in tp:
        for k in ("lns", "lnb"):
            got, ref = tp[blk][k].grad.numpy(), np.asarray(want[blk][k].astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-3 * np.abs(ref).max(), err_msg=f"{blk} {k}")
            else:
                rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
                assert rel <= 2e-2, f"{blk} {k}: relative Frobenius error {rel:.3e}"


@pytest.mark.parametrize("case,B,Tq,Tk,H,kind", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_plan_covers_every_query_row_once(case, B, Tq, Tk, H, kind):
    tiles, rows = kernels.flash_fwd_plan(Tq, Tk)
    most = kernels.FLASH_ONE_TILE_Q if Tk <= 64 else kernels.FLASH_MAX_Q
    assert rows % 16 == 0 and 16 <= rows <= most  # whole warps, at most 5 or 8
    assert (tiles - 1) * rows < Tq <= tiles * rows
    assert tiles > 1 or rows - Tq < 16  # one tile: no warp wholly past Tq
    assert tiles == -(-Tq // most)  # the fewest blocks a head can take
    if case.startswith("cross B64"):  # the captioning step: one block of 5 warps per (item, head)
        assert (tiles, rows) == (1, 80)


def test_flash_fwd_plan_covers_any_query_length():
    for Tk in (1, 61, 64, 65, 971):
        most = kernels.FLASH_ONE_TILE_Q if Tk <= 64 else kernels.FLASH_MAX_Q
        for Tq in range(1, 1100):
            tiles, rows = kernels.flash_fwd_plan(Tq, Tk)
            assert rows % 16 == 0 and rows <= most and (tiles - 1) * rows < Tq <= tiles * rows


def _width(name, tower):
    return int(getattr(compose(getattr(chip_smoke, name)).model, tower).width)


@pytest.mark.parametrize("name,tower,T", TRAINED, ids=[f"{n} {t}" for n, t, _ in TRAINED])
def test_layernorm_bwd_cases_cover_every_trained_tower(name, tower, T):
    have = {(rows, C) for _, rows, C in LNB_CASES}
    C = _width(name, tower)
    for B in (64, 16):  # the timed and the counted training steps
        assert (B * T, C) in have, f"{name} {tower}: no layernorm_bwd case at B{B} [{B * T} x {C}]"


def test_layernorm_bwd_cases_hold_the_at_step():
    """The AT step trains the audio tower at its config's batch of 50."""
    B = int(compose(chip_smoke.LA_FULL).running.batch_size)
    assert (B * 306, _width("LA_FULL", "audio")) in {(rows, C) for _, rows, C in LNB_CASES}


def test_layernorm_bwd_cases_hold_the_trimodal_tied_image_tower():
    """The trimodal step trains the image tower's tied encoder at 64 x 50 rows."""
    cfg = compose(chip_smoke.VAL_TIED)
    im = cfg.model.image
    T = 1 + (int(im.resolution) // int(im.pre_encoder.patch_size)) ** 2
    assert (int(cfg.running.batch_size) * T, int(im.width)) in {(rows, C) for _, rows, C in LNB_CASES}


@pytest.mark.parametrize("case,rows,C", LNB_CASES, ids=[c[0] for c in LNB_CASES])
def test_layernorm_bwd_wrapper_takes_the_plain_version_on_the_cpu(case, rows, C):
    x, w, dh, res = _ln_inputs(3 + rows % 29, C // 32, rows)
    kernels.reset_launches()
    for r in (res, None):
        for g, want in zip(kernels.layernorm_bwd(x, w, dh, r), kernels.layernorm_bwd_plain(x, w, dh, r)):
            assert torch.equal(g, want)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("case,B,Tq,Tk,H,kind", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_wrapper_takes_the_plain_version_on_the_cpu(case, B, Tq, Tk, H, kind):
    """A small analogue: batch 2, lengths cut by 8, 2 heads."""
    tq, tk = max(1, Tq // 8), max(1, Tk // 8)
    r = np.random.default_rng(Tq + Tk)
    q, k, v = (torch.from_numpy(r.standard_normal((2, t, 2, 64)).astype(np.float32)).bfloat16()
               for t in (tq, tk, tk))
    bias = None if kind is None else torch.from_numpy(
        np.where(r.random((tq, tk)) < 0.3, -1e30, 0.0).astype(np.float32))
    kernels.reset_launches()
    got = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
    for g, want in zip(got, kernels.flash_attention_fwd_plain(q, k, v, bias, 0.125)):
        assert torch.equal(g, want)
    assert got[0].shape == (2, tq, 2, 64) and got[1].shape == (2, 2, tq)
    assert not kernels.LAUNCHES
