"""The work counts against a hand count at a tiny size, and at the published
widths."""

import json

import pytest

from perfbench.harness import spec
from perfbench.work import counts

TINY = {"kind": "vit", "frozen": False, "width": 8, "layers": 1, "heads": 2, "embed_dim": 4,
        "patch": [2, 2], "stride": [2, 2], "in_channels": 3, "input": [1, 4, 4]}


def _cfg(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_a_tiny_tower_matches_the_hand_count():
    # grid 2 x 2: P = 4 patches, T = 5 tokens, K = 1 * 2 * 2 (the kernel's channel mean), C = 8
    # forward: patch 2*4*4*8 = 256, qkv 2*5*8*24 = 1920, scores and p.v 2 * 2*25*8 = 800,
    # out 2*5*8*8 = 640, fc and proj 2 * 2*5*8*32 = 5120, projection 2*8*4 = 64
    fwd = 256 + 1920 + 800 + 640 + 5120 + 64
    # backward: each product twice (data and weight grads) but the patch (weights only)
    # and attention's four products (4 * 400); the projection's two 64s
    bwd = 2 * (1920 + 640 + 5120) + 4 * 400 + 128 + 256
    assert counts.product_flops(counts.tower_ops(TINY, 1, train=False)) == fwd == 8800
    assert counts.product_flops(counts.tower_ops(TINY, 1, train=True)) == fwd + bwd == 26144
    assert counts.product_flops(counts.tower_ops(TINY, 3, train=True)) == 3 * 26144
    qkv = next(op for op in counts.tower_ops(TINY, 1, train=False) if op.name == "qkv")
    assert qkv.bytes == 5 * 8 * 2 + 8 * 24 * 4 + 5 * 24 * 2  # bf16 in, fp32 weight, bf16 out
    causal = dict(TINY, kind="text", ctx_len=4, vocab_size=10, frozen=True)
    att = next(op for op in counts.tower_ops(causal, 1, train=False) if op.name == "attention")
    assert att.flops == 2 * 2 * (4 * 5 / 2) * 8  # two products over the 10 causal pairs


def test_the_va_clip_at_the_published_widths():
    cfg = _cfg("va_vitb32")
    per_clip = counts.product_flops(counts.train_step_ops(cfg, 432)) / 432
    assert per_clip == pytest.approx(176.076e9, rel=1e-5)
    # bench.py's arithmetic (3x forward for the audio tower, 306 tokens, a 16*24-input patch)
    # gives 175.66: the patch here is the kernel's 32*32 inputs over 305 patches, trained
    # by its weight grad alone, with the projection and the loss's products added
    C, L = 768, 12

    def tower_fwd(T):
        return T * (L * (24 * C * C + 4 * T * C))

    bench = 3 * (tower_fwd(306) + 306 * 2 * C * 384) + tower_fwd(50) + 50 * 2 * C * 3072
    assert bench == pytest.approx(175.66e9, rel=1e-4)
    assert per_clip == pytest.approx(bench, rel=3e-3)


def test_the_clap_clip_and_the_embed_batch_at_the_published_widths():
    cfg = _cfg("clap_vitb32")
    audio = counts.product_flops(counts.tower_ops(cfg["towers"]["audio"], 1, train=True))
    text = counts.product_flops(counts.tower_ops(cfg["towers"]["text"], 1, train=False))
    assert audio == pytest.approx(167.26e9, rel=1e-4) and text == pytest.approx(5.888e9, rel=1e-3)
    assert counts.product_flops(counts.embed_ops(cfg, "audio", 64)) / 64 == pytest.approx(55.91e9, rel=1e-4)


def test_the_least_time_is_the_larger_bound_of_each_op():
    ops = [counts.Op("a", 989e12, 0.0, True), counts.Op("b", 0.0, 3.35e12, False),
           counts.Op("c", 989e9, 3.35e9 * 2, True)]
    assert counts.least_seconds(ops) == pytest.approx(1 + 1 + 2e-3)
