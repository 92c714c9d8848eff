#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vipant_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi); fails without CUDA.
2. Builds the CUDA kernels from ``vipant_tpu_torch/csrc`` and prints the
   build time and the compiler's register / spill report.
3. Kernel phase: each hand-written kernel and each fused sub-block, at the
   serving path's shapes, against its plain PyTorch version on the card
   from the same seeded bf16 inputs (atol = rtol = 2e-2 on bf16 outputs:
   one bf16 ulp of the output plus a different fp32 summation order), with
   CUDA-event times of both.
4. Slice phase: the full-size CLAP serving engine (ViT-B/32 audio tower at
   T = 306, 12-layer width-512 text tower packed 4 captions per call at
   T = 308) with seeded random weights: embed_audio over 6 fbanks at
   batch 4 (one ragged chunk), embed_texts, zero_shot over 3 classes.
   Checks finite unit-norm outputs, the launch counts of every sub-block of
   both towers, and cosine >= 0.999 against the same engine on the plain
   ops on the card; prints ms per batch.

Prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ATOL = RTOL = 2e-2
COS_MIN = 0.999
BATCH = 4
CLAP_FULL = [
    "+running=clotho", "+model/image=vit_val", "+model/audio=vit_val",
    "+model/text=transformer_val", "+model/loss=ce", "+optimizer=standard",
    "+running/audio=default", "model.audio.pre_encoder.stride=[16,24]",
    "running.audio.max_len=1000", "worker=CLAP", "model_file=",
]
PROMPTS = ["the sound of a dog barking", "heavy rain on a roof", "a car passing by",
           "birds singing in the morning", "people talking in a crowded room"]
CLASSES = {
    "dog": ["the sound of a dog", "a dog barking"],
    "rain": ["the sound of rain", "rain falling"],
    "car": ["the sound of a car"],
}
REPLACES = {
    "layernorm_fwd": "vipant_tpu/ops/fused_attn.py:81",
    "gemm_bias_act": "vipant_tpu/ops/fused_mlp.py:51",
    "attention_fwd": "vipant_tpu/ops/fused_attn.py:81",
    "fused_ln_attention_block": "vipant_tpu/ops/fused_attn.py:81",
    "fused_ln_mlp_block": "vipant_tpu/ops/fused_mlp.py:51",
}
SOURCES = {
    "layernorm_fwd": "vipant_tpu_torch/csrc/layernorm.cu",
    "gemm_bias_act": "vipant_tpu_torch/csrc/gemm.cu",
    "attention_fwd": "vipant_tpu_torch/csrc/attention.cu",
    "fused_ln_attention_block": "vipant_tpu_torch/ops/fused_attn.py",
    "fused_ln_mlp_block": "vipant_tpu_torch/ops/fused_mlp.py",
}


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(torch, results):
    from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
    from vipant_tpu_torch.ops import fused_attn, fused_mlp, kernels

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def compare(name, case, fn, plain):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        ok = torch.allclose(got.float(), want.float(), atol=ATOL, rtol=RTOL)
        finite = bool(torch.isfinite(got).all())
        tp1 = cuda_ms(torch, plain)
        tk1 = cuda_ms(torch, fn)
        tk2 = cuda_ms(torch, fn)
        tp2 = cuda_ms(torch, plain)
        ms, plain_ms = (tk1 + tk2) / 2, (tp1 + tp2) / 2
        print(f"  {name:26s} {case:34s} max|d|={d.max().item():.3e} mean|d|="
              f"{d.mean().item():.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if not (ok and finite):
            raise AssertionError(f"{name} {case}: kernel disagrees with its plain version "
                                 f"(max|d| {d.max().item():.3e}, finite {finite})")
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], d.max().item())
        r["cases"].append({"case": case, "ms": ms, "plain_ms": plain_ms})

    pack_bias = lambda T, k: pack_tokens(torch.zeros(k, T, 1, device=dev), k)[1]
    text_bias = causal_mask(4 * 77, device=dev) + pack_bias(77, 4)
    attn_cases = [  # (case, B, T, C, H, bias): audio, packed text, packed image
        ("audio B4 T306 C768 H12", BATCH, 306, 768, 12, None),
        ("text B1 T308 C512 H8 causal+pack", 1, 308, 512, 8, text_bias),
        ("image B1 T200 C768 H12 pack", 1, 200, 768, 12, pack_bias(50, 4)),
    ]
    for case, B, T, C, H, bias in attn_cases:
        x = rn(B, T, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        wqkv, bqkv = rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.02, dtype=torch.float32)
        wout, bout = rn(C, C, std=C ** -0.5), rn(C, std=0.02, dtype=torch.float32)
        cb = fused_attn.canon_bias(bias)
        h = kernels.layernorm_plain(x, lns, lnb)
        qkv = kernels.gemm_bias_act_plain(h, wqkv, bqkv)
        o = kernels.attention_plain(qkv, cb, H, 0.125)
        args = (x, lns, lnb, wqkv, bqkv, wout, bout, bias, H)
        compare("layernorm_fwd", case, lambda: kernels.layernorm_fwd(x, lns, lnb),
                lambda: kernels.layernorm_plain(x, lns, lnb))
        compare("gemm_bias_act", case + " qkv", lambda: kernels.gemm_bias_act(h, wqkv, bqkv),
                lambda: kernels.gemm_bias_act_plain(h, wqkv, bqkv))
        compare("attention_fwd", case, lambda: kernels.attention_fwd(qkv, cb, H, 0.125),
                lambda: kernels.attention_plain(qkv, cb, H, 0.125))
        compare("gemm_bias_act", case + " out+res",
                lambda: kernels.gemm_bias_act(o, wout, bout, residual=x),
                lambda: kernels.gemm_bias_act_plain(o, wout, bout, residual=x))
        compare("fused_ln_attention_block", case,
                lambda: fused_attn.fused_ln_attention_block(*args),
                lambda: fused_attn.fused_ln_attention_block_plain(*args))

    for case, B, T, C in (("audio B4 T306 C768 E3072", BATCH, 306, 768),
                          ("text B1 T308 C512 E2048", 1, 308, 512)):
        E = 4 * C
        x = rn(B, T, C)
        lns, lnb = 1 + rn(C, std=0.1, dtype=torch.float32), rn(C, std=0.1, dtype=torch.float32)
        wfc, bfc = rn(E, C, std=C ** -0.5), rn(E, std=0.02, dtype=torch.float32)
        wproj, bproj = rn(C, E, std=E ** -0.5), rn(C, std=0.02, dtype=torch.float32)
        h = kernels.layernorm_plain(x, lns, lnb)
        args = (x, lns, lnb, wfc, bfc, wproj, bproj, "quick_gelu")
        compare("gemm_bias_act", case + " fc+quick_gelu",
                lambda: kernels.gemm_bias_act(h, wfc, bfc, "quick_gelu"),
                lambda: kernels.gemm_bias_act_plain(h, wfc, bfc, "quick_gelu"))
        compare("gemm_bias_act", case + " fc+gelu",
                lambda: kernels.gemm_bias_act(h, wfc, bfc, "gelu"),
                lambda: kernels.gemm_bias_act_plain(h, wfc, bfc, "gelu"))
        compare("fused_ln_mlp_block", case, lambda: fused_mlp.fused_ln_mlp_block(*args),
                lambda: fused_mlp.fused_ln_mlp_block_plain(*args))


def slice_phase(torch, results):
    from vipant_tpu_torch.ops import LAUNCHES, fused_attn, fused_mlp, reset_launches
    from vipant_tpu_torch.serve import InferenceEngine

    t0 = time.perf_counter()
    eng = InferenceEngine(CLAP_FULL, batch_size=BATCH, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"engine built in {time.perf_counter() - t0:.2f} s (seeded random weights)")
    audio_layers = len(eng.model.audio.encoder.resblocks)
    text_layers = len(eng.model.text.encoder.resblocks)
    fb = np.random.default_rng(0).standard_normal((6, 1000, 128)).astype(np.float32)
    nchunks = lambda n: -(-n // BATCH)
    n_prompts = sum(len(v) for v in CLASSES.values())

    # the main path: these launches are the ones that count
    reset_launches()
    a = eng.embed_audio(fb)
    t = eng.embed_texts(PROMPTS)
    zs = eng.zero_shot(fb[:3], CLASSES)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"launches on the main path: {json.dumps(counts, sort_keys=True)}")

    audio_chunks, text_chunks = nchunks(6) + nchunks(3), nchunks(len(PROMPTS)) + nchunks(n_prompts)
    blocks = audio_layers * audio_chunks + text_layers * text_chunks
    want = {
        "fused_ln_attention_block": blocks,
        "fused_ln_mlp_block": blocks,
        "layernorm_fwd": 2 * blocks,
        "gemm_bias_act": 4 * blocks,
        "attention_fwd": blocks,
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    for name, n in counts.items():
        results.setdefault(name, {"max_abs_err": 0.0, "cases": []})["launches"] = n

    for name, e, n in (("audio", a, 6), ("text", t, len(PROMPTS))):
        if e.shape != (n, eng._embed_dim()) or not np.isfinite(e).all():
            raise AssertionError(f"{name} embeddings: shape {e.shape}, finite {np.isfinite(e).all()}")
        norms = np.linalg.norm(e, axis=-1)
        if np.abs(norms - 1).max() > 1e-2:
            raise AssertionError(f"{name} embeddings are not unit-norm: {norms}")
    if zs["scores"].shape != (3, len(CLASSES)) or not np.allclose(zs["probs"].sum(1), 1, atol=1e-5):
        raise AssertionError(f"zero_shot output malformed: {zs}")
    print(f"zero_shot predictions: {zs['prediction']}")

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    ms = {"audio": timed(lambda: eng.embed_audio(fb[:BATCH])),
          "text": timed(lambda: eng.embed_texts(PROMPTS[:BATCH]))}

    # the same engine on the plain ops, on the card
    with mock.patch.object(fused_attn, "fused_ln_attention_block",
                           fused_attn.fused_ln_attention_block_plain), \
         mock.patch.object(fused_mlp, "fused_ln_mlp_block", fused_mlp.fused_ln_mlp_block_plain):
        a_ref, t_ref = eng.embed_audio(fb), eng.embed_texts(PROMPTS)
        plain_ms = {"audio": timed(lambda: eng.embed_audio(fb[:BATCH])),
                    "text": timed(lambda: eng.embed_texts(PROMPTS[:BATCH]))}
    for name, e, r in (("audio", a, a_ref), ("text", t, t_ref)):
        cos = (e * r).sum(-1) / (np.linalg.norm(e, axis=-1) * np.linalg.norm(r, axis=-1))
        print(f"{name} embedding cosine vs plain ops on the card: min {cos.min():.6f}")
        if cos.min() < COS_MIN:
            raise AssertionError(f"{name} cosine {cos.min()} < {COS_MIN}")
    for k in ms:
        print(f"{k}: {ms[k]:.3f} ms per batch of {BATCH} (kernels), "
              f"{plain_ms[k]:.3f} ms (plain ops)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from vipant_tpu_torch.ops import _build  # fails outside a checkout of the repo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({_build.build_dir()})")
    log = (_build.build_dir() / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  " + line.strip())

    results: dict = {}
    print("kernel phase (kernel vs plain PyTorch on the card):")
    kernel_phase(torch, results)
    print("slice phase (full-size CLAP serving engine):")
    slice_phase(torch, results)

    line = {"kernels": []}
    for name in ("layernorm_fwd", "gemm_bias_act", "attention_fwd",
                 "fused_ln_attention_block", "fused_ln_mlp_block"):
        r = results[name]
        main_case = r["cases"][0]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
        })
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
