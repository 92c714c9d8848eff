"""Times the redesigned kernels of one checkout at every shape the main
paths launch them, beside the one PyTorch call of the same function, which
is timed here and used nowhere in the port: ``gemm_bias_act`` (``F.linear``),
``attention_bwd`` (autograd through ``scaled_dot_product_attention``),
``gemm_dgrad`` (``torch.matmul``), ``gemm_i8`` (``torch._int_mm``, the
integer product alone), ``attention_fwd``'s streaming form at T > 704
(``scaled_dot_product_attention``), ``layernorm_fwd`` (``F.layer_norm``),
``colsum`` (``torch.sum(..., dtype=torch.float32)``), ``layernorm_bwd``
(autograd through ``F.layer_norm``), ``flash_attention_fwd``
(``scaled_dot_product_attention`` on the [B, H, T, 64] views),
``flash_attention_bwd`` (the autograd backward of that call, as
``chip_smoke._sdpa4`` builds it), ``flash_attention_dbias`` (that backward
taken for a float mask alone), and, with no library call, ``layernorm_rowquant`` at every ``LAYERNORM_CASES`` case
whose rows an int8 tower runs (``INT8_TOWERS``), ``rowquant`` at every
``ROWQUANT_CASES`` case, and the two int8 sub-blocks at audio B64
(``int8_blocks``) beside the bf16 kernel chains of the same sub-blocks.
``gemm_dgrad``, ``gemm_i8``, ``layernorm_fwd``, ``colsum``,
``layernorm_bwd``, ``flash_attention_fwd``, ``flash_attention_bwd``,
``flash_attention_dbias``, ``layernorm_rowquant``, ``rowquant`` and
``int8_blocks`` also print their device time per call
(``chip_smoke.device_us``: the device busy time of 20 calls in a
``torch.profiler`` window), and so does the library call beside the first
eight of those (the two flash backward ops also split by kernel): at the
small shapes (B4, the text tower, the decode, the cross-attention) that is the number to compare, since their timing loops
there are bound by the host. To compare two checkouts on one card, run it
for each in turns (A, B, B, A)::

    python vipant_tpu_torch/experiments/kernel_times.py <checkout root> <label> [kernels]

``kernels``, if given, picks some of ``gemm_bias_act``, ``attention_bwd``,
``gemm_dgrad``, ``gemm_i8``, ``attention_fwd``, ``layernorm_fwd``,
``colsum``, ``layernorm_bwd``, ``flash_attention_fwd``,
``flash_attention_bwd``, ``flash_attention_dbias`` (at the cases with a
bias), ``layernorm_rowquant``, ``rowquant``, ``int8_blocks`` and
``probe_fused_fwd`` (the probe's P2 chain, whose attention is
``flash_attention_fwd``, beside ``F.multi_head_attention_forward``) and
``dot_variant`` (the probe's P1 product at every ``DOT_CASES`` case in
its four orientations, beside ``torch.matmul`` on the same stored
operands, both also in device µs a call), separated by commas; by
default all of them are timed.

It imports the package from the given root, so an older checkout is timed
with its own kernels; the shapes are ``GEMM_FWD_CASES``,
``GEMM_DGRAD_CASES``, ``GEMM_I8_CASES``, ``ATTENTION_STREAMING_T``,
``LAYERNORM_CASES``, ``COLSUM_CASES``, ``LAYERNORM_BWD_CASES``,
``FLASH_CASES``, ``INT8_TOWERS``, ``ROWQUANT_CASES`` and ``DOT_CASES`` of the
``chip_smoke.py`` at the
root of the checkout this script is in, and each line carries the bound
``chip_smoke.bound`` gives it. CUDA-event means over 20 launches after 3
warm-ups, seeded inputs. At the decode shapes of ``gemm_bias_act`` (M <=
256), where a loop of launches is bound by the host, the loop is timed
three times and two more numbers are printed: the device time per call and
the host time per call (the host clock around 200 calls enqueued without
waiting). The backward at B64 T306 is split into its two kernels by a
profiler window.
"""

import importlib.util
import os
import re
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "_chip_smoke_cases", os.path.join(_HERE, os.pardir, os.pardir, "chip_smoke.py"))
_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cases)
GEMMS = _cases.GEMM_FWD_CASES  # (case, M, N, K, activation, residual, fp32 pre-activation)
KERNELS = ("gemm_bias_act", "attention_bwd", "gemm_dgrad", "gemm_i8", "attention_fwd", "layernorm_fwd", "colsum",
           "layernorm_bwd", "flash_attention_fwd", "flash_attention_bwd", "flash_attention_dbias", "layernorm_rowquant", "rowquant", "int8_blocks", "probe_fused_fwd",
           "dot_variant")
ATTENTION = [  # (B, T, C, H, bias)
    (64, 306, 768, 12, "none"), (4, 306, 768, 12, "none"), (64, 77, 512, 8, "causal"),
    (16, 200, 768, 12, "pack"), (1, 308, 512, 8, "causal_pack"),
]


def main() -> None:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    which = sys.argv[3].split(",") if len(sys.argv) > 3 else KERNELS
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from vipant_tpu_torch.nn.layers import causal_mask, pack_tokens
    from vipant_tpu_torch.ops import _build, fused_attn, fused_mlp, kernels

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    F = torch.nn.functional
    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g, device="cuda") * std

    def ms(fn, iters=20, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_us(fn):
        us = _cases.device_us(torch, fn)
        return float("nan") if us is None else us  # nan: the profiler gave no device events

    def host_us(fn, calls=200):
        """host time per call: the host clock around ``calls`` calls that do not wait for the card"""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    def bound(reads, out, ops, kind):
        t, by = _cases.bound(_cases._nbytes(reads) + _cases._nbytes(_cases._outputs(out)), [(ops, kind)])
        return f"bound {t:.4f} ({by[:5]})"

    for case, M, N, K, act, res, pre in GEMMS if "gemm_bias_act" in which else ():
        x, w, b = rn(M, K).bfloat16(), rn(N, K, std=K ** -0.5).bfloat16(), rn(N, std=0.1)
        r, bb = (rn(M, N).bfloat16() if res else None), b.bfloat16()
        call = lambda: kernels.gemm_bias_act(x, w, b, act, r, pre)
        t, lib = ms(call), ms(lambda: F.linear(x, w, bb))
        extra = ""
        if M <= 256:
            loops = [t] + [ms(call) for _ in range(2)]
            extra = (f"; loop {' '.join(f'{v:.4f}' for v in loops)}; device {device_us(call):.2f} us, "
                     f"host {host_us(call):.2f} us a call")
        print(f"{label} gemm_bias_act {case} [{M}x{N}x{K}]: {t:.4f} ms ({2 * M * N * K / t / 1e9:.0f} TFLOP/s); "
              f"F.linear {lib:.4f}; x{t / lib:.2f}{extra}")

    def bias_of(kind, T):
        """None, the causal mask, the block-diagonal mask of 4 packed items
        (T % 4 == 0), or both"""
        if kind == "none":
            return None
        bias = causal_mask(T, device="cuda") if "causal" in kind else 0
        if "pack" in kind:
            bias = bias + pack_tokens(torch.zeros(4, T // 4, 1, device="cuda"), 4)[1]
        return bias

    for B, T, C, H, kind in ATTENTION if "attention_bwd" in which else ():
        qkv, do = rn(B, T, 3 * C).bfloat16(), rn(B, T, C).bfloat16()
        cb = fused_attn.canon_bias(bias_of(kind, T))
        _, st = kernels.attention_fwd(qkv, cb, H, 0.125, stats=True)
        bwd = lambda: kernels.attention_bwd(qkv, do, cb, H, 0.125, st)
        leaves = [t.detach().clone().requires_grad_() for t in qkv.view(B, T, 3, H, 64).permute(2, 0, 3, 1, 4)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=None if cb is None else cb.to(qkv.dtype),
                                             scale=0.125)
        gy = do.view(B, T, H, 64).transpose(1, 2)
        t, lib = ms(bwd), ms(lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True))
        parts = ""
        if (B, T) == (64, 306):
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    bwd()
                torch.cuda.synchronize()
            found = {e.key: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                     for e in prof.key_averages()}
            parts = "; " + ", ".join(f"{k.split('::')[1].split('(')[0].split('<')[0]} {v / 5e3:.4f}"
                                     for k, v in found.items() if "attention_bwd" in k and v)
        print(f"{label} attention_bwd B{B} T{T} H{H} {kind}: {t:.4f} ms; SDPA backward {lib:.4f}; "
              f"x{t / lib:.2f}{parts}")

    for case, M, N, K, act, rounded in _cases.GEMM_DGRAD_CASES if "gemm_dgrad" in which else ():
        dy, w = rn(M, K).bfloat16(), rn(K, N, std=K ** -0.5).bfloat16()
        a = None if act == "none" else rn(M, N)
        y = kernels.gemm_dgrad(dy, w, rounded, act, a)
        call = lambda: kernels.gemm_dgrad(dy, w, rounded, act, a)
        t, lib = ms(call), ms(lambda: torch.matmul(dy, w))
        print(f"{label} gemm_dgrad {case} [{M}x{N}x{K}]: {t:.4f} ms ({2 * M * N * K / t / 1e9:.0f} TFLOP/s); "
              f"torch.matmul {lib:.4f}; x{t / lib:.2f}; {bound((dy, w, a), y, 2 * M * N * K, 'bf16')}; "
              f"device {device_us(call):.2f} us a call")
        del dy, w, a, y

    f32 = torch.float32
    for case, M, N, K, act, res, out_f32, col_first in _cases.GEMM_I8_CASES if "gemm_i8" in which else ():
        (xq, rs), (wq, cs) = kernels.rowquant(rn(M, K)), kernels.rowquant(rn(N, K, std=K ** -0.5))
        b, r = rn(N, std=0.02), (rn(M, N).bfloat16() if res else None)
        kw = dict(act=act, residual=r, out_dtype=f32 if out_f32 else torch.bfloat16, col_first=col_first)
        y = kernels.gemm_i8(xq, rs, wq, cs, b, **kw)
        call = lambda: kernels.gemm_i8(xq, rs, wq, cs, b, **kw)
        t, lib = ms(call), ms(lambda: torch._int_mm(xq, wq.t()))
        print(f"{label} gemm_i8 {case} [{M}x{N}x{K}]: {t:.4f} ms ({2 * M * N * K / t / 1e9:.0f} TOP/s); "
              f"torch._int_mm {lib:.4f}; x{t / lib:.2f}; {bound((xq, rs, wq, cs, b, r), y, 2 * M * N * K, 'int8')}; "
              f"device {device_us(call):.2f} us a call")
        del xq, wq, r, y

    for T in _cases.ATTENTION_STREAMING_T if "attention_fwd" in which else ():
        B, C, H = 16, 768, 12
        qkv = rn(B, T, 3 * C).bfloat16()
        q, k, v = qkv.view(B, T, 3, H, 64).permute(2, 0, 3, 1, 4)
        o = kernels.attention_fwd(qkv, None, H, 0.125)
        t = ms(lambda: kernels.attention_fwd(qkv, None, H, 0.125))
        lib = ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125))
        print(f"{label} attention_fwd B{B} T{T} H{H} streaming: {t:.4f} ms; SDPA {lib:.4f}; x{t / lib:.2f}; "
              f"{bound((qkv,), o, 4 * B * H * T * T * 64, 'bf16')}")

    def with_library(name, case, call, lib, reads, out, ops, lib_name, kind="fp32"):
        t, tl = ms(call), ms(lib)
        print(f"{label} {name} {case}: {t:.4f} ms; {lib_name} {tl:.4f}; x{t / tl:.2f}; {bound(reads, out, ops, kind)}; "
              f"device {device_us(call):.2f} us a call, {lib_name} {device_us(lib):.2f}")

    for case, M, C in _cases.LAYERNORM_CASES if "layernorm_fwd" in which else ():
        x, w, b = rn(M, C).bfloat16(), 1 + rn(C, std=0.1), rn(C, std=0.1)
        wb, bb = w.bfloat16(), b.bfloat16()
        with_library("layernorm_fwd", f"{case} [{M}x{C}]", lambda: kernels.layernorm_fwd(x, w, b),
                     lambda: F.layer_norm(x, (C,), wb, bb), (x, w, b), x, 8 * M * C, "F.layer_norm")

    for case, M, N, dtype in _cases.COLSUM_CASES if "colsum" in which else ():
        x = rn(M, N).to(torch.float32 if dtype == "fp32" else torch.bfloat16)
        with_library("colsum", f"{case} [{M}x{N} {dtype}]", lambda: kernels.colsum(x),
                     lambda: x.sum(0, dtype=torch.float32), (x,), kernels.colsum_plain(x), M * N, "torch.sum")
        del x

    for case, M, C in _cases.LAYERNORM_BWD_CASES if "layernorm_bwd" in which else ():
        x, w, dh, res = rn(M, C).bfloat16(), 1 + rn(C, std=0.1), rn(M, C), rn(M, C).bfloat16()
        leaves = [x.detach().clone().requires_grad_(), w.bfloat16().requires_grad_(),
                  torch.zeros(C, dtype=torch.bfloat16, device="cuda", requires_grad=True)]
        y, gy = F.layer_norm(leaves[0], (C,), leaves[1], leaves[2]), dh.bfloat16()
        with_library("layernorm_bwd", f"{case} [{M}x{C}]", lambda: kernels.layernorm_bwd(x, w, dh, res),
                     lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True), (x, w, dh, res),
                     x, 20 * M * C, "F.layer_norm autograd")
        del x, dh, res, leaves, y, gy

    for case, B, Tq, Tk, H, kind in _cases.FLASH_CASES if "flash_attention_fwd" in which else ():
        q, k, v = rn(B, Tq, H, 64).bfloat16(), rn(B, Tk, H, 64).bfloat16(), rn(B, Tk, H, 64).bfloat16()
        bias = _cases.flash_bias(torch, kind, Tq)
        mask = None if bias is None else bias.to(q.dtype)
        o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
        with_library("flash_attention_fwd", case, lambda: kernels.flash_attention_fwd(q, k, v, bias, 0.125),
                     lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                            attn_mask=mask, scale=0.125),
                     (q, k, v, bias, lse), o, 4 * B * H * Tq * Tk * 64, "SDPA", "bf16")
        del q, k, v, o, lse

    def by_kernel(fn, calls=20):
        """device µs a call of each kernel ``fn`` launches, from one profiler window"""
        try:
            _, _, seen = _cases._profile(torch, fn, calls)
        except AssertionError:
            return "no device events"
        name = lambda k: (re.findall(r"\w+_kernel", k) or [k[:28]])[0]
        return ", ".join(f"{name(k)} {ms * 1e3 / calls:.2f}" for k, (n, ms) in seen.items())

    flash_bwd, flash_dbias = "flash_attention_bwd" in which, "flash_attention_dbias" in which
    for case, B, Tq, Tk, H, kind in _cases.FLASH_CASES if flash_bwd or flash_dbias else ():
        q, k, v, do = (rn(B, T, H, 64).bfloat16() for T in (Tq, Tk, Tk, Tq))
        bias = _cases.flash_bias(torch, kind, Tq)
        o, lse = kernels.flash_attention_fwd(q, k, v, bias, 0.125)
        _, lib_bwd, lib_dbias = _cases._sdpa4(torch, q, k, v, bias)
        bwd = lambda: kernels.flash_attention_bwd(q, k, v, bias, o, lse, do, 0.125)
        grads = bwd()
        if flash_bwd:
            with_library("flash_attention_bwd", case, bwd, lib_bwd(do), (q, k, v, bias, o, lse, do), grads,
                         _cases.flash_ops(B, Tq, Tk, H, 5)[0][0], "SDPA autograd bwd", "bf16")
            print(f"{label} flash_attention_bwd {case}: by kernel, device us a call: {by_kernel(bwd)}")
        if flash_dbias and bias is not None:
            dbias = lambda: kernels.flash_attention_dbias(q, k, v, bias, lse, grads[3], do, 0.125)
            lib = lib_dbias(do)
            with_library("flash_attention_dbias", case, dbias, lib if lib is not None else dbias,
                         (q, k, v, bias, lse, grads[3], do), dbias(), _cases.flash_ops(B, Tq, Tk, H)[0][0],
                         "SDPA bias bwd" if lib is not None else "(no library call: the kernel again)", "bf16")
            print(f"{label} flash_attention_dbias {case}: by kernel, device us a call: {by_kernel(dbias)}")
        del q, k, v, do, o, lse, grads

    int8_rows = {(M, C) for _, M, C in _cases.INT8_TOWERS}
    for case, M, C in _cases.LAYERNORM_CASES if "layernorm_rowquant" in which else ():
        if (M, C) not in int8_rows:
            continue
        x, w, b = rn(M, C).bfloat16(), 1 + rn(C, std=0.1), rn(C, std=0.1)
        call = lambda: kernels.layernorm_rowquant(x, w, b)
        q, s = call()
        print(f"{label} layernorm_rowquant {case} [{M}x{C}]: {ms(call):.4f} ms; "
              f"{bound((x, w, b), (q, s), 12 * M * C, 'fp32')}; device {device_us(call):.2f} us a call")
        del x, q

    for case, M, K, dtype in _cases.ROWQUANT_CASES if "rowquant" in which else ():
        x = (rn(M, K) * 3).to(torch.float32 if dtype == "fp32" else torch.bfloat16)
        call = lambda: kernels.rowquant(x)
        q, s = call()
        print(f"{label} rowquant {case} [{M}x{K} {dtype}]: {ms(call):.4f} ms; "
              f"{bound((x,), (q, s), 4 * M * K, 'fp32')}; device {device_us(call):.2f} us a call")
        del x, q

    for case, B, T, C in (("audio B64 T306 C768", 64, 306, 768),) if "int8_blocks" in which else ():
        x, lns, lnb = rn(B, T, C).bfloat16(), 1 + rn(C, std=0.1), rn(C, std=0.1)
        wqkv, bqkv = rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.02)
        wout, bout = rn(C, C, std=C ** -0.5), rn(C, std=0.02)
        wfc, bfc = rn(4 * C, C, std=C ** -0.5), rn(4 * C, std=0.02)
        wproj, bproj = rn(C, 4 * C, std=(4 * C) ** -0.5), rn(C, std=0.02)
        a_args = (x, lns, lnb, wqkv, bqkv, wout, bout, None, C // 64)
        m_args = (x, lns, lnb, wfc, bfc, wproj, bproj, "quick_gelu")
        for name, int8, bf16 in (("fused_ln_attention_block_int8", lambda: fused_attn.fused_ln_attention_block_int8(*a_args),
                                  lambda: fused_attn.fused_ln_attention_block(*a_args)),
                                 ("fused_ln_mlp_block_int8", lambda: fused_mlp.fused_ln_mlp_block_int8(*m_args),
                                  lambda: fused_mlp.fused_ln_mlp_block(*m_args))):
            print(f"{label} {name} {case}: {ms(int8, 10):.4f} ms; bf16 chain {ms(bf16, 10):.4f}; "
                  f"device {device_us(int8):.2f} us a call, bf16 chain {device_us(bf16):.2f}")
        del x

    for case, M, K, N in _cases.DOT_CASES if "dot_variant" in which else ():
        for name, (ta, tb) in kernels.ORIENTATIONS.items():
            a, b = rn(*((K, M) if ta else (M, K))).bfloat16(), rn(*((N, K) if tb else (K, N))).bfloat16()
            call = lambda: kernels.dot_variant(a, b, name)
            lib = lambda: torch.matmul(a.t() if ta else a, b.t() if tb else b)
            t, tl = ms(call), ms(lib)
            tb_ms, by = _cases.bound(_cases._nbytes((a, b, call())), _cases.gemm_ops(M, N, K))
            print(f"{label} dot_variant {name} {case}: {t:.4f} ms; torch.matmul {tl:.4f}; "
                  f"bound {tb_ms * 1e3:.3f} us ({by[:5]}); "
                  f"device {device_us(call):.2f} us a call, torch.matmul {device_us(lib):.2f}")
        del a, b

    if "probe_fused_fwd" in which:
        from vipant_tpu_torch.experiments import fused_block_probe as probe

        args = probe.make_inputs(device="cuda")
        x, wqkv, bqkv, wout, bout = args
        B, T, C = x.shape
        xt = x.transpose(0, 1)
        mha = lambda: F.multi_head_attention_forward(xt, xt, xt, C, probe.H, wqkv, bqkv.to(x.dtype), None, None,
                                                     False, 0.0, wout, bout.to(x.dtype), need_weights=False)
        call = lambda: probe.probe_fused_fwd(*args)
        t, tl = ms(call, 10), ms(mha, 10)
        print(f"{label} probe_fused_fwd B{B} T{T} C{C} H{probe.H}: {t:.4f} ms; F.multi_head_attention_forward "
              f"{tl:.4f}; x{t / tl:.2f}; device {device_us(call):.2f} us a call, library {device_us(mha):.2f}")


if __name__ == "__main__":
    main()
