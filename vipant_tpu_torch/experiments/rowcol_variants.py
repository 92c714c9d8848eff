"""Schedules of ``layernorm_fwd``, ``colsum``, ``layernorm_bwd``,
``rowquant`` and ``layernorm_rowquant`` tried against each other on one
card, and where the host time of a wrapper call goes::

    python vipant_tpu_torch/experiments/rowcol_variants.py [families]

``families``, if given, picks some of ``ln``, ``cs``, ``lnb``, ``rq`` and
``host``, separated by commas; by default all of them run.

Each variant is the kernel's source (``csrc/layernorm.cu``,
``csrc/reduce.cu`` or ``csrc/quant.cu``) with a few lines replaced (``LN``,
``CS``, ``LNB``, ``RQ``, ``LNQ`` below), built with ``nvcc`` (``layernorm.cu`` beside ``reduce.cu``, whose
``colsum`` its backward calls) into ``build/rowcol_variants/`` and called
through its C entry point on preallocated tensors, so the host cost of the
Python wrapper is left out. ``layernorm_fwd``: the persistent grid with the
next row in flight (as kept), one row per warp (a grid of every row), the
persistent grid without the prefetch, and 8 warps a block; ``colsum``: 2, 4
or 8 rows in flight a lane, each at a row split aiming at 1, 2 (as kept) or
4 blocks an SM; ``layernorm_bwd``: a warp per row with the next row in
flight and w in shared memory (as kept), without the prefetch at the same
or at a higher residency, with 2 warps a block, and with w read through L1
instead of shared memory, each on its own grid plan; ``rowquant``: as
kept (``kernels.rowquant_plan``), without the next row in flight, a whole
row in one warp (up to 24 vectors a lane), a row of one warp's instance
over two warps, 8 or 4 blocks an SM, every code by the division, and a
division branch for each value instead of each load (``RQ``);
``layernorm_rowquant``: as kept, w and b read through L1 for each row (as
compiled, or asking for 6 or 8 blocks an SM), every code by the division, a branch for each
value, and without the next row in flight (``LNQ``); the register report
of every ``rowquant`` instance. Printed per shape: the
device time per call (``chip_smoke.device_us``) of each variant and of the
library call, and the host time per call of the wrapper and of the library
call (host clock around 300 calls that do not wait for the card). Last, the
host µs of each step of a wrapper call. Every variant is held to the plain
version (bitwise to ``colsum_ordered``, or for ``layernorm_bwd``'s db to
``layernorm_bwd_ordered``, at the kept plan; the int8 codes and scales
bitwise, to ``rowquant_plain`` or to ``rowquant(layernorm_fwd(x))``)
before it is timed.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from vipant_tpu_torch.ops import _build, kernels as k  # noqa: E402

_spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)
OUT = ROOT / "build" / "rowcol_variants"
CSRC = ROOT / "vipant_tpu_torch" / "csrc"
LN = {
    "ln_persistent": [],
    "ln_row_per_warp": [("need < cap ? need : cap", "need")],
    "ln_persistent_noprefetch": [("rows::load_row(x + (row + stride) * C, C, lane, row + stride < n_rows, next);",
                                  "rows::load_row(x + (row + stride) * C, C, lane, false, next);"),
                                 ("    const float2 st = rows::warp_row_stats(v, C, lane, eps);",
                                  "    rows::load_row(x + row * C, C, lane, true, v);\n    const float2 st = rows::warp_row_stats(v, C, lane, eps);")],
    "ln_8warps": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 8;")],
}
CS = {
    "cs_u8": [],
    "cs_u4": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
    "cs_u2": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 2;")],
}
_PREFETCH = "static constexpr bool kPrefetch = kVecs <= 3;"
_PER_SM = "static constexpr int kBlocksPerSM = kVecs <= 2 ? 4 : kVecs <= 4 ? 3 : 2;"
_WARPS = "constexpr int kBwdWarps = 4;"
# layernorm_bwd: (substitutions, warps a block, blocks an SM at C <= 512 and at C = 768) for the grid plan
LNB = {
    "lnb_kept": ([], 4, 4, 3),
    "lnb_noprefetch": ([(_PREFETCH, "static constexpr bool kPrefetch = false;")], 4, 4, 3),
    "lnb_noprefetch_4blocks": ([(_PREFETCH, "static constexpr bool kPrefetch = false;"),
                                (_PER_SM, "static constexpr int kBlocksPerSM = kVecs <= 4 ? 4 : 2;")], 4, 4, 4),
    "lnb_2warps": ([(_WARPS, "constexpr int kBwdWarps = 2;"),
                    (_PER_SM, "static constexpr int kBlocksPerSM = kVecs <= 2 ? 8 : kVecs <= 4 ? 6 : 4;")], 2, 8, 6),
    "lnb_w_from_l1": ([("const float4* w4 = reinterpret_cast<const float4*>(smem);",
                        "const float4* w4 = reinterpret_cast<const float4*>(w);")], 4, 4, 3),
}


_RQ_PREFETCH = "static constexpr bool kPrefetch = kVecs > 0 && kVecs <= 8;"
_RQ_PER_SM = "static constexpr int kBlocksPerSM = kVecs <= 2 ? 8 : kVecs <= 4 ? 6 : 4;"
_RQ_SHAPES = "{2, 8}, {4, 6}, {4, 0}};"
_RQ_ONE_WARP = (1, 2, 3, 4, 6, 8, 12, 16, 24)  # loads a lane, one warp a row
_RQ_PRODUCT = "      for (int k = 0; k < L::kN; ++k) c[k] = code_by_product(f[k], r, proven);\n      if (!proven) {"
_RQ_DIVIDE_ALL = [(_RQ_PRODUCT, "      if (true) {")]  # every code by the division
_RQ_BRANCH_PER_VALUE = [(_RQ_PRODUCT, "      for (int k = 0; k < L::kN; ++k) {\n"
                                      "        bool ok = true;\n"
                                      "        c[k] = code_by_product(f[k], r, ok);\n"
                                      "        if (!ok) c[k] = code_by_division(f[k], s);\n"
                                      "      }\n      if (false) {")]  # a division branch for each value
# rowquant: (substitutions, warps a row or None for the kept plan's, blocks an SM or None for the kept)
RQ = {
    "rq_kept": ([], None, None),
    "rq_noprefetch": ([(_RQ_PREFETCH, "static constexpr bool kPrefetch = false;")], None, None),
    "rq_one_warp": ([(_RQ_SHAPES, "{2, 8}, {4, 6}, {4, 0}, {1, 1}, {1, 8}, {1, 12}, {1, 16}, {1, 24}};")], 1, None),
    "rq_more_warps": ([(_RQ_SHAPES, "{2, 8}, {4, 6}, {4, 0}, {2, 2}, {2, 3}, {2, 4}, {2, 6}};")], 2, None),
    "rq_8_blocks": ([(_RQ_PER_SM, "static constexpr int kBlocksPerSM = 8;")], None, 8),
    "rq_divide_all": (_RQ_DIVIDE_ALL, None, None),
    "rq_branch_per_value": (_RQ_BRANCH_PER_VALUE, None, None),
    "rq_4_blocks": ([(_RQ_PER_SM, "static constexpr int kBlocksPerSM = 4;")], None, 4),
}
_LNQ_W_L1 = [  # w and b read through L1 for each row, not held in registers
    ("  float wl[kVecs][8], bl[kVecs][8];  // w and b of this lane's columns\n  rows::load_affine(w, b, C, lane, wl, bl);\n",
     ""),
    ("        rows::unpack8(v[i], f);\n        unsigned u[4];",
     "        rows::unpack8(v[i], f);\n        float wl[1][8], bl[1][8];\n"
     "        { const float4* w4 = reinterpret_cast<const float4*>(w) + 2 * (lane + 32 * i);\n"
     "          const float4* b4 = reinterpret_cast<const float4*>(b) + 2 * (lane + 32 * i);\n"
     "          const float4 w0 = __ldg(w4), w1 = __ldg(w4 + 1), b0 = __ldg(b4), b1 = __ldg(b4 + 1);\n"
     "          const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};\n"
     "          const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};\n"
     "          for (int k = 0; k < 8; ++k) wl[0][k] = wa[k], bl[0][k] = ba[k]; }\n        unsigned u[4];"),
    ("wl[i][2 * k]", "wl[0][2 * k]"), ("bl[i][2 * k]", "bl[0][2 * k]"),
    ("wl[i][2 * k + 1]", "wl[0][2 * k + 1]"), ("bl[i][2 * k + 1]", "bl[0][2 * k + 1]"),
]
_LNQ_BOUNDS = "__launch_bounds__(kBlockWarps * 32)\nlayernorm_rowquant_kernel"
# layernorm_rowquant: the kept kernel, without the next row in flight, dividing every value, w and b
# through L1 (at the register budget of 5, 6 or 8 blocks an SM)
LNQ = {
    "lnq_kept": [],
    "lnq_w_l1": _LNQ_W_L1,
    "lnq_w_l1_6_blocks": _LNQ_W_L1 + [(_LNQ_BOUNDS, "__launch_bounds__(kBlockWarps * 32, 6)\nlayernorm_rowquant_kernel")],
    "lnq_w_l1_8_blocks": _LNQ_W_L1 + [(_LNQ_BOUNDS, "__launch_bounds__(kBlockWarps * 32, 8)\nlayernorm_rowquant_kernel")],
    "lnq_divide_all": _RQ_DIVIDE_ALL,
    "lnq_branch_per_value": _RQ_BRANCH_PER_VALUE,
    "lnq_noprefetch": [("rows::load_row(x + (row + stride) * C, C, lane, row + stride < n_rows, next);",
                        "rows::load_row(x + (row + stride) * C, C, lane, false, next);"),
                       ("    const float2 st = rows::warp_row_stats(v, C, lane, eps);\n    float m = 0.f;",
                        "    rows::load_row(x + row * C, C, lane, true, v);\n"
                        "    const float2 st = rows::warp_row_stats(v, C, lane, eps);\n    float m = 0.f;")],
}


def build(name, src, subs):
    text = (CSRC / src).read_text()
    for a, b in subs:
        assert a in text, (name, a)
        text = text.replace(a, b)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    so = OUT / f"{name}.so"
    extra = [str(CSRC / "reduce.cu")] if src == "layernorm.cu" else []
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC.resolve()}", "-shared", "-o", str(so), str(cu), *extra]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def device_us(fn):
    us = _cs.device_us(torch, fn)
    return float("nan") if us is None else us  # nan: the profiler gave no device events


def host_us(fn, calls=300):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rowcol_variants: needs a CUDA device")
    families = sys.argv[1].split(",") if len(sys.argv) > 1 else ["ln", "cs", "lnb", "rq", "host"]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {n: build(n, "layernorm.cu", s) for n, s in LN.items() if "ln" in families}
    jobs.update({n: build(n, "reduce.cu", s) for n, s in CS.items() if "cs" in families})
    jobs.update({n: build(n, "layernorm.cu", v[0]) for n, v in LNB.items() if "lnb" in families})
    jobs.update({n: build(n, "quant.cu", v[0]) for n, v in RQ.items() if "rq" in families})
    jobs.update({n: build(n, "quant.cu", v) for n, v in LNQ.items() if "rq" in families})
    libs = {}
    for n, (so, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(n, out[-3000:])
            raise SystemExit(1)
        if n.startswith("rq"):  # the register report of every rowquant instance
            lines = out.splitlines()
            print(n, "; ".join(line.split("Compiling entry function '")[1].split("'")[0][-40:] + ": "
                               + " ".join(x.split(":")[-1].strip() for x in lines[i + 2:i + 4])
                               for i, line in enumerate(lines) if "Compiling entry" in line and "rowquant" in line))
        if n.startswith("lnb"):  # the register report of the backward at the paths' widths (2, 3 vectors a lane)
            lines = out.splitlines()
            print(n, "; ".join(f"{v} vectors: " + " ".join(x.split(":")[-1].strip() for x in lines[i + 2:i + 4])
                               for i, line in enumerate(lines) for v in (2, 3)
                               if "Compiling entry" in line and f"layernorm_bwd_kernelILi{v}E" in line))
        libs[n] = ctypes.CDLL(str(so))
    _P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g, device="cuda") * std
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    F = torch.nn.functional
    for rows, C in [(19584, 768), (1224, 768), (3200, 768), (4928, 512), (308, 512), (64, 512), (4, 512)] * ("ln" in families):
        x, w, b = rn(rows, C).bfloat16(), 1 + rn(C, std=0.1), rn(C, std=0.1)
        y = torch.empty_like(x)
        ref = k.layernorm_plain(x, w, b)
        wb, bb = w.bfloat16(), b.bfloat16()
        row = [f"LN {rows}x{C}:"]
        for n in LN:
            fn = libs[n].vt_layernorm_fwd
            fn.argtypes = [_P, _P, _P, _P, _L, _I, _F, _P]
            call = lambda: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), rows, C, 1e-5, stream)
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.allclose(y.float(), ref.float(), atol=2e-2, rtol=2e-2), n
            row.append(f"{n} {device_us(call):.2f}")
        row.append(f"F.layer_norm {device_us(lambda: F.layer_norm(x, (C,), wb, bb)):.2f}")
        row.append(f"| wrapper host {host_us(lambda: k.layernorm_fwd(x, w, b)):.1f} us, F.layer_norm host {host_us(lambda: F.layer_norm(x, (C,), wb, bb)):.1f}")
        print(" ".join(row), flush=True)
    for rows, N, dt in [(19584, 768, torch.bfloat16), (19584, 3072, torch.bfloat16), (19584, 2304, torch.float32),
                        (4928, 512, torch.bfloat16), (4928, 2048, torch.bfloat16), (4928, 1536, torch.float32),
                        (1224, 768, torch.bfloat16)] * ("cs" in families):
        x = rn(rows, N).to(dt)
        ref = k.colsum_ordered(x)
        row = [f"colsum {rows}x{N} {str(dt)[6:]}:"]
        for n in CS:
            fn = libs[n].vt_colsum
            fn.argtypes = [_P, _I, _P, _P, _L, _I, _I, _I, _P]
            for target in (1, 2, 4):
                strips = -(-N * x.element_size() // k.COLSUM_STRIP)
                S = max(1, min(-(-target * k.SM_COUNT // strips), -(-rows // k.COLSUM_MIN_ROWS)))
                per = -(-(-(-rows // S)) // k.COLSUM_WARPS) * k.COLSUM_WARPS
                S = -(-rows // per)
                part, out = torch.empty(S, N, device="cuda"), torch.empty(N, device="cuda")
                call = lambda: fn(x.data_ptr(), int(dt == torch.float32), part.data_ptr(), out.data_ptr(), rows, N, S, per, stream)
                assert call() == 0
                torch.cuda.synchronize()
                if target == 2:
                    assert torch.equal(out, ref), n
                else:
                    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item(), n
                row.append(f"{n}/x{target}(S{S}) {device_us(call):.2f}")
        row.append(f"torch.sum {device_us(lambda: x.sum(0, dtype=torch.float32)):.2f}")
        row.append(f"| wrapper host {host_us(lambda: k.colsum(x)):.1f} us, torch.sum host {host_us(lambda: x.sum(0, dtype=torch.float32)):.1f}")
        print(" ".join(row), flush=True)

    for _, rows, C in _cs.LAYERNORM_BWD_CASES * ("lnb" in families):
        x, w, dh, res = rn(rows, C).bfloat16(), 1 + rn(C, std=0.1), rn(rows, C), rn(rows, C).bfloat16()
        dx = torch.empty_like(x)
        want = k.layernorm_bwd_plain(x, w, dh, res)
        db_ordered = k.layernorm_bwd_ordered(x, w, dh, res)[2]
        row = [f"LNB {rows}x{C}:"]
        for n, (_, warps, sm_narrow, sm_768) in LNB.items():
            fn = libs[n].vt_layernorm_bwd
            fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _P]
            per = -(-rows // (k.SM_COUNT * (sm_narrow if C <= 512 else sm_768) * warps))
            blocks = -(-(-(-rows // per)) // warps)
            S, cs_rows = k.colsum_split(blocks, 2 * C, 4)
            buf = torch.empty((1 + blocks + S) * 2 * C, device="cuda")
            p = buf.data_ptr()
            call = lambda: fn(x.data_ptr(), w.data_ptr(), dh.data_ptr(), res.data_ptr(), dx.data_ptr(), p + 8 * C,
                              p + 8 * C * (1 + blocks), p, rows, C, per, blocks, S, cs_rows, 1e-5, stream)
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.allclose(dx.float(), want[0].float(), atol=2e-2, rtol=2e-2), n
            for got, ref in ((buf[:C], want[1]), (buf[C:2 * C], want[2])):
                assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item(), n
            if n == "lnb_kept":
                assert torch.equal(buf[C:2 * C], db_ordered), n
            row.append(f"{n}(R{per}) {device_us(call):.2f}")
        leaves = [x.detach().clone().requires_grad_(), w.bfloat16().requires_grad_(),
                  torch.zeros(C, dtype=torch.bfloat16, device="cuda", requires_grad=True)]
        y = F.layer_norm(leaves[0], (C,), leaves[1], leaves[2])
        gy = dh.bfloat16()
        lib = lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)
        row.append(f"F.layer_norm autograd {device_us(lib):.2f}")
        row.append(f"| wrapper host {host_us(lambda: k.layernorm_bwd(x, w, dh, res)):.1f} us, autograd host {host_us(lib):.1f}")
        print(" ".join(row), flush=True)
        del x, dh, res, dx, buf, leaves, y, gy
    for rows, K, dt in [(19584, 3072, torch.float32), (19584, 768, torch.float32), (4928, 2048, torch.float32),
                        (1224, 3072, torch.float32), (3072, 768, torch.float32), (768, 3072, torch.float32),
                        (2304, 768, torch.bfloat16), (19584, 768, torch.bfloat16)] * ("rq" in families):
        x = (rn(rows, K) * 3).to(dt)
        q, sc = torch.empty(rows, K, dtype=torch.int8, device="cuda"), torch.empty(rows, device="cuda")
        want = k.rowquant_plain(x)
        plan = k.rowquant_plan(rows, K, x.element_size())
        row = [f"rowquant {rows}x{K} {str(dt)[6:]}:"]
        for n, (_, warps, per_sm) in RQ.items():
            fn = libs[n].vt_rowquant
            fn.argtypes = [_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P]
            w, v = plan.warps, plan.vecs
            if warps == 1:
                w, v = 1, next(u for u in _RQ_ONE_WARP if 32 * u * plan.per_load >= K)
            elif warps == 2 and plan.warps == 1:  # a row of one warp's instance over two warps
                w, v = 2, next(u for u in (2, 3, 4, 6, 8) if 64 * u * plan.per_load >= K)
            per_sm = per_sm or k.rowquant_blocks_per_sm(v)
            blocks = min(-(-rows // (k.ROWQUANT_BLOCK_WARPS // w)), k.SM_COUNT * per_sm)
            call = lambda: fn(x.data_ptr(), int(dt == torch.float32), q.data_ptr(), sc.data_ptr(), rows, K,
                              plan.per_load, w, v, blocks, stream)
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.equal(q, want[0]) and torch.equal(sc, want[1].view(-1)), n
            row.append(f"{n}({w}x{v}, {blocks} blocks) {device_us(call):.2f}")
        row.append(f"| wrapper host {host_us(lambda: k.rowquant(x)):.1f} us")
        print(" ".join(row), flush=True)
        del x, q
    for rows, C in [(19584, 768), (4928, 512), (1224, 768), (308, 512)] * ("rq" in families):
        x, w, b = rn(rows, C).bfloat16(), 1 + rn(C, std=0.1), rn(C, std=0.1)
        q, sc = torch.empty(rows, C, dtype=torch.int8, device="cuda"), torch.empty(rows, device="cuda")
        want = k.rowquant(k.layernorm_fwd(x, w, b))
        row = [f"layernorm_rowquant {rows}x{C}:"]
        for n in LNQ:
            fn = libs[n].vt_layernorm_rowquant
            fn.argtypes = [_P, _P, _P, _P, _P, _L, _I, _F, _P]
            call = lambda: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), q.data_ptr(), sc.data_ptr(), rows, C, 1e-5,
                              stream)
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.equal(q, want[0]) and torch.equal(sc, want[1].view(-1)), n
            row.append(f"{n} {device_us(call):.2f}")
        row.append(f"| wrapper host {host_us(lambda: k.layernorm_rowquant(x, w, b)):.1f} us")
        print(" ".join(row), flush=True)
        del x, q
    if "host" not in families:
        return

    # where the wrapper's host time goes
    x, w, b = rn(1224, 768).bfloat16(), 1 + rn(768, std=0.1), rn(768, std=0.1)
    y = torch.empty_like(x)
    dev = x.device
    lib = _build.library()

    def guard():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.empty(N)": lambda: torch.empty(768, dtype=torch.float32, device=dev),
        "_cuda_operand": lambda: k._cuda_operand(x, "x", torch.bfloat16, dev),
        "_param_vector": lambda: k._param_vector(w, "w", 768, dev),
        "torch.cuda.device(dev) guard": guard,
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(dev.index or 0),
        "torch.cuda.current_device": lambda: torch.cuda.current_device(),
        "_build.library()": lambda: _build.library(),
        "x.data_ptr()": lambda: x.data_ptr(),
        "ctypes vt_layernorm_fwd": lambda: lib.vt_layernorm_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                                                1224, 768, 1e-5, stream),
        "k.layernorm_fwd": lambda: k.layernorm_fwd(x, w, b),
        "k.colsum": lambda: k.colsum(x),
    }
    print("host us a call: " + "; ".join(f"{n} {host_us(f, 1000):.2f}" for n, f in pieces.items()))


if __name__ == "__main__":
    main()
