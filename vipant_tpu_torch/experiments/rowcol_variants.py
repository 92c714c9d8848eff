"""Schedules of ``layernorm_fwd`` and ``colsum`` tried against each other on
one card, and where the host time of a wrapper call goes::

    python vipant_tpu_torch/experiments/rowcol_variants.py

Each variant is the kernel's source (``csrc/layernorm.cu`` or
``csrc/reduce.cu``) with a few lines replaced (``LN``, ``CS`` below), built
alone with ``nvcc`` into ``build/rowcol_variants/`` and called through its C
entry point on preallocated tensors, so the host cost of the Python wrapper
is left out. ``layernorm_fwd``: the persistent grid with the next row in
flight (as kept), one row per warp (a grid of every row), the persistent
grid without the prefetch, and 8 warps a block; ``colsum``: 2, 4 or 8 rows
in flight a lane, each at a row split aiming at 1, 2 (as kept) or 4 blocks
an SM. Printed per shape: the device time per call (``chip_smoke.device_us``)
of each variant and of the library call, and the host time per call of the
wrapper and of the library call (host clock around 300 calls that do not
wait for the card). Last, the host µs of each step of a wrapper call.
Every variant is held to the plain version (bitwise to ``colsum_ordered``
at the kept split) before it is timed.
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


def build(name, src, subs):
    text = (CSRC / src).read_text()
    for a, b in subs:
        assert a in text, (name, a)
        text = text.replace(a, b)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    so = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC.resolve()}", "-shared", "-o", str(so), str(cu)]
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
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {n: build(n, "layernorm.cu", s) for n, s in LN.items()}
    jobs.update({n: build(n, "reduce.cu", s) for n, s in CS.items()})
    libs = {}
    for n, (so, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(n, out[-3000:])
            raise SystemExit(1)
        libs[n] = ctypes.CDLL(str(so))
    _P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g, device="cuda") * std
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    F = torch.nn.functional
    for rows, C in [(19584, 768), (1224, 768), (3200, 768), (4928, 512), (308, 512), (64, 512), (4, 512)]:
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
                        (4928, 512, torch.bfloat16), (4928, 2048, torch.bfloat16), (4928, 1536, torch.float32), (1224, 768, torch.bfloat16)]:
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
