"""Schedules of ``dot_variant`` tried against each other on one card::

    python vipant_tpu_torch/experiments/dot_variant_sweep.py [variant,...]

Each variant is ``csrc/dot_variants.cu`` with some lines replaced
(``VARIANTS`` below): ``bn128`` output tiles 128 wide (12 blocks at the
probe's shape, against the kept 24 of 64 x 64); ``bk64``, ``bk256`` stages
of 64 or 256 k (kept: 128); ``stages2``, ``stages6`` that many stages in
shared memory at once (kept: 4); ``prefetch`` the tensor maps asked for
first; ``divide`` the ring's slot and phase taken by dividing the step by
the stage count at each step (kept: counted); ``spin`` barrier waits that
spin on ``test_wait`` (kept: ``try_wait``); and the knock-outs ``x_...``,
which leave out the stores, the loads, the products or everything after
the launch (``x_empty``), after the barriers' set-up (``x_init``), or all
but the barriers and stores (``x_bare``), to show what the time is made
of; those are not held to the plain version. A variant given as
``name=path`` is another version of the source file (an earlier commit's,
say), built as it is. Each is built alone with ``nvcc`` into
``build/dot_variant_sweep/`` and called through its C entry point on
preallocated tensors, so the host cost of the Python wrapper is left out.
At every ``chip_smoke.DOT_CASES`` case and orientation, each variant is
held to the plain version (max |d| <= 1e-3) and timed in device µs a call
(``chip_smoke.device_us``), beside ``torch.matmul`` on the same stored
operands. Printed first: the registers, stack frame and spills of each
kernel instance of each variant (``-Xptxas -v``).
"""
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from vipant_tpu_torch.ops import _build, kernels as k  # noqa: E402

_spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)
OUT = ROOT / "build" / "dot_variant_sweep"
CSRC = ROOT / "vipant_tpu_torch" / "csrc"
STAGES = "constexpr int kMaxStages = 4;"
BK = "constexpr int BK = 128;"
INIT = "  if (threadIdx.x == 0) {\n    for (int s = 0; s < stages; ++s) {"
PREFETCH = "".join(f'    if (stages > 0) asm volatile("prefetch.tensormap [%0];" ::"l"(&map_{x}) : "memory");\n'
                   for x in "ab")
SPIN = """__device__ __forceinline__ void spin_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\\n.reg .pred p;\\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                 "selp.u32 %0, 1, 0, p;\\n}\\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (done == 0);
}
"""
NO_LOAD = "__device__ __forceinline__ void no_load(uint32_t, const CUtensorMap*, uint32_t, int, int) {}\n"
STORE = "*reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8 * h) * N + col) ="
VARIANTS = {  # name -> the replacements of lines of the kept source
    "kept": [],
    "bn128": [("constexpr int BN = 64; ", "constexpr int BN = 128;"), ("wgmma_m64n64k16<", "wgmma_m64n128k16<")],
    "stages2": [(STAGES, "constexpr int kMaxStages = 2;")],
    "stages6": [(STAGES, "constexpr int kMaxStages = 6;")],
    "bk64": [(BK, "constexpr int BK = 64; ")],
    "bk256": [(BK, "constexpr int BK = 256;"), (STAGES, "constexpr int kMaxStages = 2;")],
    "prefetch": [(INIT, INIT.replace("{\n", "{\n" + PREFETCH, 1))],
    "divide": [("    if (++slot == stages) slot = 0, parity ^= 1;",  # the ring's place by division, each step
                "    slot = (it + 1) % stages, parity = ((it + 1) / stages) & 1;"),
               ("    if (++fill == stages) fill = 0, fill_parity ^= 1;",
                "    fill = next % stages, fill_parity = ((next / stages) & 1) ^ 1;")],
    # knock-outs, timed without the check against the plain version: what the time is made of (no
    # stores; no loads, the stage barriers passed at once; no products)
    "x_nostore": [(STORE, "if (acc[4 * j + 2 * h] == 1.2345f) *reinterpret_cast<float2*>(out) =")],
    "x_noload": [("using namespace hopper;\n", "using namespace hopper;\n" + NO_LOAD),
                 ("mbar_expect_tx(bar, kStageBytes);", "mbar_arrive(bar);"), ("tma_load(", "no_load(")],
    "x_nomma": [("      wgmma_m64n64k16<", "      if (K < 0) wgmma_m64n64k16<")],
    "x_empty": [("  extern __shared__", "  if (K >= 0) return;\n  extern __shared__")],
    "spin": [("using namespace hopper;\n", "using namespace hopper;\n" + SPIN), ("mbar_wait(", "spin_wait(")],
}
VARIANTS["x_bare"] = VARIANTS["x_noload"] + VARIANTS["x_nomma"]
VARIANTS["x_bare_nostore"] = VARIANTS["x_bare"] + VARIANTS["x_nostore"]
VARIANTS["x_init"] = VARIANTS["x_noload"] + [("  __syncthreads();\n\n  float acc", "  __syncthreads();\n  if (K >= 0) return;\n  float acc")]


def build(name, edits, source=CSRC / "dot_variants.cu"):
    text = Path(source).read_text()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    so = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC.resolve()}", "-shared", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def registers(out):
    """``<TA, TB, BN>: registers, stack frame, spill stores`` of each instance in a ptxas report"""
    lines, found = out.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "dot_variant_kernel" in line:
            args = re.search(r"dot_variant_kernelI(\w+?)EEv", line)
            frame = lines[i + 2].split(":")[-1].strip()
            regs = lines[i + 3].split(":")[-1].split(",")[0].strip()
            found.append(f"<{args.group(1) if args else '?'}>: {regs}, {frame}")
    return "; ".join(found)


def _us(fn):
    us = _cs.device_us(torch, fn)
    return float("nan") if us is None else us


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dot_variant_sweep: needs a CUDA device")
    args = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for arg in args:
        name, _, path = arg.partition("=")
        jobs[name] = build(name, [], path) if path else build(name, VARIANTS[name])
    libs = {}
    for n, (so, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(n, out[-3000:])
            raise SystemExit(1)
        print(f"{n}: {registers(out)}")
        lib = ctypes.CDLL(str(so))
        lib.vt_dot_variant.argtypes = _build._SIGNATURES["vt_dot_variant"]
        libs[n] = lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for case, M, K, N in _cs.DOT_CASES:
        for name, (ta, tb) in k.ORIENTATIONS.items():
            a = torch.randn(*((K, M) if ta else (M, K)), generator=g, device="cuda").bfloat16()
            b = torch.randn(*((N, K) if tb else (K, N)), generator=g, device="cuda").bfloat16()
            want = k.dot_variant_plain(a, b, name)
            got = torch.empty_like(want)
            line = [f"{name} {case} (plan {tuple(k.dot_plan(M, N, K))}):"]
            for n, lib in libs.items():
                call = lambda: lib.vt_dot_variant(a.data_ptr(), b.data_ptr(), got.data_ptr(), M, N, K, ta, tb,
                                                  stream)
                got.fill_(float("nan"))
                assert call() == 0
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                assert n.startswith("x_") or err <= 1e-3, (n, name, case, err)
                line.append(f"{n} {_us(call):.2f}")
            lib_call = lambda: torch.matmul(a.t() if ta else a, b.t() if tb else b)
            line.append(f"torch.matmul {_us(lib_call):.2f}")
            print(" ".join(line), flush=True)


if __name__ == "__main__":
    main()
