"""Schedules of ``flash_attention_fwd`` tried against each other on one card::

    python vipant_tpu_torch/experiments/flash_fwd_variants.py [--plan-only]

Each variant is ``csrc/flash_attention.cu`` with its launch bounds replaced
(``VARIANTS`` below: the blocks an SM each of the kernel's three instances
is compiled for, which caps its registers), built alone with ``nvcc`` into
``build/flash_fwd_variants/`` and called through its C entry point on
preallocated tensors, so the host cost of the Python wrapper is left out.
Each is timed at every shape of ``chip_smoke.FLASH_CASES`` with the query
rows of a block as ``kernels.flash_fwd_plan`` gives them and, unless
``--plan-only``, at the smaller blocks in ``ROWS``. Printed: the register report of each instance, then per
shape and block size the device time per call (``chip_smoke.device_us``) of
each variant and of ``scaled_dot_product_attention``. Every variant is held
to the plain version (atol = rtol = 2e-2 on o, 1e-3 relative on lse) before
it is timed.
"""
import ctypes
import importlib.util
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
OUT = ROOT / "build" / "flash_fwd_variants"
CSRC = ROOT / "vipant_tpu_torch" / "csrc"
BOUNDS = "kMode == kOneTile ? 4 : 1)"
VARIANTS = {  # name -> blocks an SM for kOneTile, then for kResident and kStreaming
    "kept": None,
    "onetile3": "kMode == kOneTile ? 3 : 1)",
    "onetile5": "kMode == kOneTile ? 5 : 1)",
    "resident2": "kMode == kOneTile ? 4 : kMode == kResident ? 2 : 1)",
}
ROWS = (64, 48, 32, 16)  # query rows a block, tried beside the plan's where smaller


def build(name, bounds):
    text = (CSRC / "flash_attention.cu").read_text()
    assert BOUNDS in text
    if bounds is not None:
        text = text.replace(BOUNDS, bounds)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    so = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC.resolve()}", "-shared", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def registers(out):
    """``mode: registers, spill stores`` of each flash_fwd_kernel instance in a ptxas report"""
    lines, found = out.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "flash_fwd_kernel" in line:
            mode = line.split("KvModeE")[1][0]
            spill = lines[i + 2].split(",")[1].strip()
            found.append(f"mode {mode}: {lines[i + 3].split(':')[-1].split(',')[0].strip()}, {spill}")
    return "; ".join(sorted(found))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_variants: needs a CUDA device")
    plan_only = "--plan-only" in sys.argv[1:]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {n: build(n, b) for n, b in VARIANTS.items()}
    libs = {}
    for n, (so, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(n, out[-3000:])
            raise SystemExit(1)
        print(f"{n}: {registers(out)}")
        lib = ctypes.CDLL(str(so))
        lib.vt_flash_attention_fwd.argtypes = _build._SIGNATURES["vt_flash_attention_fwd"]
        libs[n] = lib.vt_flash_attention_fwd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    F = torch.nn.functional
    for case, B, Tq, Tk, H, kind in _cs.FLASH_CASES:
        q, kk, v = (torch.randn(B, T, H, 64, generator=g, device="cuda").bfloat16() for T in (Tq, Tk, Tk))
        bias = _cs.flash_bias(torch, kind, Tq)
        o0, lse0 = k.flash_attention_fwd_plain(q, kk, v, bias, 0.125)
        strides = (ctypes.c_longlong * 9)(*(s for t in (q, kk, v) for s in t.stride()[:3]))
        o, lse = torch.empty_like(o0), torch.empty_like(lse0)
        plan = k.flash_fwd_plan(Tq, Tk)[1]
        mask = None if bias is None else bias.to(q.dtype)
        sdpa = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                                                      attn_mask=mask, scale=0.125)
        for rows in (plan,) if plan_only else (plan, *(r for r in ROWS if r < plan)):
            line = [f"{case} rows {rows}{' (plan)' if rows == plan else ''}:"]
            for n, fn in libs.items():
                call = lambda: fn(q.data_ptr(), kk.data_ptr(), v.data_ptr(), strides,
                                  None if bias is None else bias.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                  B, Tq, Tk, H, 0.125, rows, stream)
                assert call() == 0
                torch.cuda.synchronize()
                assert torch.allclose(o.float(), o0.float(), atol=2e-2, rtol=2e-2), (n, case, rows)
                assert (lse - lse0).abs().max().item() <= 1e-3 * lse0.abs().max().item(), (n, case, rows)
                us = _cs.device_us(torch, call)
                line.append(f"{n} {float('nan') if us is None else us:.2f}")
            us = _cs.device_us(torch, sdpa)
            line.append(f"SDPA {float('nan') if us is None else us:.2f}")
            print(" ".join(line), flush=True)
        del q, kk, v, o, lse, o0, lse0


if __name__ == "__main__":
    main()
