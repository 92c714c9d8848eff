"""Schedules of ``flash_attention_bwd`` and ``flash_attention_dbias`` tried
against each other on one card::

    python vipant_tpu_torch/experiments/flash_bwd_variants.py [variant,...]

A variant given as ``name=path`` is another version of the source file
(an earlier commit's, say), built as it is.

Each variant is ``csrc/flash_attention.cu`` with some lines replaced
(``VARIANTS`` below: the keys or queries the backward takes per step, the
blocks an SM each kernel is compiled for, which caps its registers), built
alone with ``nvcc`` into ``build/flash_bwd_variants/`` and called through
its C entry points on preallocated tensors, so the host cost of the Python
wrapper is left out. Each is timed at every shape of
``chip_smoke.FLASH_CASES`` with the blocks of ``kernels.flash_bwd_plan``,
and the bias grad at the cases with a bias with the chunks of
``kernels.dbias_split`` and with the chunks of ``DBIAS_BLOCKS_PER_SM``
blocks an SM. Printed: the register report of each backward kernel of each
variant, then per shape the device time per call (``chip_smoke.device_us``)
of each variant and of the library call (SDPA's autograd backward, and its
backward for a float mask, as ``chip_smoke._sdpa4`` builds them). Every
variant is held to the plain version (atol = rtol = 2e-2 on dq, dk, dv,
1e-2 of the largest value on delta and the bias grad) before it is timed,
except the knock-outs (``x_...``), which leave out a part of the work to
show what the time is made of.
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
OUT = ROOT / "build" / "flash_bwd_variants"
CSRC = ROOT / "vipant_tpu_torch" / "csrc"
CHUNK = "constexpr int kChunk = 2;"
DQ = "kMode == kOneTile ? 4 : 2)\nflash_bwd_dq_kernel"
DKV = "__launch_bounds__(kDkvMaxKeys * 2, 4) flash_bwd_dkv_kernel"
ZERO = "for (int z = 0; z < kChunk; ++z) {0}[z][0] = {0}[z][1] = {0}[z][2] = {0}[z][3] = 0.f;"
VARIANTS = {  # name -> the replacements of lines of the kept source
    "kept": [],
    "chunk4": [(CHUNK, "constexpr int kChunk = 4;")],
    "dq3": [(DQ, DQ.replace("4 : 2)", "3 : 2)"))],
    "dkv3": [(DKV, DKV.replace("4)", "3)"))],
    # knock-outs, timed without the check against the plain version: what the bias grad's time is
    # made of (no exponential; no products; no loads after the first head's)
    "x_noexp": [("return expf(s - lse);", "return s - lse;")],
    "x_nomma": [("scores(s, qf, Ks + c * 8 * kChunk * LDH, lane);", ZERO.format("s")),
                ("scores(dp, dof, Vs + c * 8 * kChunk * LDH, lane);", ZERO.format("dp"))],
    "x_noload": [("if (bh + 1 < bh1) stage_dbias_head(", "if (false) stage_dbias_head(")],
}
DBIAS_BLOCKS_PER_SM = (1, 2, 3)


def build(name, edits, source=CSRC / "flash_attention.cu"):
    text = Path(source).read_text()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    so = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC.resolve()}", "-shared", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


MODES = {"KvModeE0": " one tile", "KvModeE1": " resident", "KvModeE2": " streaming",
         "ILb1": " resident", "ILb0": " streaming"}  # the dq instances, by their mangled template argument


def registers(out):
    """``kernel: registers, spill stores`` of each backward kernel in a ptxas report"""
    lines, found = out.splitlines(), []
    for i, line in enumerate(lines):
        for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_dbias_kernel"):
            if "Compiling entry" in line and name in line:
                mode = next((m for key, m in MODES.items() if key in line), "")
                spill = lines[i + 2].split(",")[1].strip()
                regs = lines[i + 3].split(":")[-1].split(",")[0].strip()
                found.append(f"{name}{mode}: {regs}, {spill}")
    return "; ".join(found)


def _us(torch, fn):
    us = _cs.device_us(torch, fn)
    return float("nan") if us is None else us


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: needs a CUDA device")
    args = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for arg in args:  # a variant of the kept source, or name=path: another version of the file as it is
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
        for fn in ("vt_flash_attention_bwd", "vt_flash_attention_dbias"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        libs[n] = lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for case, B, Tq, Tk, H, kind in _cs.FLASH_CASES:
        q, kk, v, do = (torch.randn(B, T, H, 64, generator=g, device="cuda").bfloat16() for T in (Tq, Tk, Tk, Tq))
        bias = _cs.flash_bias(torch, kind, Tq)
        o, lse = k.flash_attention_fwd_plain(q, kk, v, bias, 0.125)
        want = k.flash_attention_bwd_plain(q, kk, v, bias, o, lse, do, 0.125)
        strides = (ctypes.c_longlong * 9)(*(s for t in (q, kk, v) for s in t.stride()[:3]))
        got = [torch.empty_like(t) for t in want]  # dq, dk, dv, delta
        plan = k.flash_bwd_plan(Tq, Tk)
        bp = None if bias is None else bias.data_ptr()
        _, lib_bwd, lib_dbias = _cs._sdpa4(torch, q, kk, v, bias)
        line = [f"bwd {case} (q rows {plan.q_rows}, keys {plan.k_rows}):"]
        for n, lib in libs.items():
            call = lambda: lib.vt_flash_attention_bwd(
                q.data_ptr(), kk.data_ptr(), v.data_ptr(), strides, bp, o.data_ptr(), lse.data_ptr(),
                do.data_ptr(), got[3].data_ptr(), got[0].data_ptr(), got[1].data_ptr(), got[2].data_ptr(),
                B, Tq, Tk, H, 0.125, plan.q_rows, plan.k_rows, stream)
            assert call() == 0
            torch.cuda.synchronize()
            if not n.startswith("x_"):
                for a, w in zip(got[:3], want[:3]):
                    assert torch.allclose(a.float(), w.float(), atol=2e-2, rtol=2e-2), (n, case)
                assert (got[3] - want[3]).abs().max().item() <= 1e-2 * want[3].abs().max().item(), (n, case)
            line.append(f"{n} {_us(torch, call):.2f}")
        line.append(f"SDPA {_us(torch, lib_bwd(do)):.2f}")
        print(" ".join(line), flush=True)
        if bias is not None:
            db0 = k.flash_attention_dbias_plain(q, kk, v, bias, lse, want[3], do, 0.125)
            db = torch.empty_like(db0)
            line = [f"dbias {case}:"]
            for per_sm in DBIAS_BLOCKS_PER_SM:
                tiles = -(-Tq // k.FLASH_TILE) * -(-Tk // k.FLASH_TILE)
                per = -(-B * H // max(1, min(B * H, -(-per_sm * k.SM_COUNT // tiles))))
                chunks = -(-B * H // per)
                partial = torch.empty((chunks, Tq, Tk), dtype=torch.float32, device="cuda")
                for n, lib in libs.items():
                    call = lambda: lib.vt_flash_attention_dbias(
                        q.data_ptr(), kk.data_ptr(), v.data_ptr(), strides, bp, lse.data_ptr(),
                        want[3].data_ptr(), do.data_ptr(), partial.data_ptr(), db.data_ptr(), B, Tq, Tk, H,
                        0.125, chunks, per, stream)
                    assert call() == 0
                    torch.cuda.synchronize()
                    assert n.startswith("x_") or (db - db0).abs().max().item() <= 1e-2 * db0.abs().max().item(), (n, case)
                    tag = " (plan)" if (chunks, per) == k.dbias_split(B * H, Tq, Tk) else ""
                    line.append(f"{n}/{per_sm} an SM, {chunks * tiles} blocks{tag} {_us(torch, call):.2f}")
            lib = lib_dbias(do)
            line.append(f"SDPA {float('nan') if lib is None else _us(torch, lib):.2f}")
            print(" ".join(line), flush=True)
        del q, kk, v, do, o, lse, want, got


if __name__ == "__main__":
    main()
