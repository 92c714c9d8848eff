"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use, never at import, by ``nvcc`` into
one shared library with a plain C interface, and loaded with ``ctypes``.
Each source compiles in its own ``nvcc`` process, all started together,
then one more links them::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
        -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   # each source
    nvcc -shared -o libvipant_kernels.so *.o

The library lands in ``build/vipant_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded from the previous build. The
compiler's register and spill report (``-Xptxas -v``) is kept there as
``build.log``. A failed build raises; nothing falls back.

:func:`once` and :func:`build_shared` are also the native host fbank's
(``vipant_tpu_torch/native``): a process builds or loads each library once,
its threads waiting for the first, and processes that build at once each
write their own temp file and move it into place whole.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vipant_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argtypes; each returns a cudaError_t as int
_SIGNATURES = {
    "vt_layernorm_fwd": [_P, _P, _P, _P, _L, _I, _F, _P],
    "vt_layernorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _P],
    "vt_gemm_bias_act": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vt_gemm_dgrad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vt_gemm_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vt_colsum": [_P, _I, _P, _P, _L, _I, _I, _I, _P],
    "vt_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "vt_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "vt_attention_fwd_f32": [_P, _P, _P, _I, _I, _I, _F, _P],
    "vt_rowquant": [_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "vt_layernorm_rowquant": [_P, _P, _P, _P, _P, _L, _I, _F, _P],
    "vt_gemm_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "vt_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _F, _I, _I, _P],
    "vt_flash_attention_dbias": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _F, _I, _I, _P],
    "vt_dot_variant": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vt_dot_plan": [_I, _I, _I, _P],  # fills int[3]: the launch vt_dot_variant makes (kernels.dot_plan)
    "vt_patch_gather": [_P, _I, _L, _L, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA kernels "
            "are built from source at first use and need the CUDA toolkit"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def once(fn):
    """``fn()`` run once in a process and its result kept (an exception is
    not kept: the next call runs ``fn`` again). Threads that call while it
    runs wait for it, so a library is never built or loaded twice at once.
    ``cache_clear()`` forgets the result."""
    lock = threading.Lock()
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call():
        with lock:
            return cached()

    call.cache_clear = cached.cache_clear
    return call


def build_shared(lib_path: Path, compile_fn: Callable[[Path], Tuple[bool, str]],
                 signatures: Dict[str, List]) -> ctypes.CDLL:
    """Load the shared library at ``lib_path``, first built by
    ``compile_fn(tmp)`` if it is not there yet, and give each C entry point
    of ``signatures`` its argtypes (each returns an int). ``compile_fn``
    writes the library to ``tmp`` and returns (whether it succeeded, its
    transcript); the transcript goes to ``build.log`` beside the library and
    the seconds to ``build_seconds``. ``tmp`` is unique to the call and is
    moved into place whole, so a process never loads a half-written
    library. Raises ``RuntimeError`` with the transcript on a failed build.
    Call it from a function wrapped in :func:`once`."""
    if not lib_path.exists():
        out_dir = lib_path.parent
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, name = tempfile.mkstemp(dir=out_dir, prefix=f"{lib_path.stem}.", suffix=".tmp.so")
        os.close(fd)
        tmp = Path(name)
        t0 = time.perf_counter()
        try:
            ok, log = compile_fn(tmp)
            (out_dir / "build.log").write_text(log)
            if not ok:
                raise RuntimeError(f"building {lib_path.name} failed:\n{log}")
            os.replace(tmp, lib_path)
        finally:
            tmp.unlink(missing_ok=True)
        (out_dir / "build_seconds").write_text(f"{time.perf_counter() - t0}\n")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _compile_and_link(tmp: Path) -> Tuple[bool, str]:
    """One ``nvcc -c`` per source, run together, then the link into
    ``tmp``: (whether all succeeded, the whole transcript)."""
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        failed = failed or proc.returncode != 0
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}")
        failed = proc.returncode != 0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    return not failed, "\n".join(log)


@once
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet. Kept for the life of the process."""
    lib = build_shared(build_dir() / "libvipant_kernels.so", _compile_and_link, _SIGNATURES)
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.vt_error_string(err).decode()})")
