"""The C++ host audio frontend: WAV decode and the Kaldi log-mel fbank.

The port's own copy of ``vipant_tpu/native``: ``fbank.cc`` is that
package's source byte for byte, and these are its ctypes bindings
(``vipant_tpu/native/__init__.py:28-127``). The build differs. The library
is compiled from ``fbank.cc`` at first use, never at import, with the host
C++ compiler (``$CXX``, else ``g++``) and the JAX package's ``Makefile``
flags::

    g++ -O3 -fPIC -shared -std=c++17 -o libvipant_audio.so fbank.cc

into ``build/vipant_tpu_torch_native/<hash of the source, the compiler and
the flags>/`` beside the package (never into the package directory), and
loaded from there by every later process, through the CUDA kernels'
build helpers (``ops/_build.py``). The one attempt a process makes is
remembered for the life of the process, and its threads wait for it. When it fails (no compiler, a
compile error), :func:`native_available` is false and one warning carries
the compiler's message: :func:`vipant_tpu_torch.data.transforms_audio.host_fbank`
then runs the NumPy fbank, which agrees with this one to ~4e-4 (not
bitwise). The JAX package falls back without a word.

Nothing here imports torch: the data loader's worker processes use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops._build import build_shared, once
from ..ops.fbank_np import FbankParams

SOURCE = Path(__file__).resolve().with_name("fbank.cc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vipant_tpu_torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
BUILD_TIMEOUT = 120  # seconds; the JAX package's build attempt has the same

_WINDOW_CODES = {"hanning": 0, "hamming": 1, "povey": 2, "rectangular": 3}
_F, _I, _D, _I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_double, ctypes.c_int64
_SIGNATURES = {
    "vt_wav_info": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)],
    "vt_wav_read": [ctypes.c_char_p, _F, _I64],
    "vt_fbank": [_F, _I64, _I, _I, _D, _D, _I, _D, _I, _D, _D, _F, _I64],
}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def build_dir() -> Path:
    """Where this source, compiler and flags build (or built) the library."""
    h = hashlib.sha256(" ".join([_compiler(), *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(tmp: Path) -> Tuple[bool, str]:
    """``fbank.cc`` compiled to ``tmp``: (whether it succeeded, the
    transcript). Raises ``RuntimeError`` when there is no compiler or it
    runs past ``BUILD_TIMEOUT``."""
    cxx = shutil.which(_compiler())
    if cxx is None:
        raise RuntimeError(f"no C++ compiler: {_compiler()!r} is not on PATH (set CXX)")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{' '.join(cmd)} took more than {BUILD_TIMEOUT} s") from e
    return proc.returncode == 0, f"$ {' '.join(cmd)}\n{proc.stdout}"


@once
def _load() -> Optional[ctypes.CDLL]:
    """The library, built first if this hash has none yet (``build.log`` and
    ``build_seconds`` beside it); None (with one warning that carries the
    reason) when it cannot be built or loaded. One attempt a process: its
    threads all take the route it gives."""
    try:
        return build_shared(build_dir() / "libvipant_audio.so", _compile, _SIGNATURES)
    except (RuntimeError, OSError) as e:
        warnings.warn(f"the native host fbank is unavailable, the NumPy fbank runs instead "
                      f"(slower, within ~4e-4 of it): {e}", RuntimeWarning, stacklevel=4)
        return None


def native_available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host fbank is not built (see the warning of its build)")
    return lib


def read_wav_native(path: str) -> Tuple[np.ndarray, int]:
    """Returns ([channels, samples] float32 in [-1, 1], sample_rate)."""
    lib = _lib()
    n, sr, ch = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_wav_info(path.encode(), ctypes.byref(n), ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"vt_wav_info({path}) -> {rc}")
    out = np.empty((ch.value, n.value), np.float32)
    frames = lib.vt_wav_read(path.encode(), out.ctypes.data_as(_F), n.value)
    if frames < 0:
        raise ValueError(f"vt_wav_read({path}) -> {frames}")
    return out[:, :frames], sr.value


def fbank_native(waveform: np.ndarray, params: FbankParams) -> np.ndarray:
    """[n] float32 waveform -> [frames, num_mel_bins] float32 log-mel. The C
    ABI takes no dither: a dithered ``params`` raises (``host_fbank`` keeps
    those on the NumPy fbank)."""
    if params.dither != 0.0:
        raise ValueError(f"fbank_native computes no dither (dither={params.dither})")
    if params.window_type not in _WINDOW_CODES:
        raise ValueError(f"unknown window_type {params.window_type!r}")
    lib = _lib()
    wav = np.ascontiguousarray(np.asarray(waveform, np.float32).reshape(-1))
    max_frames = params.num_frames(wav.shape[0])
    out = np.empty((max(max_frames, 1), params.num_mel_bins), np.float32)
    m = lib.vt_fbank(
        wav.ctypes.data_as(_F), wav.shape[0], int(params.sample_rate), int(params.num_mel_bins),
        float(params.frame_length_ms), float(params.frame_shift_ms),
        _WINDOW_CODES[params.window_type], float(params.preemphasis),
        int(params.remove_dc_offset), float(params.low_freq), float(params.high_freq),
        out.ctypes.data_as(_F), max_frames,
    )
    if m < 0:
        raise RuntimeError(f"vt_fbank -> {m}")
    return out[:m]
