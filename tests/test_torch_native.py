"""The port's native host fbank (vipant_tpu_torch/native) on the CPU:

- ``native/fbank.cc`` is the JAX package's source byte for byte;
- the library builds at first use under ``build/vipant_tpu_torch_native/``
  beside the package, never into the package directory;
- ``fbank_native`` is bitwise the JAX package's library on the same
  waveforms (the same source and flags; skipped only where that library
  cannot be built), and within 2e-3 of the NumPy fbank (the bound
  ``chip_smoke.py`` holds on the card's host; ~4e-4 measured) at three
  windows and two lengths;
- ``read_wav_native`` reads what ``read_wav`` reads, bitwise;
- ``host_fbank`` takes the native route when it is built; dithered
  parameters stay on the NumPy fbank (the C ABI takes no dither, and
  ``fbank_native`` refuses one);
- a build that fails (no compiler, a compile error) warns once, with the
  reason, and every later call takes the NumPy route without a word more;
- threads that featurise at once on a fresh checkout (the thread loader's
  workers) build once, take one route and get bitwise equal features; two
  builds of one path at once (two processes) each write their own temp file.
"""

import importlib
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from vipant_tpu import native as jax_native
from vipant_tpu_torch import native
from vipant_tpu_torch.data import transforms_audio, wav
from vipant_tpu_torch.ops import _build
from vipant_tpu_torch.ops.fbank_np import FbankParams, fbank as fbank_np

from data_synth import _tone_wav

# the module: `vipant_tpu.ops` exports its function `fbank` under this name
jax_fbank_np = importlib.import_module("vipant_tpu.ops.fbank_np")

NP_TOL = 2e-3  # native against the NumPy fbank: float FFT against float64 rfft
WINDOWS = ["hanning", "hamming", "povey"]


def _wave(n, seed=0):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * r.standard_normal(n)).astype(np.float32)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The native library's build and load state, forgotten before and after
    the test, with the builds under ``tmp_path``."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    native._load.cache_clear()
    yield tmp_path
    native._load.cache_clear()


def test_the_source_is_the_jax_packages_byte_for_byte():
    with open(jax_native.__file__.replace("__init__.py", "fbank.cc"), "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()


def test_the_library_builds_beside_the_package_not_in_it():
    assert native.native_available()
    lib = native.build_dir() / "libvipant_audio.so"
    assert lib.exists()
    package = native.SOURCE.parent
    assert package not in lib.parents and lib.parents[1].name == "vipant_tpu_torch_native"
    assert lib.parents[2] == package.parents[1] / "build"
    assert not list(package.glob("*.so"))


@pytest.mark.parametrize("n", [160800, 16037])
@pytest.mark.parametrize("window", WINDOWS)
def test_fbank_native_is_the_jax_librarys_bitwise(window, n):
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library does not build here")
    x = _wave(n, seed=n)
    got = native.fbank_native(x, FbankParams(window_type=window))
    want = jax_native.fbank_native(x, jax_fbank_np.FbankParams(window_type=window))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [160800, 16037])
@pytest.mark.parametrize("window", WINDOWS)
def test_fbank_native_agrees_with_the_numpy_fbank(window, n):
    x = _wave(n, seed=n + 1)
    params = FbankParams(window_type=window)
    got, want = native.fbank_native(x, params), fbank_np(x, params)
    assert got.shape == want.shape == (params.num_frames(n), 128)
    assert float(np.abs(got - want).max()) <= NP_TOL


@pytest.mark.parametrize("seconds,sr", [(1.05, 16000), (0.4, 22050)])
def test_read_wav_native_is_read_wav(tmp_path, seconds, sr):
    path = str(tmp_path / "a.wav")
    _tone_wav(path, seconds, sr=sr, freq=330.0, seed=3)
    got, got_sr = native.read_wav_native(path)
    want, want_sr = wav.read_wav(path)
    assert got_sr == want_sr == sr and got.shape == want.shape
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()


def test_host_fbank_takes_the_native_route_when_built():
    x = _wave(48000, seed=5)
    params = FbankParams()
    assert native.native_available()
    assert transforms_audio.host_fbank(x, params).tobytes() == native.fbank_native(x, params).tobytes()


def test_dithered_parameters_stay_on_the_numpy_fbank(monkeypatch):
    x = _wave(16000, seed=6)
    params = FbankParams(dither=1.0)
    with pytest.raises(ValueError, match="dither"):
        native.fbank_native(x, params)
    monkeypatch.setattr(native, "fbank_native", lambda *a: pytest.fail("the native route ran"))
    np.random.seed(11)
    got = transforms_audio.host_fbank(x, params)
    np.random.seed(11)
    assert got.tobytes() == fbank_np(x, params).tobytes()


def _calls_without_the_library():
    """Two ``host_fbank`` calls on a failed build: (the warnings they raised,
    outputs, the NumPy fbank's)."""
    x = _wave(16000, seed=7)
    params = FbankParams()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = [transforms_audio.host_fbank(x, params) for _ in range(2)]
        available = native.native_available()
    assert not available
    return [w for w in caught if issubclass(w.category, RuntimeWarning)], outs, fbank_np(x, params)


def test_a_missing_compiler_warns_once_and_takes_the_numpy_route(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-vt")
    caught, outs, want = _calls_without_the_library()
    assert len(caught) == 1 and "no-such-compiler-vt" in str(caught[0].message)
    assert "NumPy fbank" in str(caught[0].message)
    assert all(o.tobytes() == want.tobytes() for o in outs)
    assert not list((fresh_build / "build").rglob("*.so"))


def test_a_compile_error_warns_once_with_the_compilers_message(fresh_build, monkeypatch):
    broken = fresh_build / "fbank.cc"
    broken.write_text(native.SOURCE.read_text().replace("extern \"C\" {", "extern \"C\" { int x = ;", 1))
    monkeypatch.setattr(native, "SOURCE", broken)
    caught, outs, want = _calls_without_the_library()
    assert len(caught) == 1 and "error" in str(caught[0].message)
    assert all(o.tobytes() == want.tobytes() for o in outs)
    assert (native.build_dir() / "build.log").exists()


def test_threads_featurising_at_once_build_once_and_take_one_route(fresh_build, monkeypatch):
    builds = []
    compile_ = native._compile

    def counted(tmp):
        builds.append(tmp)
        return compile_(tmp)

    monkeypatch.setattr(native, "_compile", counted)
    x, params, n = _wave(48000, seed=8), FbankParams(), 8
    start = threading.Barrier(n)

    def featurise(_):
        start.wait()
        return transforms_audio.host_fbank(x, params)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(featurise, range(n)))
    assert len(builds) == 1
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert native.native_available()
    want = native.fbank_native(x, params)
    assert all(o.tobytes() == want.tobytes() for o in outs)
    left = sorted(f.name for f in native.build_dir().iterdir())
    assert left == ["build.log", "build_seconds", "libvipant_audio.so"]


def test_builds_of_one_path_at_once_write_their_own_temp_files(tmp_path):
    lib_path, tmps, start = tmp_path / "lib" / "libvipant_audio.so", [], threading.Barrier(2)

    def slow_compile(tmp):
        tmps.append(tmp)
        start.wait()
        ok, log = native._compile(tmp)
        time.sleep(0.2)  # both builds' outputs exist at once
        return ok, log

    with ThreadPoolExecutor(2) as pool:  # each call as a separate process makes it
        libs = list(pool.map(lambda _: _build.build_shared(lib_path, slow_compile, native._SIGNATURES),
                             range(2)))
    assert len(set(tmps)) == 2 and all(t.parent == lib_path.parent for t in tmps)
    assert sorted(f.name for f in lib_path.parent.iterdir()) == [
        "build.log", "build_seconds", "libvipant_audio.so"]
    assert libs[0]._handle == libs[1]._handle  # one library, loaded once
    x, params = _wave(16000, seed=9), FbankParams()
    out = np.empty((params.num_frames(x.shape[0]), params.num_mel_bins), np.float32)
    m = libs[0].vt_fbank(x.ctypes.data_as(native._F), x.shape[0], 16000, params.num_mel_bins, 25.0, 10.0,
                         0, 0.97, 1, 20.0, 0.0, out.ctypes.data_as(native._F), out.shape[0])
    assert m == out.shape[0]
    assert out.tobytes() == native.fbank_native(x, params).tobytes()
