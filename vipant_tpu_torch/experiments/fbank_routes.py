"""The wav loops' time on each host fbank route, on one card.

``chip_smoke.py`` phase 14's VA loop on its wav source (the flagship config,
B = 64, 8 process workers, the split read once) and phase 15 (g)'s AT loop
(``LAMonitor`` at B = 50, 8 process workers, the Clotho split read 3 times,
the loader's first ``prefetch + 1`` batches left out), each timed by
``chip_smoke._timed_epoch``, with every process of a run on one route:

- ``numpy``: ``CXX`` names no compiler, so no process of the run (the
  trainer's, nor a spawned loader worker) builds or loads the native library:
  each warns once and runs the NumPy fbank;
- ``native``: the native library, built once before the runs;
- ``numpy1``, ``native1``: the same with ``OMP_NUM_THREADS``,
  ``OPENBLAS_NUM_THREADS`` and ``MKL_NUM_THREADS`` at 1 in the loader's
  workers (set after the trainer's process has started its own thread
  pools, so only the spawned workers see them).

Before the loops each run also featurises 64 of the VA clips with
``host_fbank`` in 8 spawned processes at once (what the loader's workers do,
without the rest of an item) and reports ms per clip::

    python vipant_tpu_torch/experiments/fbank_routes.py [route,...]

Routes are comma-separated (default ``numpy,native,numpy1,native,numpy``);
each runs in a process of its own, on data written once.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NO_COMPILER = "vipant-no-compiler"  # a CXX that names no program: the native build fails
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
POOL_CLIPS, POOL_WORKERS = 64, 8


def _featurise(path):
    from vipant_tpu_torch.data.transforms_audio import host_fbank
    from vipant_tpu_torch.data.wav import read_wav
    from vipant_tpu_torch.ops.fbank_np import FbankParams

    wav, _ = read_wav(path)
    return host_fbank(wav[0], FbankParams()).shape[0]


def run(route, data):
    """One route's readings, in this process and the workers it spawns."""
    import glob
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    import torch

    import chip_smoke as cs
    from vipant_tpu_torch import native

    torch.ones(64, 64) @ torch.ones(64, 64)  # the trainer's process starts its thread pools first
    if route.endswith("1"):
        os.environ.update({v: "1" for v in THREAD_VARS})
    here = "native" if native.native_available() else "numpy"
    if here != route.rstrip("1"):
        raise SystemExit(f"fbank_routes: route {route} but this process took {here}")
    smi = cs._smi()
    clips = sorted(glob.glob(os.path.join(data, "aclip", "train*.wav")))[:POOL_CLIPS]
    with ProcessPoolExecutor(POOL_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_featurise, clips[:POOL_WORKERS]))  # started and warm
        t0 = time.perf_counter()
        frames = list(pool.map(_featurise, clips))
        pool_ms = (time.perf_counter() - t0) / len(clips) * 1e3
    print(f"[{route}] {smi}; host {cs._host_cpu()} ({os.cpu_count()} cores); {POOL_WORKERS} processes "
          f"featurising {len(clips)} clips of {frames[0]} frames: {pool_ms:.3f} ms a clip of wall time",
          flush=True)

    va = cs._loop_trainer(torch, data, os.path.join(data, f"run_va_{route}"), "running.data_name=train",
                          "running.eval_name=", "running.save_epoch=False", "running.save_rate=1000000000")
    ms, per_s, share, steps, series = cs._timed_epoch(torch, va, 0)
    va.close()
    print(f"[{route}] VA wav source, B={cs.LOOP_B}, {va.loader.num_workers} workers: {ms:.2f} ms per step, "
          f"{per_s:.1f} clips/s, data-wait {100 * share:.1f} % over {steps} steps; (wait, call) ms {series}",
          flush=True)
    del va
    torch.cuda.empty_cache()

    workers = min(8, os.cpu_count() or 1)
    at = cs._la_monitor(torch, f"running.data_root={data}", "running.data_name=clotho_train_long",
                        "running.eval_name=", "running.test_name=", "running.epochs=1",
                        "loader_backend=process", f"num_proc={workers}", "running.peep_rate=1",
                        "running.save_epoch=False", "running.save_rate=1000000000",
                        f"alias_root={data}/run_at_{route}", f"model_root={data}/run_at_{route}",
                        "model_name=window", "eval=False", "metrics_jsonl=True")
    head = at.loader.prefetch + 1
    ms, per_s, share, steps, series = cs._timed_epoch(torch, at, 0, head=head)
    at.close()
    print(f"[{route}] AT loop, B={cs.LA_B}, {workers} workers: {ms:.2f} ms per step, {per_s:.1f} clips/s, "
          f"data-wait {100 * share:.1f} % over {steps} steps; (wait, call) ms {series}", flush=True)


def main() -> None:
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2], sys.argv[3])
        return
    import torch

    import chip_smoke as cs
    from vipant_tpu_torch import native
    from vipant_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("fbank_routes: needs a CUDA device")
    routes = (sys.argv[1] if len(sys.argv) > 1 else "numpy,native,numpy1,native,numpy").split(",")
    _build.library()
    if not native.native_available():
        raise SystemExit("fbank_routes: the native library does not build here")
    data = tempfile.mkdtemp(prefix="vipant_routes_")
    try:
        t0 = time.perf_counter()
        cs.write_synthetic_va(data, "train", cs.LOOP_TRAIN, seed=0)
        cs.write_synthetic_clotho(data, "clotho_train", cs.LA_TRAIN, seed=0)
        os.symlink(os.path.join(data, "clotho_train"), os.path.join(data, "clotho_train_long"))
        with open(os.path.join(data, "clotho_train.csv")) as f:
            header, *rows = f.readlines()
        with open(os.path.join(data, "clotho_train_long.csv"), "w") as f:
            f.writelines([header] + rows * cs.LA_LONG_REPEAT)
        print(f"data written in {time.perf_counter() - t0:.1f} s", flush=True)
        for route in routes:
            env = dict(os.environ, PYTHONPATH=ROOT)
            if route.startswith("numpy"):
                env["CXX"] = NO_COMPILER
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", route, data],
                                  env=env, stderr=subprocess.PIPE, text=True)
            warned = proc.stderr.count("the native host fbank is unavailable")
            print(f"[{route}] exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; processes that "
                  f"warned of the NumPy route: {warned}", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"fbank_routes: route {route} failed")
    finally:
        shutil.rmtree(data, ignore_errors=True)


if __name__ == "__main__":  # the loader's spawned workers import this module again
    main()
