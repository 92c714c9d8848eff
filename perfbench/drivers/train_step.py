"""Training steps as ``Trainer.epoch`` runs them, fed as the loader feeds them.

Set-up builds the configuration's trainer with ``steps_per_epoch`` given (it
reads no data), copies the weights made from the seed into it, makes a ring
of distinct batches from the seed on the card and copies it to the host
once. A thread stands in for the loader's workers and transfer thread: it
hands the ring's batches, in turn, to ``PinnedDevicePut.__call__`` (pinned
buffers, a side stream), at most ``prefetch`` ahead. Each step is the body of
``Trainer.epoch``: ``PinnedDevicePut.wait``, ``Trainer.train_step``, and the
loss read every ``running.peep_rate`` steps.

The first ``1 + check_steps`` steps are set-up: they warm up every shape and
are the steps the check follows. Step 0 runs at the schedule's rate 0 and
moves nothing; the reference follows steps 1 to ``check_steps`` from the
weights made from the seed. The window then runs for the run's seconds and
ends on a synchronize; the traced window runs ``trace_steps`` more.
"""

from __future__ import annotations

import contextlib
import gc
import math
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..harness import inputs
from ..harness.trace import trace_window
from ..reference import clip as ref
from ..work import counts
from . import common


class Feeder:
    """The loader's stand-in: ring batch ``i % len(ring)`` for ``i`` = 0, 1,
    ... through ``device_put`` on a thread, into a queue of ``prefetch``."""

    def __init__(self, ring: List[Dict[str, np.ndarray]], device_put: Callable, prefetch: int):
        self.ring, self.device_put = ring, device_put
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, name="perfbench-feeder", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        i = 0
        try:
            while not self.stop.is_set():
                batch = dict(self.ring[i % len(self.ring)])
                batch["name"] = [str(i)] * len(next(iter(batch.values())))
                out = self.device_put(batch)
                while not self.stop.is_set():
                    try:
                        self.q.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                i += 1
        except BaseException as e:  # handed to the consumer, which raises it
            self.error = e

    def get(self) -> dict:
        while True:
            if self.error is not None:
                raise RuntimeError("the feeder thread failed") from self.error
            try:
                return self.q.get(timeout=0.1)
            except queue.Empty:
                continue

    def close(self) -> None:
        self.stop.set()
        while not self.q.empty():
            self.q.get_nowait()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("the feeder thread did not stop")


def _check_config(tr, cfg: dict, mix: dict) -> None:
    """The trainer runs what the configuration file states."""
    got = {"compute_dtype": str(tr.cfg.compute_dtype), "batch": int(tr.cfg.running.batch_size)}
    want = {"compute_dtype": cfg["compute_dtype"], "batch": int(mix["batch"])}
    opt = tr.cfg.optimizer
    for k, v in cfg["optimizer"].items():
        if k in opt:
            got[f"optimizer.{k}"], want[f"optimizer.{k}"] = type(v)(opt[k]), v
    if got != want:
        raise ValueError(f"the trainer's config differs from the configuration file: {got} != {want}")
    names = ref.trainable_names(cfg)
    if sorted(tr.trainable) != sorted(names):
        raise ValueError("the trainer trains other parameters than the configuration states")


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in tensors.items()}


class Session:
    """The program's side of a run: the trainer, the feeder and its step."""

    def __init__(self, cell: dict, seed: int, device):
        from vipant_tpu_torch.data.device_put import PinnedDevicePut
        from vipant_tpu_torch.train import build_monitor

        cfg, mix = cell["cfg"], cell["mix"]
        self.device = torch.device(device)
        self.marks = [("imported", time.perf_counter())]  # set-up's phases, for the log
        self.tr = build_monitor(list(cfg["overrides"]),
                                steps_per_epoch=int(mix["steps_per_epoch"]), device=self.device)
        _check_config(self.tr, cfg, mix)
        self.marks.append(("built", time.perf_counter()))
        inputs.load_into(self.tr.model, inputs.make_weights(ref.param_spec(cfg), seed, self.device))
        self.marks.append(("weights", time.perf_counter()))
        ring = []
        for i in range(int(mix["ring"])):
            b = inputs.make_batch(cfg, mix, seed, i, self.device)
            ring.append({k: v.cpu().numpy() for k, v in b.items()})
            del b
        self.marks.append(("ring", time.perf_counter()))
        self.put = PinnedDevicePut(self.tr.batch_keys, self.device)
        self.feeder = Feeder(ring, self.put, int(mix["prefetch"]))
        self.peep = int(self.tr.cfg.running.get("peep_rate", 100))
        self.steps = 0
        self.nonfinite = 0

    def step(self, spans: bool = False) -> dict:
        span = torch.profiler.record_function if spans else _no_span
        with span("perfbench.data_wait"):
            args = self.put.wait(self.feeder.get())
        with span("perfbench.train_step"):
            metrics = self.tr.train_step(*args)
        self.steps += 1
        if self.steps % self.peep == 0:
            with span("perfbench.peep"):
                if not math.isfinite(float(metrics["loss"])):
                    self.nonfinite += 1
        return metrics

    def readings(self, check_steps: int) -> dict:
        """Step 0 and the checked steps: each loss, each leaf's gradient as
        the optimizer gets it in the first checked step and its optimizer
        state after that step, each leaf's change after the last."""
        start = {n: p.detach().clone() for n, p in self.tr.trainable.items()}
        out = {"loss": [], "grad": {}, "state": {}, "change": {}}
        for k in range(1 + check_steps):
            hook = self._read_grads(out["grad"]) if k == 1 else None
            metrics = self.step()
            if hook is not None:
                hook.remove()
            if k == 0:
                continue
            out["loss"].append(float(metrics["loss"]))
            if k == 1:
                state = self.tr.state.optimizer.inner.state
                out["state"] = _norms({n: state[p]["momentum"] if "momentum" in state.get(p, {})
                                       else torch.zeros(()) for n, p in self.tr.trainable.items()})
        out["change"] = _norms({n: p - start[n] for n, p in self.tr.trainable.items()})
        return out

    def _read_grads(self, into: Dict[str, float]):
        """A hook that puts into ``into`` the norm of each trainable leaf's
        gradient as the inner optimizer's next step reads it (clipped by the
        global norm); the caller removes it after that step."""
        names = {id(p): n for n, p in self.tr.trainable.items()}

        def read(optimizer, args, kwargs):
            into.update(_norms({names[id(p)]: p.grad for g in optimizer.param_groups for p in g["params"]
                                if p.grad is not None}))

        return self.tr.state.optimizer.inner.register_step_pre_hook(read)

    def close(self) -> None:
        self.feeder.close()
        self.tr = self.put = self.feeder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _no_span(name: str):
    return contextlib.nullcontext()


def reference_readings(cell: dict, seed: int, device, precision: str = "fp32",
                       rows: Optional[int] = None) -> dict:
    """The reference's readings over the checked steps (batches 1 to
    ``check_steps`` of the ring), from the weights made from the seed."""
    cfg, mix = cell["cfg"], cell["mix"]
    ref.set_exact_float32()
    w = inputs.make_weights(ref.param_spec(cfg), seed, device)
    batches = [inputs.make_batch(cfg, mix, seed, i, device) for i in range(1, 1 + int(mix["check_steps"]))]
    return ref.train_readings(cfg, w, batches, 1, int(mix["steps_per_epoch"]),
                              int(mix["reference_chunk"]), precision, rows)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        say=print) -> dict:
    cfg, mix = cell["cfg"], cell["mix"]
    device = torch.device(device)
    on_card = device.type == "cuda"
    sess = Session(cell, seed, device)
    prog = sess.readings(int(mix["check_steps"]))
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    say(common.setup_line(sess.marks, t_start, setup_s))
    B = int(mix["batch"])
    work = counts.summary(counts.train_step_ops(cfg, B))

    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    first = sess.steps
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        sess.step()
    common.sync(device)
    window_s = time.perf_counter() - t0
    steps = sess.steps - first
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    traced = None
    if trace:
        n = int(mix["trace_steps"])
        traced = trace_window(torch, lambda: [sess.step(spans=True) for _ in range(n)], device, say=say)
        traced["units"] = n
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if on_card else 0
    nonfinite = sess.nonfinite
    sess.close()
    del sess

    t_ref = time.perf_counter()
    want = reference_readings(cell, seed, device)
    numbers = common.train_numbers(prog, want)
    say(f"check: the reference took {time.perf_counter() - t_ref:.1f} s; "
        f"{len(common.moving_leaves(want['grad']))} of {len(want['grad'])} leaves compared")
    check = common.judge(numbers, cell["limits"])
    return {
        "kind": "train", "setup_s": setup_s, "attempted": steps, "failed": nonfinite,
        "correct": common.passed(check) and nonfinite == 0,
        "window": {"seconds": window_s, "units": steps, "clips": steps * B},
        "work": {"least_s_per_unit": work["least_s"], "flops_per_unit": work["product_flops"]},
        "peak_window_bytes": window_peak, "memory_peak_bytes": memory_peak,
        "trace": traced, "check": check,
    }
