"""Embedding requests to ``InferenceEngine``, from one client in a closed loop.

Set-up builds the configuration's engine at the mix's batch size, copies the
weights made from the seed into it, makes a ring of distinct request batches
(host arrays, as a client holds them) from the seed on the card and copies
it to the host once, and sends ``warmup_requests`` requests. The client sends
its next request when the last answer is in hand; each request is one
``embed_<tower>`` call on the next batch of the ring, timed from the call to
the NumPy result. The window runs for the run's seconds; the traced window
sends ``trace_requests`` more.

The check draws ``check_requests`` of the window's requests from the seed
and holds every row of their answers to the reference's embedding of the
same inputs.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from ..harness import inputs
from ..harness.trace import trace_window
from ..reference import clip as ref
from ..work import counts
from . import common

CHECK = 3  # the seed path of the check's draw


class Session:
    """The program's side: the engine and one client's request."""

    def __init__(self, cell: dict, seed: int, device, quantize: str = ""):
        from vipant_tpu_torch.serve import InferenceEngine

        cfg, mix = cell["cfg"], cell["mix"]
        self.device = torch.device(device)
        self.tower = mix["tower"]
        self.marks = [("imported", time.perf_counter())]  # set-up's phases, for the log
        self.eng = InferenceEngine(list(cfg["overrides"]), batch_size=int(mix["batch"]),
                                   device=self.device, quantize=quantize)
        if str(self.eng.cfg.compute_dtype) != cfg["compute_dtype"]:
            raise ValueError(f"the engine computes in {self.eng.cfg.compute_dtype}, the configuration "
                             f"states {cfg['compute_dtype']}")
        self.marks.append(("built", time.perf_counter()))
        inputs.load_into(self.eng.model, inputs.make_weights(ref.param_spec(cfg), seed, self.device))
        self.marks.append(("weights", time.perf_counter()))
        self.ring = [inputs.make_batch(cfg, mix, seed, i, self.device)[self.tower].cpu().numpy()
                     for i in range(int(mix["ring"]))]
        self.marks.append(("ring", time.perf_counter()))
        self.call = getattr(self.eng, f"embed_{self.tower}")
        self.sent = 0

    def request(self, spans: bool = False):
        """The next request: (its ring slot, the answer, its latency in ms)."""
        slot = self.sent % len(self.ring)
        span = torch.profiler.record_function("perfbench.request") if spans else contextlib.nullcontext()
        t0 = time.perf_counter()
        with span:
            out = self.call(self.ring[slot])
        ms = (time.perf_counter() - t0) * 1e3
        self.sent += 1
        return slot, out, ms

    def close(self) -> None:
        self.eng = self.call = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def answer_ok(out, rows: int, dim: int) -> bool:
    return isinstance(out, np.ndarray) and out.shape == (rows, dim) and bool(np.isfinite(out).all())


def worst_row_gap(cell: dict, seed: int, device, answers) -> float:
    """The largest distance between an answered row and the reference's
    embedding of its input (both unit vectors), over ``answers``: (ring
    slot, answer) pairs."""
    cfg, mix = cell["cfg"], cell["mix"]
    ref.set_exact_float32()
    w = inputs.make_weights(ref.param_spec(cfg), seed, device)
    tower = mix["tower"]
    want = {}
    worst = 0.0
    for slot, out in answers:
        if slot not in want:
            x = inputs.make_batch(cfg, mix, seed, slot, device)[tower]
            want[slot] = ref.embed(w, tower, cfg["towers"][tower], x, int(mix["reference_chunk"]))
        got = torch.from_numpy(np.asarray(out, np.float32)).to(device)
        worst = max(worst, float(torch.linalg.vector_norm(got - want[slot], dim=-1).max()))
    return worst


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        say=print) -> dict:
    cfg, mix = cell["cfg"], cell["mix"]
    device = torch.device(device)
    on_card = device.type == "cuda"
    B, dim = int(mix["batch"]), int(cfg["embed_dim"])
    sess = Session(cell, seed, device)
    for _ in range(int(mix["warmup_requests"])):
        sess.request()
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    say(common.setup_line(sess.marks, t_start, setup_s))
    work = counts.summary(counts.embed_ops(cfg, sess.tower, B))

    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    answers, latencies = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        slot, out, ms = sess.request()
        answers.append((slot, out))
        latencies.append(ms)
    common.sync(device)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    traced = None
    if trace:
        n = int(mix["trace_requests"])
        traced = trace_window(torch, lambda: [sess.request(spans=True) for _ in range(n)], device, say=say)
        traced["units"] = n
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if on_card else 0
    sess.close()
    del sess

    failed = sum(1 for _, out in answers if not answer_ok(out, B, dim))
    draw = np.random.default_rng(inputs.sub_seed(seed, CHECK))
    picked = draw.choice(len(answers), size=min(int(mix["check_requests"]), len(answers)), replace=False)
    sample = [answers[i] for i in sorted(picked) if answer_ok(answers[i][1], B, dim)]
    t_ref = time.perf_counter()
    numbers = {"worst_row_gap": worst_row_gap(cell, seed, device, sample) if sample else float("inf")}
    say(f"check: the reference took {time.perf_counter() - t_ref:.1f} s")
    check = common.judge(numbers, cell["limits"])
    return {
        "kind": "serve", "setup_s": setup_s, "attempted": len(answers), "failed": failed,
        "correct": common.passed(check) and failed == 0,
        "window": {"seconds": window_s, "units": len(answers), "clips": len(answers) * B,
                   "latencies_ms": latencies},
        "work": {"least_s_per_unit": work["least_s"], "flops_per_unit": work["product_flops"]},
        "peak_window_bytes": window_peak, "memory_peak_bytes": memory_peak,
        "trace": traced, "check": check,
    }
