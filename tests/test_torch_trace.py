"""The port's spans (vipant_tpu_torch/utils/trace.py) on the CPU: off, a span
is one shared null context that never opens a profiler range; under
``torch.profiler`` the trainer's step, the engine's request and the pinned
put record their ranges, nested and in order, on their threads; the
trainer's ``profile`` window writes them, with the step span's number, into
its Chrome trace."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vipant_tpu_torch.data.device_put import PinnedDevicePut
from vipant_tpu_torch.serve import InferenceEngine
from vipant_tpu_torch.train import Trainer
from vipant_tpu_torch.utils import PhaseTimer, span, timed_span, trace

from data_synth import make_synth_va_index

TINY_VA = [
    "+running=bimodal", "+model/image=vit_val", "+model/audio=vit_val", "+model/text=dummy",
    "+model/loss=ce", "+optimizer=standard", "+running/audio=default",
    "model.audio.pre_encoder.stride=[16,24]", "running.audio.max_len=100", "worker=CVAP",
    "model.image.width=64", "model.image.embed_dim=32", "model.image.encoder.layers=2",
    "model.image.heads=4", "compute_dtype=float32", "running.batch_size=2", "mesh.data=-1",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof):
    """(name, start ns, end ns, thread, args) of every ``vipant.*`` range,
    by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("vipant.") and e.device_type().name == "CPU":
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns()), int(e.start_thread_id()), dict(e.kwinputs())))
    return sorted(out, key=lambda e: (e[1], -e[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range was opened with no profiler running")


def test_off_a_span_is_one_shared_null_context_and_opens_no_range(monkeypatch):
    assert span("vipant.a") is trace.NULL  # binds the probes; then every way to open a range raises
    monkeypatch.setattr(trace, "_fast", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    got = {id(span("vipant.a")), id(span("vipant.b", {"step": 3})), id(span("vipant.a"))}
    assert got == {id(trace.NULL)}
    with span("vipant.a"):
        pass
    timer = PhaseTimer()
    with timed_span(timer, "data"):
        pass
    assert timer["data"] >= 0.0 and "data" in timer.summary()


def test_a_phase_span_times_its_phase_and_records_its_range():
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert span("vipant.a") is not trace.NULL
        with timed_span(timer, "model"):
            pass
        with timed_span(timer, "data"):
            pass
    # the span made above but not entered records nothing
    assert [e[0] for e in _spans(prof)] == ["vipant.train.model", "vipant.train.data"]
    assert timer["model"] > 0.0 and timer["data"] > 0.0


def test_a_train_step_nests_forward_backward_and_the_optimizer():
    tr = Trainer(TINY_VA, device="cpu", steps_per_epoch=4)
    r = np.random.default_rng(0)
    batch = tr.make_batch(r.standard_normal((2, 3, 224, 224)).astype(np.float32),
                          r.standard_normal((2, 1, 100, 128)).astype(np.float32))
    tr.train_step(*batch)  # step 0 outside the window
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        tr.train_step(*batch)
    spans = _spans(prof)
    names = [e[0] for e in spans]
    assert names == ["vipant.train.step", "vipant.train.forward", "vipant.train.backward",
                     "vipant.train.grad_reduce", "vipant.optim", "vipant.optim.clip",
                     "vipant.optim.update"]
    by = dict(zip(names, spans))
    step = by["vipant.train.step"]
    assert step[4] == {"step": 1}
    for name in names[1:]:
        assert _inside(by[name], step), name
    for name in ("vipant.optim.clip", "vipant.optim.update"):
        assert _inside(by[name], by["vipant.optim"]), name
    for a, b in zip(spans[1:4], spans[2:5]):  # forward, backward, reduce, optimizer: one after another
        assert a[2] <= b[1], (a[0], b[0])
    assert by["vipant.optim.clip"][2] <= by["vipant.optim.update"][1]


def test_a_request_of_two_and_a_half_batches_holds_three_copies_forwards_and_reads():
    eng = InferenceEngine(TINY_VA, batch_size=2, device="cpu")
    fb = np.random.default_rng(1).standard_normal((5, 100, 128)).astype(np.float32)
    eng.embed_audio(fb[:2])
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = eng.embed_audio(fb)
    assert out.shape == (5, 32)
    spans = _spans(prof)
    requests = [e for e in spans if e[0] == "vipant.serve.request"]
    assert len(requests) == 1
    inner = [e for e in spans if e is not requests[0]]
    assert all(_inside(e, requests[0]) for e in inner)
    assert [e[0] for e in inner] == ["vipant.serve.h2d", "vipant.serve.forward", "vipant.serve.d2h"] * 3
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_the_pinned_put_records_on_the_thread_that_calls_it():
    put = PinnedDevicePut(("audio",), "cpu")
    batch = lambda: {"audio": np.zeros((2, 1, 4, 4), np.float32)}  # noqa: E731
    ready, go = threading.Event(), threading.Event()

    def transfer():  # a thread of its own, as the loader's transfer thread
        ready.set()
        go.wait()
        put(batch())

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        put(batch())
    assert [e[0] for e in _spans(prof)] == ["vipant.data.put"]
    th = threading.Thread(target=transfer)
    th.start()
    ready.wait()
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        put(batch())
        go.set()
        th.join()
    puts = [e for e in _spans(prof) if e[0] == "vipant.data.put"]
    assert len(puts) == 2 and puts[0][3] != puts[1][3]  # the main thread's, then the transfer thread's


def test_the_profile_window_writes_the_spans_into_its_chrome_trace(tmp_path):
    data = str(tmp_path / "data")
    make_synth_va_index(data, "train", n=4, seconds=1.05)
    tr = Trainer([*TINY_VA, "optimizer.use_lars=False", "optimizer.warmup=False",
                  f"running.data_root={data}", "running.data_name=train", "running.eval_name=",
                  "running.epochs=1", "running.peep_rate=1", "running.save_rate=1000000",
                  "running.save_epoch=False", f"alias_root={tmp_path}", f"model_root={tmp_path}",
                  "model_name=run", "model_file=", "eval=False", "loader_backend=thread", "num_proc=1",
                  "profile.alive=True", "profile.start_step=1", "profile.num_steps=1",
                  f"profile.dir={tmp_path}/prof"], device="cpu")
    tr.learn()
    trace_file = tmp_path / "prof" / "trace_00000002.json"  # named by the step the window closes after
    events = json.loads(trace_file.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"vipant.train.step", "vipant.train.forward", "vipant.train.backward", "vipant.optim"} <= names
    # the window holds the start_step-th to the (start_step + num_steps)-th update, and
    # records the spans' args: each step span carries the updates made before it
    assert [e["args"]["step"] for e in events if e.get("name") == "vipant.train.step"] == [0, 1]
    assert os.listdir(tmp_path / "prof") == ["trace_00000002.json"]
