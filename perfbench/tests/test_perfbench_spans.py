"""``perfbench/harness/spans.py`` on synthetic events: the card's idle time
split exactly among the innermost ``vipant.*`` span of the window's main
thread; and ``perfbench/span_split.py`` on tiny cells on the CPU."""

import json

import pytest

from perfbench.harness.spans import split
from perfbench.harness.trace import WINDOW

MAIN, OTHER = 1, 2


def host(name, s, t, th=MAIN):
    return (name, False, s, t, th)


def dev(name, s, t):
    return (name, True, s, t, 0)


def _idle(evs):
    """The window's idle ns from first principles: every ns not under a
    device event."""
    _, _, ws, we, _ = next(e for e in evs if e[0] == WINDOW)
    busy = set()
    for n, d, s, t, _ in evs:
        if d:
            busy.update(range(max(s, ws), min(t, we)))
    return (we - ws) - len(busy)


def test_a_gap_that_straddles_two_spans_is_split_at_their_edge():
    evs = [host(WINDOW, 0, 1000), host("vipant.train.forward", 100, 500),
           host("vipant.train.backward", 500, 900), dev("k", 0, 300), dev("k", 700, 1000)]
    got = split(evs)
    assert got["vipant.train.forward"]["idle_s"] == pytest.approx(200e-9)
    assert got["vipant.train.backward"]["idle_s"] == pytest.approx(200e-9)
    assert got["vipant.train.forward"]["host_s"] == pytest.approx(400e-9)
    assert got.get("", {"idle_s": 0.0})["idle_s"] == 0.0


def test_idle_time_goes_to_the_innermost_span_and_outside_spans_to_the_empty_name():
    evs = [host(WINDOW, 0, 1000), host("vipant.train.step", 100, 900),
           host("vipant.optim", 400, 800), host("vipant.optim.update", 500, 700),
           host("aten::mul", 550, 560),  # not a program span: its time stays with the span around it
           host("vipant.data.put", 0, 1000, OTHER),  # another thread: host time only
           dev("k", 200, 300)]
    got = split(evs)
    assert got["vipant.optim.update"]["idle_s"] == pytest.approx(200e-9)
    assert got["vipant.optim"]["idle_s"] == pytest.approx(200e-9)
    assert got["vipant.train.step"]["idle_s"] == pytest.approx(300e-9)
    assert got[""]["idle_s"] == pytest.approx(200e-9)
    assert got["vipant.data.put"] == {"count": 1, "host_s": pytest.approx(1000e-9), "idle_s": 0.0}
    assert "aten::mul" not in got


def test_the_names_idle_times_sum_to_the_windows_idle_time():
    evs = [host(WINDOW, 1000, 9000), host("vipant.train.step", 500, 4000),  # starts before the window
           host("vipant.train.forward", 1200, 2500), host("vipant.train.backward", 2500, 3900),
           host("vipant.train.step", 4100, 9500), host("vipant.optim", 8000, 9400),
           host("vipant.optim.clip", 8000, 8100), host("vipant.optim.update", 8100, 9300),
           dev("a", 900, 1100), dev("b", 1050, 1500), dev("c", 3000, 3001), dev("d", 5000, 7000),
           dev("e", 6000, 6500), dev("f", 8900, 9600)]
    got = split(evs)
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(_idle(evs) * 1e-9, abs=1e-15)
    assert got["vipant.train.step"]["count"] == 2
    assert got["vipant.train.step"]["host_s"] == pytest.approx((3000 + 4900) * 1e-9)


@pytest.mark.parametrize("name", ["clap_finetune_b50", "clap_embed_audio_b64"])
def test_a_tiny_cpu_run_splits_the_programs_spans(capsys, name):
    from perfbench import span_split
    from perfbench.tests import tiny

    assert span_split.main(["--workload", name, "--seed", "3000000019", "--seconds", "1"],
                           device="cpu", patch=tiny.patch(fp32=True)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2])["correct"]  # the run's own line
    got = json.loads(lines[-1])
    spans = got["spans"]
    # on the CPU nothing runs on a card: the whole window is idle, and every ms of it is someone's
    assert sum(v["idle_ms"] for v in spans.values()) == pytest.approx(got["window_ms"])
    if name == "clap_finetune_b50":
        step = spans["vipant.train.step"]
        assert step["count"] == got["units"] == 2  # the tiny cell's traced steps
        for part in ("vipant.train.forward", "vipant.train.backward", "vipant.optim.clip", "vipant.optim.update"):
            assert spans[part]["count"] == 2 and 0 < spans[part]["host_ms"] < step["host_ms"]
        assert spans["vipant.data.put"]["count"] >= 1  # the feeder's thread, which runs ahead
    else:
        assert spans["vipant.serve.request"]["count"] == got["units"] == 2
        for part in ("vipant.serve.h2d", "vipant.serve.forward", "vipant.serve.d2h"):
            assert spans[part]["count"] == 2
