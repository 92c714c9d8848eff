"""Tiny runs of every cell on the CPU through the tests' entry of
``perfbench/run.py``: the last line of standard output, the check beside its
limits, the reference against the port's CPU path, the command's refusal
without a card, and no JAX in the process after a run."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import run
from perfbench.harness import spec
from perfbench.tests.tiny import patch

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 3_000_000_019  # past 32 signed bits: a run's seed may be


def tiny_run(capsys, name, trace=0, fp32=True, seed=SEED):
    """A tiny run; in float32 by default: the limits are the cell's, set at
    its own size, where bfloat16 rounding averages over far more rows."""
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                  device="cpu", patch=patch(fp32))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_cpu_run_prints_the_contracts_line(capsys, name, trace):
    line, err = tiny_run(capsys, name, trace)
    keys = list(line)
    assert set(keys) == CONTRACT | {"card", "check"} | ({"breakdown"} if trace else set())
    assert keys[-1] == "check" and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["card"] == "cpu"
    assert line["device"]["platform"] == "cpu" and line["device"]["kind"] == "cpu"
    cell = spec.cell(name)
    if trace:
        assert line["device"]["window_s"] > 0 and "device_ops" in line["breakdown"]
        assert "trace: took 1 window(s)" in err
    else:  # the card's numbers are never read on the CPU: only the host's end-to-end ones
        assert set(line["metrics"]) == {m["name"] for m in cell["metrics"]["end_to_end"]}
    for name_, c in line["check"].items():
        assert c["value"] <= c["limit"] and f"check {name_} {c['value']!r} limit {c['limit']!r}" in err
    assert err.rstrip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_ports_cpu_path(capsys, name):
    """In float32 the program's plain path and the reference differ by
    summation order alone; in bfloat16 by its rounding."""
    line, _ = tiny_run(capsys, name)
    for n, c in line["check"].items():
        assert c["value"] < 1e-4, (n, c)
    line, _ = tiny_run(capsys, name, fp32=False)
    for n, c in line["check"].items():
        assert 0 < c["value"] < 0.05, (n, c)


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    proc = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=str(spec.ROOT))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


NO_JAX = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import run
from perfbench.harness.device import loaded_forbidden
from perfbench.tests.tiny import patch
assert run.main(["--workload", {name!r}, "--seed", "5", "--seconds", "0.5", "--trace", "0"],
                device="cpu", patch=patch(True)) == 0
print(json.dumps(loaded_forbidden()))
"""


@pytest.mark.parametrize("name", CELLS)
def test_no_jax_module_is_loaded_after_a_tiny_run(name):
    proc = subprocess.run([sys.executable, "-c", NO_JAX.format(root=str(spec.ROOT), name=name)],
                          capture_output=True, text=True, timeout=600, cwd=str(spec.ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
