"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell,
configuration, traffic mix, limit and metric is found by name with its
required fields."""

import importlib
import json
import re

import pytest

from perfbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):  # each cell reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name_with_its_fields(name):
    cell = spec.cell(name)
    cfg, mix = cell["cfg"], cell["mix"]
    assert {"source", "reduced", "task", "overrides", "compute_dtype", "embed_dim", "towers"} <= set(cfg)
    for t in cfg["towers"].values():
        assert {"kind", "frozen", "width", "layers", "heads", "embed_dim"} <= set(t)
    assert {"driver", "why", "batch", "inputs", "ring", "reference_chunk"} <= set(mix)
    assert set(mix["inputs"]) <= set(cfg["towers"])
    assert callable(spec.driver(mix["driver"]).run)
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    e2e = [m["name"] for m in cell["metrics"]["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["metrics"]["per_layer"]
    assert json.loads(json.dumps(cell["cfg"])) == cfg


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader_that_reads_nothing_from_an_empty_run(metric):
    read = spec.reader(metric)
    empty = {"kind": "neither", "setup_s": 1.0, "trace": None}
    assert read(empty) is None or metric == "setup_s"


def test_the_harness_imports_nothing_of_the_jax_package():
    for mod in ("perfbench.run", "perfbench.control", "perfbench.drivers.train_step",
                "perfbench.drivers.embed", "perfbench.reference.clip", "perfbench.work.counts"):
        importlib.import_module(mod)
    for path in spec.BENCH_DIR.rglob("*.py"):
        text = path.read_text()
        for bad in ("import jax", "from jax", "import flax", "import optax", "vipant_tpu.", "import vipant_tpu\n",
                    "chip_smoke", "import bench"):
            assert bad not in text or path.name == "test_perfbench_spec.py", (path, bad)
