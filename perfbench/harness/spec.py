"""Everything about a cell, found by name from ``BENCHMARK.json``: its entry,
its configuration's file, its traffic mix (``perfbench/traffic/<traffic>.json``),
the limits of its checks (``perfbench/limits/<cell>.json``), its metrics and
their readers (``perfbench/metrics/<metric>.py``, or ``<base>.py`` for a
``<base>.<side>`` without a file of its own), and the driver that the mix
names (``perfbench/drivers/<driver>.py``). A later cell, mix, limit or
metric is a new file and a new entry; nothing here changes for it."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, bench: dict = None) -> dict:
    """The cell ``name``: its entry, ``cfg`` (the configuration's file),
    ``mix`` (the traffic mix), ``limits`` and ``metrics`` (``end_to_end`` and
    ``per_layer``, the entries that report in this cell)."""
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(sorted(entries))})")
    entry = dict(entries[name])
    configs = {c["name"]: c for c in bench["configs"]}
    entry["cfg"] = _read(ROOT / configs[entry["config"]]["file"])
    entry["mix"] = _read(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    entry["limits"] = _read(BENCH_DIR / "limits" / f"{name}.json")
    entry["metrics"] = {kind: [m for m in bench[kind] if name in m.get("workloads", [name])]
                        for kind in ("end_to_end", "per_layer")}
    return entry


def reader(metric: str) -> Callable[[dict], object]:
    """``read(record)`` of ``perfbench/metrics/<metric>.py``, or, where there
    is no such file, of the file named by the part of the name before its
    first dot: ``mfu.pretrain`` and ``mfu.serve`` read ``mfu.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_values(entries: List[dict], record: dict) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` for each metric whose reader finds
    something in ``record``; one that finds nothing is left out."""
    out = {}
    for m in entries:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
