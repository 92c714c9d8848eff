"""What the drivers share: the checks' arithmetic and the card's clock."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence

import torch


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup_line(marks, t_start: float, setup_s: float) -> str:
    """Set-up's phases, in seconds since the process started."""
    return "setup: " + ", ".join(f"{k} {t - t_start:.1f} s" for k, t in marks) + f", warm-up {setup_s:.1f} s"


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got)


def worst_leaf_gap(got: Mapping[str, float], want: Mapping[str, float], leaves: Sequence[str]) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger. A leaf that the program has no reading of
    (the optimizer got no gradient for it) reads 0."""
    if not leaves:
        return math.inf
    median = statistics.median(want[n] for n in leaves)
    return max(abs(got.get(n, 0.0) - want[n]) / max(want[n], median, 1e-30) for n in leaves)


def moving_leaves(ref_grad: Mapping[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's. The others (none expected here)
    move under the optimizer by round-off alone and are left out."""
    median = statistics.median(ref_grad.values())
    return sorted(n for n, g in ref_grad.items() if g >= share * median)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The training checks' numbers: each step's loss, each leaf's first
    gradient as the optimizer gets it, each leaf's first update (the
    optimizer's state after one step) and each leaf's change after the
    checked steps, program against reference."""
    if sorted(prog["state"]) != sorted(ref["state"]):
        raise ValueError("the program trains other leaves than the reference")
    leaves = moving_leaves(ref["grad"])
    finite = all(math.isfinite(x) for x in prog["loss"])
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"])) if finite else math.inf,
        "grad_gap": worst_leaf_gap(prog["grad"], ref["grad"], leaves),
        "state_gap": worst_leaf_gap(prog["state"], ref["state"], leaves),
        "change_gap": worst_leaf_gap(prog["change"], ref["change"], leaves),
    }


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}``: every number of the check beside its
    limit. A number without a limit is refused."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {n: {"value": float(v), "limit": float(limits[n])} for n, v in numbers.items()}


def passed(check: Mapping[str, Mapping[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
