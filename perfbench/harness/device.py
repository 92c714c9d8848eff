"""The run's environment and the card it runs on."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vipant_tpu")


def fix_caches(root: Path) -> None:
    """Every build and kernel cache of the run at a fixed path inside the
    checkout (the kernel library builds under ``build/`` there by itself),
    and no library loading JAX on the side."""
    cache = root / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> List[str]:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi failed ({out.returncode})"
