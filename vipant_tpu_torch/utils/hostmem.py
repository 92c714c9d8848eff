"""Host allocator tuning for the batch-assembly path.

The port's own copy of ``vipant_tpu/utils/hostmem.py`` (the same code).

The loader's collators allocate a fresh multi-MB batch buffer per batch
(``np.stack`` of 64 × [T, M] fbanks ≈ 33 MB at the flagship config). With
glibc's default ``M_MMAP_THRESHOLD`` (128 KB, sliding), every such buffer
is a private ``mmap`` that gets ``munmap``'d on free — so the SAME pages
are faulted in again next batch, and on a host with few cores the fault
storm dominates collation (the JAX package measured it on its bench host,
docs/performance.md). Raising the threshold keeps big buffers on the brk
heap where they are recycled warm.

The collated NumPy batches get no buffer reuse from PyTorch's allocator
(the pinned staging buffers of :mod:`vipant_tpu_torch.data.device_put` are
reused on their own), so the host allocator must provide it.
"""

from __future__ import annotations

import ctypes
import sys

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_host_allocator(
    mmap_threshold: int = 256 << 20, trim_threshold: int = 512 << 20
) -> bool:
    """Raise glibc's malloc mmap/trim thresholds so multi-MB batch buffers
    are recycled from the heap instead of munmap'd per batch. Idempotent;
    best-effort (no-op and False on non-glibc platforms)."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, int(mmap_threshold)))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, int(trim_threshold))) and ok
    except Exception:  # noqa: BLE001 - musl/odd libc: skip silently
        return False
    _done = ok
    return ok
