"""Spans at the port's layer boundaries, on the profiler's clock.

:func:`span` names a range of host time: the trainer's step and its
forward, backward and optimizer, the data layer's staging and wait, the
engine's copy, forward and read-back. While a ``torch.profiler`` window
records, each span is a range of that window's own timeline, beside the
CUDA activity, and is written out with it (``Trainer._end_profile``'s
Chrome trace, or whatever the profiler's owner does with its events).
Otherwise a span is one shared null context and costs two flag reads.

Spans nest on their thread. A profiler records the thread that started
it (and the autograd engine's work for that thread); another Python
thread, such as the loader's transfer thread, only under a profiler of
every thread (``_ExperimentalConfig(profile_all_threads=True)``).

Names (each inside the one above it on its thread):

- ``vipant.train.step`` (``args``: ``step``, the updates made before it)
  > ``vipant.train.frontend``, ``vipant.train.forward``,
  ``vipant.train.backward``, ``vipant.train.grad_cache``,
  ``vipant.train.grad_reduce``, ``vipant.optim`` > ``vipant.optim.clip``,
  ``vipant.optim.update``;
- the epoch loop's phases (:func:`timed_span`):
  ``vipant.train.data`` > ``vipant.data.wait``, ``vipant.train.model``,
  ``vipant.train.peep``, ``vipant.train.save``, ``vipant.train.eval`` >
  ``vipant.train.report``;
- ``vipant.data.put`` (the transfer thread);
- ``vipant.serve.request`` >
  ``vipant.serve.h2d``, ``vipant.serve.forward``, ``vipant.serve.d2h``, a
  set for each fixed-size batch.

This module imports no torch (the data layer's workers import it): a
profiler can be recording only once torch is loaded.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Mapping, Optional

NULL = contextlib.nullcontext()
_profiler = None  # torch.autograd.profiler, once torch is loaded
_on_this_thread = None  # torch.autograd._profiler_enabled
_fast = None  # torch._C._profiler._RecordFunctionFast


def _bind() -> bool:
    """Whether torch is loaded; the probes bound once it is."""
    global _profiler, _on_this_thread, _fast
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _profiler, _on_this_thread = torch.autograd.profiler, torch.autograd._profiler_enabled
    _fast = torch._C._profiler._RecordFunctionFast
    return True


def span(name: str, args: Optional[Mapping[str, int]] = None):
    """A context that records ``name`` as a range of the running profiler's
    host timeline, with ``args`` (name -> whole number) as the range's
    arguments (a Chrome trace shows them where the profiler records
    inputs, ``record_shapes=True``, as the trainer's ``profile`` window
    does); :data:`NULL` when no profiler
    records. A profiler records when the Python profiler's flag is up,
    which a profiler of every thread raises too, or this thread's profiler
    state is on."""
    if (_profiler is None and not _bind()) or not (_profiler._is_profiler_enabled or _on_this_thread()):
        return NULL
    if not args:
        return _fast(name)
    return _fast(name, (), {str(k): int(v) for k, v in args.items()})


@contextlib.contextmanager
def timed_span(timer, phase: str):
    """``phase`` of ``timer`` (a :class:`..PhaseTimer`, the host clock of the
    trainer's log) timed over the block, inside the span
    ``"vipant.train." + phase``."""
    timer.start(phase)
    try:
        with span("vipant.train." + phase):
            yield
    finally:
        timer.stop(phase)
