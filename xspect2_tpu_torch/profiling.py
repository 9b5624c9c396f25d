"""Profiling: per-phase wall timers and a device trace.

Named phases (the engine records ``query.pack``, ``query.dispatch`` and
``query.sync``, as the JAX package's engine does) accumulate wall time
and call counts; :func:`trace` records a ``torch.profiler`` trace of
the host and, when the process has a CUDA card, of its kernels.

Usage::

    from xspect2_tpu_torch.profiling import phase, report, trace
    with phase("parse"):
        ...
    with trace("traces/run"):   # TensorBoard / Chrome trace (*.pt.trace.json)
        ...
    print(report())

A phase measures the host's wall clock only: it adds no synchronization,
so the time of work the card runs asynchronously lands in the phase
that waits for it (``query.sync`` for a query's hit counts).
"""

import contextlib
import json
import time
from collections import defaultdict

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall time under a named phase."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _totals[name] += time.perf_counter() - t0
        _counts[name] += 1


def add(name: str, seconds: float) -> None:
    """Record an externally measured duration."""
    _totals[name] += seconds
    _counts[name] += 1


def reset() -> None:
    _totals.clear()
    _counts.clear()


def report() -> dict:
    """Phase totals: {phase: {seconds, calls}}."""
    return {
        name: {"seconds": round(_totals[name], 6), "calls": _counts[name]}
        for name in sorted(_totals)
    }


def report_json() -> str:
    return json.dumps(report(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed work, written into
    ``log_dir`` as a TensorBoard trace (``<worker>.<ns>.pt.trace.json``,
    Chrome trace format): host activity, and the CUDA kernels when the
    process has a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
