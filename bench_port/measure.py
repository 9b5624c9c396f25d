"""What one run measured, as the metric readers in ``metrics/`` see it.

A reader is ``metrics/<metric name>.py`` with ``read(run) -> float |
None``; it returns None when the run holds nothing for it to read, and
the harness then leaves the metric out of the result line.
"""

import math
from dataclasses import dataclass, field


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q``% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


@dataclass
class Request:
    """One facade call of the window."""

    index: int
    pool_index: int
    records: int
    t0: float
    t1: float
    ok: bool
    error: str = ""


@dataclass
class Run:
    setup_s: float
    # the window: first request started to the last one's result written
    window_s: float
    requests: list
    # units of work completed in the window, by the traffic's name for them
    work: dict
    # host spans and the engine's phases (traced runs only)
    spans: dict = field(default_factory=dict)
    span_calls: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)
    # device side (traced runs only): a TraceSummary and the lookup
    # kernels' bound seconds over the window, by kernel
    trace: object = None
    bounds: dict = field(default_factory=dict)

    def rate(self, work: str):
        """Units of ``work`` completed a second over the whole window."""
        if work not in self.work or self.window_s <= 0:
            return None
        return self.work[work] / self.window_s

    def span(self, *names):
        """Host seconds in the named spans, or None if none ran."""
        if not any(self.span_calls.get(n) for n in names):
            return None
        return sum(self.spans.get(n, 0.0) for n in names)

    def self_time(self, name: str, *children):
        """Span ``name`` less the spans nested in it, or None if it never ran."""
        total = self.span(name)
        if total is None:
            return None
        return total - sum(self.spans.get(c, 0.0) for c in children)

    def phase(self, *names) -> float:
        return sum(self.phases.get(n, {}).get("seconds", 0.0) for n in names)

    def per(self, work: str, seconds, scale: float):
        """``seconds`` a unit of ``work``, times ``scale``."""
        if seconds is None or not self.work.get(work):
            return None
        return seconds / self.work[work] * scale

    def request_p95_ms(self):
        done = [r.t1 - r.t0 for r in self.requests if r.ok]
        if not done:
            return None
        return percentile(done, 95) * 1e3

    def idle_pct(self):
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def roofline_pct(self, kernel: str):
        """The bound of the window's launches of ``kernel`` over their
        device time, in %; None when the trace holds none."""
        if self.trace is None or kernel not in self.bounds:
            return None
        device_s = self.trace.kernel_seconds(kernel)
        if device_s <= 0:
            return None
        return 100.0 * self.bounds[kernel] / device_s
