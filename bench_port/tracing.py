"""The device's side of a traced run, from one ``torch.profiler`` window.

:func:`summarize` reads the Chrome trace the profiler exported: the
window is the ``bench.window`` annotation the harness opens around the
measured requests; device operations are the kernel, memcpy and memset
events in it.  Busy time is the union of their intervals (after
``trace_busy_share`` of ``chip_smoke.py``); idle gaps are the stretches
of the window between them, each named by the innermost host span (see
:mod:`bench_port.spans`) open at its middle.
"""

import json
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation",)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # seconds of device time by operation name, in the window
    device_ops: dict = field(default_factory=dict)
    # the longest idle gaps: [(span name, seconds)], longest first
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of every operation whose name holds ``fragment``."""
        return sum(s for name, s in self.device_ops.items() if fragment in name)


def short_name(name: str) -> str:
    """An operation's name without its argument list (the first ``(``
    outside template brackets) or a leading ``void``."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for at, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:at]
            break
    name = name.strip()
    return name[5:] if name.startswith("void ") else name


def summarize(trace_path: Path, top: int = 10) -> TraceSummary:
    events = json.loads(Path(trace_path).read_text(encoding="utf-8"))["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    windows = [e for e in spans if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} annotation in the trace, found {len(windows)}")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    ops = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            t0, t1 = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
            if t1 > t0:
                ops.append((t0, t1, short_name(e["name"])))
    ops.sort()
    by_name: dict = {}
    for t0, t1, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    busy, reach, gaps = 0.0, w0, []
    for t0, t1, _ in ops:
        if t0 > reach:
            gaps.append((reach, t0))
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    if w1 > reach:
        gaps.append((reach, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_open_span(host, (g0 + g1) / 2), (g1 - g0) / 1e6) for g0, g1 in gaps[:top]]
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, device_ops=by_name, idle_gaps=named)


def _open_span(host, t: float) -> str:
    """The innermost host span open at ``t`` (the latest to start), or
    ``window`` when none is."""
    best = None
    for s0, s1, name in host:
        if s0 > t:
            break
        if s1 >= t:
            best = name
    return best or "window"
