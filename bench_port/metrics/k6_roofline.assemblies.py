"""K6's share of its roofline in MLST typing, in %: the bound of the window's per-record reductions (roofline_mlst.py) over the device time of segment_reduce_kernel in the trace."""

from bench_port.roofline_mlst import K6


def read(run):
    return run.roofline_pct(K6)
