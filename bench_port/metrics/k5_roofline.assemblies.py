"""K5's share of its roofline in MLST typing, in %: the bound of the window's typing work (roofline_mlst.py) over the device time of multi_records_query_kernel in the trace."""

from bench_port.roofline_mlst import K5


def read(run):
    return run.roofline_pct(K5)
