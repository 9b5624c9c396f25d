"""K2's share of its roofline on the reads route, in %: the bound of the window's reads (roofline.py) over K2's device time in the trace."""


def read(run):
    return run.roofline_pct("reads_query_kernel")
