"""K3's share of its roofline on the records route, in %: the bound of the window's assemblies (roofline.py) over K3's device time in the trace."""


def read(run):
    return run.roofline_pct("records_query_kernel")
