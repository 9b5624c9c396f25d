"""Microseconds a read in the native parse and the 2-bit packing of the read wire (phase query.pack)."""


def read(run):
    parse = run.span("parse")
    if parse is None:
        return None
    return run.per("reads", parse + run.phase("query.pack"), 1e6)
