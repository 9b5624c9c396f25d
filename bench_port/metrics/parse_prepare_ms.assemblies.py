"""Milliseconds an assembly in parsing (the route check and the record reader), encoding, prepare_batch and the records wire's packing (phase query.pack)."""


def read(run):
    host = run.span("parse", "parse_records", "encode", "prepare")
    if host is None:
        return None
    return run.per("assemblies", host + run.phase("query.pack"), 1e3)
