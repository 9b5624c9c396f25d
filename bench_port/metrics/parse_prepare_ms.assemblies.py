"""Milliseconds an assembly in the benchmark's wrappers around the host wire: the native parse and, where the line reader serves the records route, its record batches, encoding and prepare_batch; plus the records wire's packing (phase query.pack). A FASTA file's records route cuts its batches from the parse, so there only the parse and the packing run here, and the byte scan, cut and flat copy fall in hit_dicts_ms.assemblies."""


def read(run):
    host = run.span("parse", "parse_records", "encode", "prepare")
    if host is None:
        return None
    return run.per("assemblies", host + run.phase("query.pack"), 1e3)
