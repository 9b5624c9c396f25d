"""Microseconds a read in the reads route's engine: _count_reads (upload, K1 + K2, fetch) less its wire packing, which parse_pack_us.reads counts."""


def read(run):
    engine = run.span("engine_reads")
    if engine is None:
        return None
    return run.per("reads", engine - run.phase("query.pack"), 1e6)
