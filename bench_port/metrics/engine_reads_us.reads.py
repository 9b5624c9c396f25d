"""Microseconds a read in the reads route's engine: the program's phase engine.reads (upload, K1 + K2, fetch) less its wire packing, query.pack (its wrapper twin: engine_us.reads)."""


def read(run):
    if "engine.reads" not in run.phases or "query.pack" not in run.phases:
        return None
    return run.per("reads", run.phase("engine.reads") - run.phase("query.pack"), 1e6)
