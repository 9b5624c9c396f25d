"""Microseconds a read in the ranked hit dictionaries: the program's phase model.hits (its wrapper twin: hit_dicts_us.reads, which also holds the result object)."""


def read(run):
    if "model.hits" not in run.phases:
        return None
    return run.per("reads", run.phase("model.hits"), 1e6)
