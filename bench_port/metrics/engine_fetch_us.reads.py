"""Microseconds a read in the reads route's wait for the card and copy back: the program's phase engine.reads.fetch."""


def read(run):
    if "engine.reads.fetch" not in run.phases:
        return None
    return run.per("reads", run.phase("engine.reads.fetch"), 1e6)
