"""Microseconds a read in ModelResult.save (scores and the JSON written)."""


def read(run):
    return run.per("reads", run.span("result_json"), 1e6)
