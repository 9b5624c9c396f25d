"""Microseconds a read in the model layer's own work: ``predict`` less the
parse, records, encoding, prepare and engine spans under it, which is the
ranked hit dictionaries (``_record_hits``) and the result object."""

from bench_port.spans import MODEL_CHILDREN


def read(run):
    return run.per("reads", run.self_time("model", *MODEL_CHILDREN), 1e6)
