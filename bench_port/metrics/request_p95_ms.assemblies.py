"""The 95th percentile (nearest rank) of every completed request's host time, facade call to result JSON written, in ms."""


def read(run):
    return run.request_p95_ms()
