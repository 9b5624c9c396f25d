"""Microseconds a read in the native parse and the read wire's packing: the program's phases wire.parse and query.pack (its wrapper twin: parse_pack_us.reads)."""


PHASES = ("wire.parse", "query.pack")


def read(run):
    if not all(name in run.phases for name in PHASES):
        return None
    return run.per("reads", run.phase(*PHASES), 1e6)
