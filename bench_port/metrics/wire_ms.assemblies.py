"""Milliseconds an assembly in the host wire: the program's phases wire.parse (the route check), wire.read, wire.encode, wire.prepare and query.pack (its wrapper twin: parse_prepare_ms.assemblies)."""


PHASES = ("wire.parse", "wire.read", "wire.encode", "wire.prepare", "query.pack")


def read(run):
    if not all(name in run.phases for name in PHASES):
        return None
    return run.per("assemblies", run.phase(*PHASES), 1e3)
