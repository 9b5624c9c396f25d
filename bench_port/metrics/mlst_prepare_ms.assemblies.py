"""Milliseconds an assembly in the MLST model's host wire: the program's phases mlst.prepare (prepare_batch of each length group) and query.pack (the group's 2-bit wire, packed inside mlst.query)."""

PHASES = ("mlst.prepare", "query.pack")


def read(run):
    if not all(name in run.phases for name in PHASES):
        return None
    return run.per("assemblies", run.phase(*PHASES), 1e3)
