"""Milliseconds an assembly in the MLST model's wait for the card and one copy of a genome group's counts back: the program's phase mlst.fetch."""


def read(run):
    if "mlst.fetch" not in run.phases:
        return None
    return run.per("assemblies", run.phase("mlst.fetch"), 1e3)
