"""Milliseconds an assembly in the ST-name lookup of a reliable type (the designations POST and its answer): the program's phase mlst.lookup."""


def read(run):
    if "mlst.lookup" not in run.phases:
        return None
    return run.per("assemblies", run.phase("mlst.lookup"), 1e3)
