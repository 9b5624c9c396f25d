"""Milliseconds an assembly in the MLST model's splitter and each piece's encoding, a length group at a time: the program's phase mlst.split."""


def read(run):
    if "mlst.split" not in run.phases:
        return None
    return run.per("assemblies", run.phase("mlst.split"), 1e3)
