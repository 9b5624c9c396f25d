"""Milliseconds an assembly in the MLST model's ranked allele dictionaries and sufficiency rule: the program's phase mlst.rank."""


def read(run):
    if "mlst.rank" not in run.phases:
        return None
    return run.per("assemblies", run.phase("mlst.rank"), 1e3)
