"""Milliseconds an assembly in the result's JSON encoder: the program's phase result.encode, inside result.save."""


def read(run):
    if "result.encode" not in run.phases:
        return None
    return run.per("assemblies", run.phase("result.encode"), 1e3)
