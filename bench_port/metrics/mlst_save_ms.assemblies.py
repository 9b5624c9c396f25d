"""Milliseconds an assembly in MlstResult.save (the JSON encoded and written): the program's phase result.save in the MLST cell."""


def read(run):
    if "result.save" not in run.phases:
        return None
    return run.per("assemblies", run.phase("result.save"), 1e3)
