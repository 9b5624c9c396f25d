"""Milliseconds an assembly in the ranked hit dictionaries: the program's phase model.hits (its wrapper twin: hit_dicts_ms.assemblies, which also holds the result object)."""


def read(run):
    if "model.hits" not in run.phases:
        return None
    return run.per("assemblies", run.phase("model.hits"), 1e3)
