"""Milliseconds an assembly in ModelResult.save: the program's phase result.save (its wrapper twin: result_json_ms.assemblies)."""


def read(run):
    if "result.save" not in run.phases:
        return None
    return run.per("assemblies", run.phase("result.save"), 1e3)
