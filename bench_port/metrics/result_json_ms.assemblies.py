"""Milliseconds an assembly in ModelResult.save (scores and the JSON written)."""


def read(run):
    return run.per("assemblies", run.span("result_json"), 1e3)
