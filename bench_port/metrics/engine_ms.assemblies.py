"""Milliseconds an assembly in the engine's launches and fetch (phases query.dispatch + query.sync)."""


def read(run):
    seconds = run.phase("query.dispatch", "query.sync")
    return run.per("assemblies", seconds, 1e3) if seconds > 0 else None
