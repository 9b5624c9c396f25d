"""Milliseconds an assembly in the records route's check of the route, a native parse of the whole file whose result is dropped: the program's phase wire.parse."""


def read(run):
    if "wire.parse" not in run.phases:
        return None
    return run.per("assemblies", run.phase("wire.parse"), 1e3)
