"""Milliseconds an assembly in the facade's own work (registry lookups, paths, the print): the program's phase classify.request less classify.load, classify.predict and result.save."""


INSIDE = ("classify.load", "classify.predict", "result.save")


def read(run):
    if not all(name in run.phases for name in ("classify.request", *INSIDE)):
        return None
    return run.per("assemblies", run.phase("classify.request") - run.phase(*INSIDE), 1e3)
