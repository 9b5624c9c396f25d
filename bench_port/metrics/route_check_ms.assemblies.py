"""Milliseconds an assembly in the file's one native parse, which picks the route and gives a FASTA file's records route the records its batches are cut from: the program's phase wire.parse."""


def read(run):
    if "wire.parse" not in run.phases:
        return None
    return run.per("assemblies", run.phase("wire.parse"), 1e3)
