"""Draft assemblies classified a second through the facade, FASTA in to result JSON out, over the whole window."""


def read(run):
    return run.rate("assemblies")
