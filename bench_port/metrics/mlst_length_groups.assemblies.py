"""K5 dispatches an assembly, one a group of loci of one allele length: the calls of the program's counter mlst.length_group over the assemblies completed."""


def read(run):
    if "mlst.length_group" not in run.phases:
        return None
    return run.per("assemblies", run.phases["mlst.length_group"]["calls"], 1.0)
