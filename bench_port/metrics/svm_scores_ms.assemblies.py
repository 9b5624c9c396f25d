"""Milliseconds an assembly in the SVM model's score table, computed to take its total row: the program's phase svm.scores."""


def read(run):
    if "svm.scores" not in run.phases:
        return None
    return run.per("assemblies", run.phase("svm.scores"), 1e3)
