"""Milliseconds an assembly in the SVM head's prediction (SVMHead.predict: K11 and its fetch)."""


def read(run):
    return run.per("assemblies", run.span("svm_head"), 1e3)
