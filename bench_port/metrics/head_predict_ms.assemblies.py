"""Milliseconds an assembly in the SVM head's prediction (the head's lookup, K11 and its fetch): the program's phase svm.head (its wrapper twin: svm_head_ms.assemblies)."""


def read(run):
    if "svm.head" not in run.phases:
        return None
    return run.per("assemblies", run.phase("svm.head"), 1e3)
