"""Seconds from process start to the first timed request: imports, CUDA, kernels, data from the seed, training and saving the model, its load and the warm-up."""


def read(run):
    return run.setup_s
