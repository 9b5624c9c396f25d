"""Reads classified a second through the facade, FASTQ in to result JSON out: all reads of all files completed in the window over its whole length."""


def read(run):
    return run.rate("reads")
