"""Microseconds a read in ModelResult.save: the program's phase result.save (its wrapper twin: result_json_us.reads)."""


def read(run):
    if "result.save" not in run.phases:
        return None
    return run.per("reads", run.phase("result.save"), 1e6)
