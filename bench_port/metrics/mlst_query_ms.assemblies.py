"""Milliseconds an assembly in the MLST model's launches: the program's phase mlst.query (each length group's wire upload and its K4 + K5 + K6 launch) less its wire packing, query.pack, which mlst_prepare_ms.assemblies counts."""


def read(run):
    if "mlst.query" not in run.phases or "query.pack" not in run.phases:
        return None
    return run.per("assemblies", run.phase("mlst.query") - run.phase("query.pack"), 1e3)
