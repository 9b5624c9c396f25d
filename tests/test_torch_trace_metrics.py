"""The benchmark's readers of the program's phases.

Each reader (``bench_port/metrics/<name>.py``), loaded as the harness
loads it, turns a fixed ``profiling.report()`` of a run into its unit of
work: the sum of its phases, less the phases nested in them that another
metric counts.  It reads nothing when one of its phases is missing, as
in a run of a program without them.  Each one's ``BENCHMARK.json`` entry
names the one cell whose route records its phases.
"""

import json
from pathlib import Path

import pytest

from bench_port.harness import read_metric
from bench_port.measure import Run

SPEC = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text(encoding="utf-8"))
LAYERS = {"facade and result", "model", "SVM head", "host wire", "engine", "kernels", "device"}

# name: (cell, unit of work, scale, phases added, phases taken away)
READERS = {
    "result_save_us.reads": ("genus160-reads", "reads", 1e6, ["result.save"], []),
    "result_encode_us.reads": ("genus160-reads", "reads", 1e6, ["result.encode"], []),
    "model_hits_us.reads": ("genus160-reads", "reads", 1e6, ["model.hits"], []),
    "wire_us.reads": ("genus160-reads", "reads", 1e6, ["wire.parse", "query.pack"], []),
    "engine_reads_us.reads": ("genus160-reads", "reads", 1e6, ["engine.reads"], ["query.pack"]),
    "engine_fetch_us.reads": ("genus160-reads", "reads", 1e6, ["engine.reads.fetch"], []),
    "facade_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["classify.request"],
                             ["classify.load", "classify.predict", "result.save"]),
    "result_save_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["result.save"], []),
    "result_encode_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["result.encode"], []),
    "model_hits_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["model.hits"], []),
    "wire_ms.assemblies": ("species40-assemblies", "assemblies", 1e3,
                           ["wire.parse", "wire.read", "wire.encode", "wire.prepare", "query.pack"], []),
    "route_check_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["wire.parse"], []),
    "svm_scores_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["svm.scores"], []),
    "head_predict_ms.assemblies": ("species40-assemblies", "assemblies", 1e3, ["svm.head"], []),
    "mlst_split_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["mlst.split"], []),
    "mlst_prepare_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["mlst.prepare", "query.pack"], []),
    "mlst_query_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["mlst.query"], ["query.pack"]),
    "mlst_fetch_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["mlst.fetch"], []),
    "mlst_rank_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["mlst.rank"], []),
    "mlst_lookup_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["mlst.lookup"], []),
    "mlst_save_ms.assemblies": ("mlst7-genomes", "assemblies", 1e3, ["result.save"], []),
}
MLST = "mlst7-genomes"
# the MLST cell's metrics that read no phase: its kernels' roofline shares
# and its counter, listed just before its phase metrics
MLST_OTHERS = ["k5_roofline.assemblies", "k6_roofline.assemblies", "mlst_length_groups.assemblies"]

# a traced run's report: every phase of both routes, each with seconds
# no sum of the others can give, and a parent before its children
PHASES = [
    "classify.request", "classify.load", "classify.predict", "model.load", "mlst.read", "mlst.split",
    "mlst.prepare", "mlst.query", "mlst.fetch", "mlst.rank", "mlst.lookup", "engine.reads", "wire.parse",
    "wire.read", "wire.encode", "wire.prepare", "query.pack", "query.dispatch", "query.sync",
    "engine.reads.fetch", "model.hits", "svm.scores", "svm.head", "result.save", "result.scores",
    "result.encode", "result.write",
]
REPORT = {name: {"seconds": 100.0 / 2**i, "calls": 7} for i, name in enumerate(PHASES)}
WORK = {"reads": 400_000, "assemblies": 250}


def _run(phases):
    return Run(setup_s=30.0, window_s=51.0, requests=[], work=dict(WORK), phases=phases)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_its_phases_per_unit_of_work(name):
    _, work, scale, plus, minus = READERS[name]
    seconds = sum(REPORT[p]["seconds"] for p in plus) - sum(REPORT[p]["seconds"] for p in minus)
    assert seconds > 0
    assert read_metric(name, _run(REPORT)) == pytest.approx(seconds / WORK[work] * scale, rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_without_its_phases(name):
    _, _, _, plus, minus = READERS[name]
    assert read_metric(name, _run({})) is None
    # a program that records the engine's phases only
    assert read_metric(name, _run({p: REPORT[p] for p in ("query.pack", "query.dispatch", "query.sync")})) is None
    for missing in plus + minus:
        assert read_metric(name, _run({p: e for p, e in REPORT.items() if p != missing})) is None, missing


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_has_its_entry_in_one_cell(name):
    cell = READERS[name][0]
    (entry,) = [m for m in SPEC["per_layer"] if m["name"] == name]
    assert entry["workloads"] == [cell]
    assert entry["source"] == "program_span" and entry["layer"] in LAYERS
    assert entry["unit"] == ("us/read" if cell == "genus160-reads" else "ms/assembly")
    assert entry["better"] == "lower"
    moved = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])} - {"setup_s"}
    assert [entry["moves"]] == sorted(moved)


def test_the_phase_metrics_close_the_per_layer_list():
    """The phase metrics close the per-layer list in READERS order: the
    MLST cell's last, after its other metrics, the rest just before them."""
    names = [m["name"] for m in SPEC["per_layer"]]
    mlst = [name for name, spec in READERS.items() if spec[0] == MLST]
    rest = [name for name in READERS if name not in mlst]
    assert list(READERS) == rest + mlst
    assert names[-len(READERS) - len(MLST_OTHERS):] == rest + MLST_OTHERS + mlst


# twins that nest: (program-side metric, the wrapper metric, how the
# program's phase sits to the benchmark's wrapper)
NESTED_TWINS = {
    "genus160-reads": [("result_save_us.reads", "result_json_us.reads", "inside"),
                       ("engine_reads_us.reads", "engine_us.reads", "inside"),
                       ("model_hits_us.reads", "hit_dicts_us.reads", "inside")],
    "species40-assemblies": [("result_save_ms.assemblies", "result_json_ms.assemblies", "inside"),
                             ("model_hits_ms.assemblies", "hit_dicts_ms.assemblies", "inside"),
                             ("head_predict_ms.assemblies", "svm_head_ms.assemblies", "around")],
}


@pytest.mark.parametrize("cell", sorted(NESTED_TWINS))
def test_a_traced_tiny_run_reads_every_phase_metric(tmp_path, monkeypatch, cell):
    """The harness's traced run of the cell at tiny size on the CPU reads
    each of the cell's phase metrics, and each twin sits inside (or
    around) the wrapper span it doubles."""
    from bench_port.tests import tiny

    # the harness points the registry at its run's directory
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    res = tiny.run(cell, trace=True, tmp_path=tmp_path)
    assert res["correct"]
    metrics = {name: m["value"] for name, m in res["metrics"].items()}
    mine = [name for name, spec in READERS.items() if spec[0] == cell]
    assert set(mine) <= set(metrics) and all(metrics[name] > 0 for name in mine)
    for program, wrapper, where in NESTED_TWINS[cell]:
        if where == "inside":
            assert metrics[program] <= metrics[wrapper], (program, wrapper, metrics)
        else:
            assert metrics[program] >= metrics[wrapper], (program, wrapper, metrics)


def test_a_traced_tiny_mlst_run_reads_every_new_metric(tmp_path, monkeypatch):
    """The harness's traced run of the MLST cell at tiny size on the CPU
    reads each of its phase metrics and its counter, above 0; its
    kernels' shares read nothing where the trace holds no device time."""
    from bench_port.tests import tiny_mlst

    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    res = tiny_mlst.run(trace=True, tmp_path=tmp_path)
    assert res["correct"]
    metrics = {name: m["value"] for name, m in res["metrics"].items()}
    mine = [name for name, spec in READERS.items() if spec[0] == MLST] + ["mlst_length_groups.assemblies"]
    assert all(metrics.get(name, 0) > 0 for name in mine), metrics
    assert not {"k5_roofline.assemblies", "k6_roofline.assemblies"} & set(metrics)
    assert res["device"]["platform"] == "cpu" and res["device"]["busy_s"] == 0


def test_one_classify_mlst_call_reports_each_mlst_phase_and_counter(tmp_path, monkeypatch):
    """A split record is typed in one K5 dispatch for each allele length of
    the scheme, from its one encode; the MLST result's save has the result
    phases."""
    import types

    import numpy as np

    from bench_port import synthetic
    from bench_port.tests import tiny_mlst
    from xspect2_tpu_torch import classify, model_cache, profiling
    from xspect2_tpu_torch.core import dna
    from xspect2_tpu_torch.models import mlst_model

    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "data"))
    plan = tiny_mlst.plan()
    config = plan["config"]
    genomes, scheme, train_fn = plan["kind"].make_training(config, np.random.default_rng(3), tmp_path / "train")
    train_fn("cpu")
    synthetic.write_fasta(tmp_path / "genome.fasta", [("g0", genomes[0])])
    encoded = []
    monkeypatch.setattr(mlst_model, "dna", types.SimpleNamespace(
        encode=lambda seq: encoded.append(len(seq)) or dna.encode(seq)))
    profiling.reset()
    try:
        classify.classify_mlst(tmp_path / "genome.fasta", config["organism"], config["scheme"],
                               tmp_path / "out.json", False, device="cpu")
        report = profiling.report()
    finally:
        model_cache.clear()
    lengths = len(set(config["loci"].values()))
    assert report["mlst.length_group"]["calls"] == lengths and report["mlst.length_group"]["seconds"] == 0
    assert report["mlst.genome_group"]["calls"] == 1 and report["mlst.genome_group"]["seconds"] == 0
    assert report["mlst.genome_encode"]["calls"] == 1 and report["mlst.genome_encode"]["seconds"] == 0
    # one encode of the whole genome, not one a piece
    assert encoded == [len(genomes[0])]
    for name, calls in (("mlst.split", lengths), ("mlst.prepare", lengths), ("mlst.query", lengths),
                        ("query.pack", lengths), ("mlst.fetch", 1), ("mlst.rank", 1), ("mlst.read", 2),
                        ("classify.predict", 1), ("result.save", 1), ("result.encode", 1), ("result.write", 2)):
        assert report[name]["calls"] == calls, (name, report[name])
    # the genome carries a profile of the table, so its type is reliable and looked up
    assert report["mlst.lookup"]["calls"] == 1
    assert report["mlst.query"]["seconds"] >= report["query.pack"]["seconds"]
    assert report["classify.predict"]["seconds"] >= sum(report[name]["seconds"] for name in (
        "mlst.read", "mlst.split", "mlst.prepare", "mlst.query", "mlst.fetch", "mlst.rank", "mlst.lookup"))
