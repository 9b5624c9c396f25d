"""The classify path's profiling phases: names, counts, nesting and the
profiler's timeline.

Both facade routes run on the CPU over the shared trained registry
(``session_data_root``): a genus FASTQ of equal-length reads takes the
reads route, a species FASTA of a few contigs the records route and the
SVM head.  Each phase counts once a request, a file, a batch or a slice,
never once a read; a parent's seconds hold its children's; under a
``torch.profiler`` profile each phase call is one ``user_annotation``
event inside the profiled stretch, and without one no
``record_function`` opens.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.test_torch_models import _write_fastq
from xspect2_tpu_torch import classify, model_cache, profiling
from xspect2_tpu_torch.models import filter_model
from xspect2_tpu_torch.ops import _kernels

READS = 600
CONTIGS = 5

REQUEST = ("classify.request", "classify.load", "classify.predict")
SAVE = ("result.save", "result.scores", "result.encode", "result.write")
READS_ROUTE = REQUEST + SAVE + ("wire.parse", "query.pack", "engine.reads", "engine.reads.fetch", "model.hits")
RECORDS_ROUTE = REQUEST + SAVE + (
    "wire.parse", "wire.read", "wire.encode", "wire.prepare", "query.pack", "query.dispatch",
    "query.sync", "model.hits", "svm.scores", "svm.head",
)
# each parent's children on a route: the phases open directly inside it
NESTING = {
    "classify.request": ("classify.load", "classify.predict", "result.save"),
    "classify.load": ("model.load",),
    "result.save": ("result.write", "result.scores", "result.encode"),
}
ROUTE_NESTING = {
    "reads": {
        "classify.predict": ("wire.parse", "engine.reads", "model.hits"),
        "engine.reads": ("query.pack", "engine.reads.fetch"),
    },
    "records": {
        "classify.predict": ("wire.parse", "wire.read", "wire.encode", "wire.prepare", "query.pack",
                             "query.dispatch", "query.sync", "model.hits", "svm.scores", "svm.head"),
    },
}


@pytest.fixture()
def clean(session_data_root):
    model_cache.clear()
    profiling.reset()
    yield session_data_root
    model_cache.clear()
    profiling.reset()


def _calls(report):
    return {name: entry["calls"] for name, entry in report.items()}


def _reads_file(tmp_path, genomes):
    fastq = tmp_path / "reads.fastq"
    _write_fastq(fastq, genomes, np.random.default_rng(11), READS)
    return fastq


def _assembly_file(tmp_path, genomes):
    rng = np.random.default_rng(12)
    g = genomes["470"]
    lines = []
    for i in range(CONTIGS):
        s = int(rng.integers(0, len(g) - 1500))
        lines += [f">contig{i} len", g[s : s + int(rng.integers(600, 1500))]]
    fasta = tmp_path / "assembly.fasta"
    fasta.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return fasta


def _classify_reads(tmp_path, genomes, out="genus.json"):
    classify.classify_genus("Synthetic", _reads_file(tmp_path, genomes), tmp_path / out, device="cpu")


def _classify_assembly(tmp_path, genomes, out="species.json"):
    classify.classify_species("Synthetic", _assembly_file(tmp_path, genomes), tmp_path / out, device="cpu")


def test_reads_route_phases_count_a_file_or_a_slice(clean, tmp_path, monkeypatch):
    """600 reads in slices of 128: one pack a slice, one fetch a slice
    fetched in flight plus one for the rest, every other phase once (two
    ``result.write``: the directory, then the file)."""
    _, genomes = clean
    monkeypatch.setattr(filter_model, "_MAX_BATCH_BASES", 1)
    monkeypatch.setattr(filter_model, "_READS_PER_CHUNK", 128)
    _classify_reads(tmp_path, genomes)
    calls = _calls(profiling.report())
    assert set(READS_ROUTE) <= set(calls), set(READS_ROUTE) - set(calls)
    slices = -(-READS // 128)
    in_flight = slices - filter_model._IN_FLIGHT + 1
    assert calls["query.pack"] == slices
    assert calls["engine.reads.fetch"] == in_flight + 1
    assert calls["result.write"] == 2
    once = set(READS_ROUTE) - {"query.pack", "engine.reads.fetch", "result.write"}
    assert {name: calls[name] for name in once} == dict.fromkeys(once, 1)
    assert "wire.read" not in calls and "svm.head" not in calls
    assert len(json.loads((tmp_path / "genus.json").read_text())["hits"]) == READS


def test_records_route_phases_count_a_request_or_a_batch(clean, tmp_path, monkeypatch):
    """Five contigs in batches of two: encode, prepare, the engine's three
    phases and the dictionaries once a batch; the reader once a batch plus
    the pull that finds it empty; the route check, the SVM head and the
    writer once a request."""
    _, genomes = clean
    monkeypatch.setattr(filter_model, "_MAX_RECORD_BATCH_RECORDS", 2)
    _classify_assembly(tmp_path, genomes)
    calls = _calls(profiling.report())
    assert set(RECORDS_ROUTE) <= set(calls), set(RECORDS_ROUTE) - set(calls)
    batches = -(-CONTIGS // 2)
    per_batch = ("wire.encode", "wire.prepare", "query.pack", "query.dispatch", "query.sync", "model.hits")
    assert {name: calls[name] for name in per_batch} == dict.fromkeys(per_batch, batches)
    assert calls["wire.read"] == batches + 1
    assert calls["result.write"] == 2
    once = set(RECORDS_ROUTE) - set(per_batch) - {"wire.read", "result.write"}
    assert {name: calls[name] for name in once} == dict.fromkeys(once, 1)
    assert "engine.reads" not in calls
    result = json.loads((tmp_path / "species.json").read_text())
    assert len(result["hits"]) == CONTIGS and result["prediction"] in ("470", "471")


@pytest.mark.parametrize("route", ["reads", "records"])
def test_a_parent_phase_holds_its_children(clean, tmp_path, route):
    _, genomes = clean
    (_classify_reads if route == "reads" else _classify_assembly)(tmp_path, genomes)
    report = profiling.report()
    checked = 0
    for parent, children in {**NESTING, **ROUTE_NESTING[route]}.items():
        if parent not in report:
            continue
        inside = [report[c]["seconds"] for c in children if c in report]
        # report() rounds each phase to the microsecond
        assert report[parent]["seconds"] >= sum(inside) - 0.5e-6 * (len(inside) + 1), (parent, report)
        checked += bool(inside)
    assert checked >= 3
    total = report["classify.request"]["seconds"]
    assert total > 0 and all(e["seconds"] <= total + 1e-6 for n, e in report.items() if n != "classify.request")


def test_phases_are_user_annotations_on_the_profilers_timeline(clean, tmp_path):
    """One ``user_annotation`` event a phase call, each inside the profiled
    stretch, for both routes in one profile."""
    _, genomes = clean
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.window"):
            _classify_reads(tmp_path, genomes)
            _classify_assembly(tmp_path, genomes)
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (window,) = [e for e in events if e["name"] == "test.window"]
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    report = profiling.report()
    assert set(READS_ROUTE) | set(RECORDS_ROUTE) <= set(report)
    got: dict = {}
    for e in events:
        if e["name"] in report:
            assert w0 <= e["ts"] and e["ts"] + e["dur"] <= w1, e
            got[e["name"]] = got.get(e["name"], 0) + 1
    assert got == _calls(report)


def test_without_a_profiler_a_phase_opens_no_record_function(clean, tmp_path, monkeypatch):
    _, genomes = clean
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    _classify_reads(tmp_path, genomes)
    _classify_assembly(tmp_path, genomes)
    assert opened == []
    assert set(READS_ROUTE) | set(RECORDS_ROUTE) <= set(profiling.report())


def test_model_load_counts_loads_from_disk(clean, tmp_path, monkeypatch):
    """A cold facade call loads the model once; a second call on the
    cached model loads nothing; with the cache off every call loads."""
    _, genomes = clean
    _classify_reads(tmp_path, genomes, "a.json")
    assert profiling.report()["model.load"]["calls"] == 1
    profiling.reset()
    _classify_reads(tmp_path, genomes, "b.json")
    report = profiling.report()
    assert "model.load" not in report and report["classify.load"]["calls"] == 1
    monkeypatch.setenv("XSPECT_MODEL_CACHE", "0")
    profiling.reset()
    for out in ("c.json", "d.json"):
        _classify_reads(tmp_path, genomes, out)
    assert profiling.report()["model.load"]["calls"] == 2
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "d.json").read_bytes()


def test_kernels_build_counts_rounds_of_compilation(tmp_path, monkeypatch):
    """A build that compiles is one ``kernels.build`` call, whatever the
    number of libraries; a build that finds them all built records none."""

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "wb").close()
            return "", None

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", FakeNvcc)
    profiling.reset()
    try:
        _kernels.build(["svm_head", "row_gather"])
        assert profiling.report()["kernels.build"]["calls"] == 1
        assert _kernels.build(["svm_head", "row_gather"]) == dict.fromkeys(["svm_head", "row_gather"], "(cached)")
        assert profiling.report()["kernels.build"]["calls"] == 1
    finally:
        profiling.reset()
