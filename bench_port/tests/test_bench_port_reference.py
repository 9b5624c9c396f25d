"""The reference agrees with the port on a tiny index on the CPU, and
every tiny cell runs through the whole harness correct."""

import numpy as np
import pytest
import torch

from bench_port import reference
from bench_port.tests import tiny
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("num_classes,num_hashes,fields", [(3, 2, 8), (40, 7, 1), (1, 7, 32), (1, 1, 32)])
def test_reference_counts_equal_the_ports_index(num_classes, num_hashes, fields):
    rng = np.random.default_rng(num_classes * 100 + num_hashes)
    k = 21
    genomes = rng.integers(0, 4, size=(num_classes, 3_000), dtype=np.uint8)
    names = [f"c{i}" for i in range(num_classes)]
    index = BlockedBitSlicedIndex.create(k, names, 3_000 - k + 1, fpr=0.01, num_hashes=num_hashes,
                                         fields_per_word=fields)
    for ci, g in enumerate(genomes):
        hi, lo, valid = dna.canonical_kmers(g, k)
        index.insert_kmers(ci, hi, lo, valid)
    config = dict(class_names=names, k=k, fpr=0.01, num_hashes=num_hashes, fields_per_word=fields,
                  sizing="per_class", block_bytes=512, oversize=1.3)
    ref = reference.Reference(config, [[g] for g in genomes], "cpu")
    assert ref.geom["num_blocks"] == index.num_blocks and ref.geom["rows_per_block"] == index.rows_per_block

    records = [genomes[0][100:900].copy(), rng.integers(0, 4, 500, dtype=np.uint8), genomes[-1][:50].copy()]
    records[1][[7, 300]] = 255
    for step in (1, 3):
        want = []
        for r in records:
            hi, lo, valid = dna.canonical_kmers(r, k, step)
            want.append(index.count_hits_host(hi, lo, valid))
        assert np.array_equal(ref.counts(records, step), np.array(want))
    reads = np.stack([genomes[i % num_classes][i * 37 : i * 37 + 150] for i in range(20)])
    reads[3, 40] = 255
    want = [index.count_hits_host(*dna.canonical_kmers(r, k)) for r in reads]
    assert np.array_equal(ref.counts(list(reads)), np.array(want))


def test_expected_result_ranks_scores_and_totals():
    config = dict(class_names=["b", "a", "c"], k=3, model_slug="m-species")
    counts = np.array([[1, 3, 3], [0, 0, 2]])
    res = reference.expected_result(config, ["r1", "r2"], [7, 5], counts, 1, "in.fasta", "a")
    assert list(res["hits"]["r1"].items()) == [("a", 3), ("c", 3), ("b", 1)]
    assert res["scores"]["r2"] == {"c": 0.67, "b": 0.0, "a": 0.0}
    assert list(res["scores"]["total"].items()) == [("a", 0.38), ("c", 0.62), ("b", 0.12)]
    assert res["num_kmers"] == {"r1": 5, "r2": 3} and res["prediction"] == "a"
    assert reference.wrong_answers(res, res) == 0
    bad = {**res, "hits": {**res["hits"], "r2": {"a": 0, "c": 2, "b": 0}}}
    assert reference.wrong_answers(bad, res) == 1  # the order of a row is part of the answer
    assert reference.wrong_answers({**res, "prediction": "b"}, res) == 1
    assert reference.wrong_answers({}, res) == 3


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_every_tiny_cell_is_correct_through_the_whole_harness(tmp_path, cell):
    res = tiny.run(cell, tmp_path=tmp_path)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    if cell.startswith("species"):  # the head's decisions, against the reference's float64 ones
        assert set(res["checks"]) == {"wrong_answers", "head_gap"}
        assert 0 <= res["checks"]["head_gap"]["value"] <= res["checks"]["head_gap"]["limit"]
    else:
        assert set(res["checks"]) == {"wrong_answers"}
    assert list(res)[-1] == "checks"
    work = "reads_per_s" if "reads" in cell else "assemblies_per_s"
    assert set(res["metrics"]) == {work, "setup_s"} and res["metrics"][work]["value"] > 0


# a traced run's per-layer metrics on the CPU, by route: the benchmark's
# wrappers and the program's phases (no kernel runs there, so no roofline)
READS_LAYERS = {"result_json_us.reads", "hit_dicts_us.reads", "parse_pack_us.reads", "engine_us.reads",
                "device_idle.reads", "result_save_us.reads", "result_encode_us.reads", "model_hits_us.reads",
                "wire_us.reads", "engine_reads_us.reads", "engine_fetch_us.reads"}
RECORDS_LAYERS = {"result_json_ms.assemblies", "request_p95_ms.assemblies", "hit_dicts_ms.assemblies",
                  "parse_prepare_ms.assemblies", "engine_ms.assemblies", "device_idle.assemblies"}
TRACED = {
    "species40-reads": READS_LAYERS,
    "genus160-reads": READS_LAYERS,
    "species40-assemblies": RECORDS_LAYERS | {
        "svm_head_ms.assemblies", "facade_ms.assemblies", "result_save_ms.assemblies",
        "result_encode_ms.assemblies", "model_hits_ms.assemblies", "wire_ms.assemblies",
        "route_check_ms.assemblies", "svm_scores_ms.assemblies", "head_predict_ms.assemblies"},
    "genus160-assemblies": RECORDS_LAYERS,
}


@pytest.mark.parametrize("cell", sorted(TRACED))
def test_a_traced_run_reads_its_per_layer_metrics(tmp_path, cell):
    res = tiny.run(cell, trace=True, tmp_path=tmp_path)
    assert res["correct"]
    assert set(res["metrics"]) == TRACED[cell]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_a_tied_decision_accepts_any_label_it_could_make_win():
    from bench_port.svm_ref import OvoSVC

    # one support vector a class, mirrored about x0 == x1: a point on the mirror is a tie
    svc = OvoSVC(support_vectors=np.array([[1.0, 0.0], [0.0, 1.0]]), dual_coef=np.array([[1.0, -1.0]]),
                 intercept=np.array([0.0]), n_support=[1, 1], classes=["a", "b"], kernel="rbf", gamma=0.5)
    assert svc.decisions([[0.5, 0.5]])[0, 0] == 0.0
    assert svc.possible_labels([0.5, 0.5]) == ["a", "b"]
    assert svc.possible_labels([1.0, 0.0]) == ["a"]
    assert svc.predict([[1.0, 0.0], [0.0, 1.0]]) == ["a", "b"]
    config = dict(class_names=["a", "b"], k=3, model_slug="m")
    res = reference.expected_result(config, ["r"], [5], np.array([[1, 1]]), 1, "f", "a", ["a", "b"])
    assert reference.wrong_answers({**res, "prediction": "b"}, res) == 0
    assert reference.wrong_answers({**res, "prediction": "c"}, res) == 1


@pytest.mark.parametrize("n_classes,per_class", [(40, 2), (5, 4), (3, 1)])
def test_the_reference_head_fits_as_sklearn_does(n_classes, per_class):
    # an independent witness for the frozen libsvm solver: sklearn's SVC,
    # on training scores shaped like the species model's (own class high,
    # the rest low, two decimals)
    svm = pytest.importorskip("sklearn.svm")
    from bench_port import svm_ref

    rng = np.random.default_rng(n_classes * 10 + per_class)
    labels = [f"{1000 + i}" for i in range(n_classes)]
    x = np.round(rng.uniform(0.0, 0.12, size=(n_classes * per_class, n_classes)), 2)
    y = [labels[i // per_class] for i in range(len(x))]
    for row, label in enumerate(y):
        x[row, labels.index(label)] = round(float(rng.uniform(0.8, 1.0)), 2)
    mine = svm_ref.fit_ovo_svc(x.tolist(), y, "rbf", 1.0)
    theirs = svm.SVC(kernel="rbf", C=1.0, decision_function_shape="ovo").fit(x, y)
    assert mine.classes == list(theirs.classes_) and mine.n_support == list(theirs.n_support_)
    assert np.array_equal(mine.support_vectors, theirs.support_vectors_)
    assert np.allclose(mine.dual_coef, theirs.dual_coef_, rtol=0, atol=1e-12)
    assert np.allclose(mine.intercept, theirs.intercept_, rtol=0, atol=1e-12)
    queries = np.round(rng.uniform(0.0, 1.0, size=(25, n_classes)), 2)
    assert np.allclose(mine.decisions(queries), theirs.decision_function(queries), rtol=0, atol=1e-12)
    assert mine.predict(queries) == list(theirs.predict(queries))
