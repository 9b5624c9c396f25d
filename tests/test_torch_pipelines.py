"""The port's pipelines (``xspect2_tpu_torch.pipelines``) equal the JAX
package's.

Mirrors ``tests/test_pipelines.py``: the benchmark statistics of the same
rows; ``classifications.tsv`` and ``stats.json`` of both benchmarks,
byte for byte, on the models of ``tests/test_torch_cli.py`` (trained by
each package under its own data root); the LOO grid search against the
JAX package's (sklearn's ``SVC``) on tie-free data for all four kernels;
and ``train_pangenome``'s model trees and results under forced failures
and retries.
"""

import numpy as np
import pytest

from tests.test_torch_cli import registries  # noqa: F401 - module fixture
from tests.test_torch_train import _assert_same_tree
from tests.test_torch_train_directory import _training_tree
from xspect2_tpu import pipelines as jax_pipelines
from xspect2_tpu import train as jax_train
from xspect2_tpu.core import dna
from xspect2_tpu.io.fasta import SeqRecord, write_fasta
from xspect2_tpu.models.single_filter_model import ProbabilisticSingleFilterModel as JaxGenus
from xspect2_tpu.models.svm_model import ProbabilisticFilterSVMModel as JaxSVM
from xspect2_tpu.pipelines import score_svm as jax_score_svm
from xspect2_tpu_torch import pipelines, train
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel
from xspect2_tpu_torch.pipelines import benchmark, score_svm


def test_pipelines_export_the_jax_names():
    assert pipelines.__all__ == jax_pipelines.__all__
    assert all(callable(getattr(pipelines, name)) for name in pipelines.__all__)


@pytest.mark.parametrize("rows", [
    [("a", "x", "x"), ("b", "y", "y"), ("c", "x", "x")],
    [("a", "x", "x"), ("b", "y", "x"), ("c", "x", "x"), ("d", "y", "y")],
    [("r0", "x", "x"), ("r1", "x", "ambiguous"), ("r2", "y", "x"), ("r3", "y", "y")],
    [("r0", "x", "ambiguous"), ("r1", "y", "ambiguous")],
    [],
])
def test_statistics_equal_jax(rows):
    assert benchmark.evaluate_assembly_classifications(rows) == \
        jax_pipelines.evaluate_assembly_classifications(rows)
    assert benchmark.evaluate_read_classifications(rows) == jax_pipelines.evaluate_read_classifications(rows)
    if rows:
        assert benchmark.evaluate_read_labels([r[1] for r in rows], [r[2] for r in rows]) == \
            benchmark.evaluate_read_classifications(rows)


@pytest.mark.parametrize("hits,want", [
    ({}, "ambiguous"), ({"a": 3, "b": 3}, "ambiguous"), ({"a": 1, "b": 4, "c": 4}, "ambiguous"),
    ({"a": 5, "b": 4}, "a"), ({"a": 0, "b": 2}, "b"),
])
def test_tie_rule_equals_jax(hits, want):
    from xspect2_tpu.pipelines.benchmark import _argmax_or_ambiguous

    assert benchmark._argmax_or_ambiguous(hits) == _argmax_or_ambiguous(hits) == want


def _models(registries, kind):  # noqa: F811
    roots, _ = registries
    slug = f"synthetic-{kind}.json"
    if kind == "species":
        return JaxSVM.load(roots["jax"] / "models" / slug), ProbabilisticFilterSVMModel.load(
            roots["port"] / "models" / slug, device="cpu")
    return JaxGenus.load(roots["jax"] / "models" / slug), ProbabilisticSingleFilterModel.load(
        roots["port"] / "models" / slug, device="cpu")


def _same_outputs(tmp_path):
    for name in ("classifications.tsv", "stats.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    return (tmp_path / "port" / "classifications.tsv").read_text()


@pytest.mark.parametrize("kind", ["species", "genus"])
@pytest.mark.parametrize("step", [1, 3])
def test_assembly_benchmark_files_equal_jax(registries, tmp_path, kind, step):  # noqa: F811
    """Assemblies of both species, a hybrid and a random one: the SVM's
    prediction (species) or the tie rule on total hits (genus)."""
    _, genomes = registries
    rng = np.random.default_rng(3)
    seqs = {"470": genomes["470"], "471": genomes["471"],
            "hybrid": genomes["470"][:4000] + genomes["471"][4000:],
            "random": "".join(rng.choice(list("ACGT"), size=5000))}
    samples = []
    for label, seq in seqs.items():
        path = tmp_path / f"{label}_sample.fasta"
        write_fasta([SeqRecord(seq[:3000], id=f"{label}a"), SeqRecord(seq[3000:], id=f"{label}b")], path)
        samples.append((path, label if kind == "species" else "Synthetic"))
    jax_model, model = _models(registries, kind)
    want = jax_pipelines.run_assembly_benchmark(jax_model, samples, step=step, out_dir=tmp_path / "jax")
    got = pipelines.run_assembly_benchmark(model, samples, step=step, out_dir=tmp_path / "port", device="cpu")
    assert got.rows == want.rows and got.stats == want.stats
    assert got.per_sample_scores == want.per_sample_scores
    tsv = _same_outputs(tmp_path)
    if kind == "species":
        assert "470_sample.fasta\t470\t470" in tsv and "471_sample.fasta\t471\t471" in tsv


@pytest.mark.parametrize("step", [1, 2])
def test_read_benchmark_files_equal_jax(registries, tmp_path, step):  # noqa: F811
    """Reads of both species, a few with an N, random reads, and reads of N
    only (which tie at zero hits: ``ambiguous``), in batches of 32."""
    _, genomes = registries
    rng = np.random.default_rng(5)
    labels = sorted(genomes)
    reads = np.zeros((100, 150), dtype=np.uint8)
    true = []
    for i in range(100):
        if i % 10 == 9:
            reads[i] = rng.integers(0, 4, size=150)
            true.append(labels[0])
            continue
        label = labels[i % 2]
        start = int(rng.integers(0, len(genomes[label]) - 150))
        reads[i] = dna.encode(genomes[label][start : start + 150])
        true.append(label)
    reads[[3, 40], [10, 149]] = 255
    reads[[19, 59]] = 255
    jax_model, model = _models(registries, "species")
    want = jax_pipelines.run_read_benchmark(jax_model, reads, true, step=step, batch_reads=32,
                                            out_dir=tmp_path / "jax")
    got = pipelines.run_read_benchmark(model, reads, true, step=step, batch_reads=32,
                                       out_dir=tmp_path / "port", device="cpu")
    assert got.rows == want.rows and got.stats == want.stats
    tsv = _same_outputs(tmp_path)
    assert "\tambiguous" in tsv and got.stats["total"] == 100 and got.stats["accuracy"] > 0.8


def test_benchmarks_refuse_a_model_on_another_device(registries, monkeypatch):  # noqa: F811
    """A benchmark on the card (here a card pretended) refuses a model
    loaded on the CPU instead of running it there."""
    import torch

    _, model = _models(registries, "species")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="the model is on cpu, the benchmark runs on cuda"):
        pipelines.run_read_benchmark(model, np.zeros((2, 40), np.uint8), ["470", "471"])
    with pytest.raises(ValueError, match="the model is on cpu"):
        pipelines.run_assembly_benchmark(model, [])


def _blobs(n_per_class, seed):
    """Three overlapping classes of continuous 3-D scores: no two rows, and
    no decision value, tie."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(c * 1.5, 1.0, (n_per_class, 3)) for c in range(3)])
    y = [label for label in "abc" for _ in range(n_per_class)]
    return x, y


@pytest.mark.parametrize("kernel", ["linear", "rbf", "poly", "sigmoid"])
def test_grid_search_equals_sklearn(kernel):
    x, y = _blobs(10, 5)
    want = jax_score_svm.grid_search_svm(x, y, kernels=(kernel,), cs=(0.1, 1.0, 10.0))
    got = score_svm.grid_search_svm(x, y, kernels=(kernel,), cs=(0.1, 1.0, 10.0), device="cpu")
    assert got == want
    assert len({r["loo_accuracy"] for r in got}) > 1 or kernel == "linear"


def test_grid_search_default_grid_and_order_equal_sklearn():
    """The default grid (four kernels x three C), sorted best first with
    the stable sort's order among equal accuracies; a class left with one
    row is skipped in its fold, as in the JAX package."""
    x, y = _blobs(4, 11)
    x, y = np.concatenate([x, [[9.0, 9.0, 9.0]]]), [*y, "d"]
    want = jax_score_svm.grid_search_svm(x, y)
    got = score_svm.grid_search_svm(x, y, device="cpu")
    assert got == want and len(got) == 12


def test_grid_search_model_equals_jax(registries):  # noqa: F811
    jax_model, model = _models(registries, "species")
    want = jax_score_svm.grid_search_model(jax_model)
    got = score_svm.grid_search_model(model, device="cpu")
    assert got == want and {r["kernel"] for r in got} == {"linear", "rbf"}


@pytest.fixture()
def flaky_trainers(monkeypatch):
    """Both packages' ``train_from_directory`` fail the first attempt of
    every genus whose name starts with "Flaky" (a transient error), then
    train; returns the attempts of each package."""
    attempts = {"jax": [], "port": []}
    for name, module in (("jax", jax_train), ("port", train)):
        real = module.train_from_directory

        def flaky(genus, *args, _real=real, _seen=attempts[name], **kwargs):
            _seen.append(genus)
            if genus.startswith("Flaky") and _seen.count(genus) == 1:
                raise RuntimeError(f"transient failure training {genus}")
            return _real(genus, *args, **kwargs)

        monkeypatch.setattr(module, "train_from_directory", flaky)
    return attempts


def test_train_pangenome_trees_and_results_equal_jax(tmp_path, monkeypatch, flaky_trainers):
    """One genus trains, one trains at its second attempt, one (no
    ``cobs/``) fails every attempt: the same results and model trees."""
    data = tmp_path / "genera"
    _training_tree(data / "Good", np.random.default_rng(1))
    _training_tree(data / "FlakyOne", np.random.default_rng(2))
    (data / "Broken").mkdir(parents=True)
    genera = ["Good", "FlakyOne", "Broken"]
    results = {}
    for name, fn, extra in (("jax", jax_pipelines.train_pangenome, {}),
                            ("port", pipelines.train_pangenome, {"device": "cpu"})):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / f"{name}-data"))
        results[name] = fn(genera, data_root=data, svm_step=2, author="pan", max_retries=2,
                           retry_delay=0, **extra)
    assert results["port"] == results["jax"]
    assert results["port"]["Good"] == results["port"]["FlakyOne"] == "ok"
    assert results["port"]["Broken"] != "ok"
    assert flaky_trainers["port"] == flaky_trainers["jax"] == ["Good", "FlakyOne", "FlakyOne", "Broken", "Broken"]
    _assert_same_tree(tmp_path / "port-data" / "models", tmp_path / "jax-data" / "models")
    assert len(list((tmp_path / "port-data" / "models").glob("*.json"))) == 4


def test_train_pangenome_stops_on_error_as_jax(tmp_path, monkeypatch):
    (tmp_path / "genera" / "Broken").mkdir(parents=True)
    errors = {}
    for name, fn, extra in (("jax", jax_pipelines.train_pangenome, {}),
                            ("port", pipelines.train_pangenome, {"device": "cpu"})):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / f"{name}-data"))
        with pytest.raises(Exception) as info:
            fn(["Broken"], data_root=tmp_path / "genera", continue_on_error=False, max_retries=0,
               retry_delay=0, **extra)
        errors[name] = (type(info.value).__name__, str(info.value))
    assert errors["port"] == errors["jax"]
