"""The port trains filter, genus and SVM models byte for byte as the JAX package does.

The same seeded training files go through ``fit`` of both packages, each
into its own model directory; the ``.bbsi`` tables and metadata, the
model metadata JSON and ``scores.csv`` must be byte-identical, with the
native host library and with its numpy fallbacks.  The port fits its
SVM head with its own copy of libsvm's solver; that fit is held against
sklearn's, bit for bit.
"""

import numpy as np
import pytest

import xspect2_tpu.native as jax_native
import xspect2_tpu_torch.native as native
from tests.conftest import random_dna
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta
from xspect2_tpu.models.filter_model import ProbabilisticFilterModel as JaxFilterModel
from xspect2_tpu.models.single_filter_model import (
    ProbabilisticSingleFilterModel as JaxSingleFilterModel,
)
from xspect2_tpu.models.svm_head import fit_svc
from xspect2_tpu.models.svm_model import ProbabilisticFilterSVMModel as JaxSVMModel
from xspect2_tpu_torch.io.fasta import SeqRecord
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.models.svm_head import SVMHead, fit_ovo_svc
from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_same_tree(got_root, want_root):
    assert _files(got_root) == _files(want_root)
    for rel in _files(want_root):
        assert (got_root / rel).read_bytes() == (want_root / rel).read_bytes(), str(rel)


@pytest.fixture(params=["native", "numpy"])
def host_library(request, monkeypatch):
    """Train with the native host library, or with both packages' numpy
    fallbacks."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


@pytest.fixture()
def training_dir(tmp_path):
    """Three species (two multi-record files, '471' sharing 60% of '470')
    and two SVM genomes per species."""
    rng = np.random.default_rng(31)
    d = tmp_path / "train"
    (d / "cobs").mkdir(parents=True)
    g470 = random_dna(rng, 6000)
    genomes = {"470": g470, "471": g470[:3600] + random_dna(rng, 2400), "480": random_dna(rng, 5000)}
    for name, seq in genomes.items():
        records = [JaxSeqRecord(seq[:2500], id=f"{name}a"), JaxSeqRecord(seq[2500:], id=f"{name}b")]
        write_fasta(records, d / "cobs" / f"{name}.fasta")
        (d / "svm" / name).mkdir(parents=True)
        for j in range(2):
            variant = list(seq)
            variant[400 * (j + 1) : 400 * (j + 1) + 200] = random_dna(rng, 200)
            contigs = "".join(variant)
            write_fasta(
                [JaxSeqRecord(contigs[:1700], id="c1"), JaxSeqRecord(contigs[1700:], id="c2")],
                d / "svm" / name / f"GCF_{name}{j}.fna",
            )
    (d / "cobs" / "notes.txt").write_text("not a sequence file\n", encoding="utf-8")
    return d, genomes


@pytest.mark.parametrize("num_hashes", [None, 7])
def test_filter_model_fit_is_byte_identical(tmp_path, training_dir, host_library, num_hashes):
    d, _ = training_dir
    models = {}
    for cls, sub in ((JaxFilterModel, "jax"), (ProbabilisticFilterModel, "torch")):
        kwargs = {} if cls is JaxFilterModel else {"device": "cpu"}
        model = cls(21, "Synthetic", "a", "a@b.c", "Species", tmp_path / sub, num_hashes=num_hashes, **kwargs)
        model.fit(d / "cobs", display_names={"470": "Synthetic baumannii"}, training_accessions={"470": ["x"]})
        model.save()
        models[sub] = model
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    assert models["torch"].display_names == {"470": "Synthetic baumannii", "471": "471", "480": "480"}
    assert models["torch"].num_hashes == models["jax"].num_hashes


def test_fit_rejects_what_the_jax_package_rejects(tmp_path):
    model = ProbabilisticFilterModel(21, "S", None, None, "Species", tmp_path, device="cpu")
    (tmp_path / "empty").mkdir()
    (tmp_path / "file.fasta").write_text(">a\nACGT\n", encoding="utf-8")
    for arg, msg in (
        (str(tmp_path), "pathlib.Path"),
        (tmp_path / "missing", "does not exist"),
        (tmp_path / "file.fasta", "must be a directory"),
        (tmp_path / "empty", "No valid files"),
    ):
        with pytest.raises(ValueError, match=msg):
            model.fit(arg)


def test_genus_model_fit_is_byte_identical(tmp_path, training_dir, host_library):
    d, genomes = training_dir
    meta = tmp_path / "Synthgenus.fasta"
    write_fasta([JaxSeqRecord(g, id=n) for n, g in genomes.items()], meta)
    for cls, sub in ((JaxSingleFilterModel, "jax"), (ProbabilisticSingleFilterModel, "torch")):
        kwargs = {} if cls is JaxSingleFilterModel else {"device": "cpu"}
        model = cls(21, "Synthgenus", None, None, "Genus", tmp_path / sub, **kwargs)
        model.fit(meta, "Synthgenus", training_accessions=["GCF_1"])
        model.save()
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    probe = genomes["480"][100:122]
    assert model.calculate_hits(probe) == {"Synthgenus": 2}


@pytest.mark.parametrize("svm_step", [1, 3])
def test_svm_model_fit_writes_the_jax_scores(tmp_path, training_dir, svm_step):
    d, genomes = training_dir
    models = {}
    for cls, sub in ((JaxSVMModel, "jax"), (ProbabilisticFilterSVMModel, "torch")):
        kwargs = {} if cls is JaxSVMModel else {"device": "cpu"}
        model = cls(21, "Synthetic", None, None, "Species", tmp_path / sub, kernel="rbf", c=1.0, **kwargs)
        model.fit(d / "cobs", d / "svm", svm_step=svm_step, svm_accessions={"470": ["GCF_4700"]})
        model.save()
        models[sub] = model
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    scores = (tmp_path / "torch" / "synthetic-species" / "scores.csv").read_text(encoding="utf-8")
    assert scores.splitlines()[0] == "file,470,471,480,label_id"
    assert len(scores.splitlines()) == 7
    for label in ("470", "471", "480"):
        # past the 3,600 bases that 470 and 471 share
        rec = JaxSeqRecord(genomes[label][3700:4900], id="q")
        want = models["jax"].predict(rec)
        got = models["torch"].predict(SeqRecord(rec.seq, id="q"))
        assert got.prediction == want.prediction == label

    for sub in ("jax", "torch"):
        models[sub].set_svm_params("linear", 0.5)
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    assert models["torch"].to_dict()["kernel"] == "linear"


def _score_data(rng, n_classes, per):
    x, y = [], []
    for c in range(n_classes):
        block = np.clip(rng.normal(0.05, 0.03, (per, n_classes)), 0, 1)
        block[:, c] = rng.uniform(0.3, 0.95, per)
        x.append(block)
        y += [f"{470 + c}"] * per
    return np.round(np.concatenate(x), 2), y


def _assert_same_fit(got, want):
    """The same support vectors, dual coefficients and intercepts, bit for bit."""
    assert got.classes == want.classes and got.n_support == want.n_support
    assert got.gamma == want.gamma
    for name in ("support_vectors", "dual_coef", "intercept"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy(), err_msg=name)


@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly", "sigmoid"])
def test_own_svc_fit_agrees_with_sklearn(kernel):
    """The port's solver gives sklearn's fit bit for bit, and its head
    predicts as sklearn does, over a range of class and sample counts."""
    rng = np.random.default_rng(len(kernel))
    for n_classes, per in ((2, 3), (3, 2), (5, 4), (8, 2), (4, 40)):
        x, y = _score_data(rng, n_classes, per)
        svc = fit_svc(x, y, kernel, 1.0)
        got = fit_ovo_svc(x, y, kernel, 1.0)
        _assert_same_fit(got, SVMHead.from_sklearn(svc))
        xt = np.clip(rng.normal(0.1, 0.2, (400, n_classes)), 0, 1)
        assert got.predict(xt) == [str(v) for v in svc.predict(xt)]


def _chip_scores(rng, rows):
    """scores.csv of 40 classes x 2 assemblies, as the chip smoke test
    trains on: own-class scores near 0.81, the others near 0.01, rounded
    to 2 decimals.  ``equal`` scores both assemblies of a class alike."""
    x = np.full((80, 40), 0.01)
    if rows == "spread":
        x = rng.choice([0.0, 0.01, 0.01, 0.02], size=(80, 40))
    for c in range(40):
        x[2 * c : 2 * c + 2, c] = np.round(rng.uniform(0.74, 0.86, 2), 2) if rows == "spread" else 0.81
    return x, [f"{100 + c}" for c in range(40) for _ in range(2)]


@pytest.mark.parametrize("rows", ["spread", "equal"])
def test_own_svc_fit_agrees_with_sklearn_at_the_chip_shape(rows):
    """40 classes x 2 samples on rbf (780 class pairs), the shape of the
    chip smoke test's scores.csv: sklearn's fit bit for bit, and
    sklearn's predictions on a dense held-out set.

    With spread scores the held-out set is every 0.05 step of the scores
    of 40 class pairs, plus noisy low-score vectors.  Where both
    assemblies of every class score alike the training set is symmetric:
    a point that scores two classes alike lies exactly on their boundary,
    and its vote there follows the last bit of a sum that sklearn and the
    head order differently.  The held-out set is then every 0.05 step of
    one class's score over noisy others, where that class wins all 39 of
    its pairs whichever way such ties fall.
    """
    rng = np.random.default_rng(40)
    x, y = _chip_scores(rng, rows)
    svc = fit_svc(x, y, "rbf", 1.0)
    got = fit_ovo_svc(x, y, "rbf", 1.0)
    _assert_same_fit(got, SVMHead.from_sklearn(svc))

    grid = np.linspace(0, 1, 21)
    if rows == "spread":
        a, b = (v.ravel() for v in np.meshgrid(grid, grid))
        held = [np.round(np.clip(rng.normal(0.02, 0.05, (4000, 40)), 0, 1), 2)]
        for i, j in (rng.choice(40, 2, replace=False) for _ in range(40)):
            p = np.full((len(a), 40), 0.01)
            p[:, i], p[:, j] = a, b
            held.append(p)
        xt = np.concatenate(held)
    else:
        xt = rng.choice([0.0, 0.01, 0.01, 0.02], size=(40 * 15 * 10, 40))
        rows_of = np.arange(len(xt))
        xt[rows_of, rows_of // 150] = np.tile(np.repeat(grid[6:], 10), 40)
    assert got.predict(xt) == [str(v) for v in svc.predict(xt)]


def test_svm_model_predicts_without_sklearn(tmp_path, training_dir, monkeypatch):
    """The port fits and evaluates its SVM head with no sklearn to import
    (as on a machine without it) and predicts as the JAX package's
    sklearn head does."""
    import builtins

    d, genomes = training_dir
    jax_model = JaxSVMModel(21, "Synthetic", None, None, "Species", tmp_path / "jax", kernel="rbf", c=1.0)
    jax_model.fit(d / "cobs", d / "svm")
    labels = ("470", "471", "480")
    want = [jax_model.predict(JaxSeqRecord(genomes[label][3700:4900], id=label)).prediction for label in labels]
    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.startswith("sklearn"):
            raise ImportError("no sklearn here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    model = ProbabilisticFilterSVMModel(
        21, "Synthetic", None, None, "Species", tmp_path / "torch", kernel="rbf", c=1.0, device="cpu"
    )
    model.fit(d / "cobs", d / "svm")
    recs = [SeqRecord(genomes[label][3700:4900], id=label) for label in labels]
    assert [model.predict(r).prediction for r in recs] == want == list(labels)
