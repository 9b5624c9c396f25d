"""``xspect2_tpu_torch.train.train_from_directory`` writes the JAX package's
model trees byte for byte, and the port's registry reads them as the JAX
package's does.

The same seeded training tree goes through ``train_from_directory`` of
both packages, each under its own ``XSPECT_DATA_ROOT`` (both write the
registry there).  Mirrors ``tests/test_train_and_classify.py`` without
the CLI: the model directories (``.bbsi`` tables and metadata, model
JSON, ``scores.csv``, the genus model) must be byte-identical, the
registry listings, the facades' result JSON and the metadata and
display-name updates equal.
"""

import json
import shutil

import numpy as np
import pytest

import xspect2_tpu.model_management as jax_mm
import xspect2_tpu_torch.model_management as mm
from tests.conftest import random_dna
from tests.test_torch_train import _assert_same_tree
from xspect2_tpu import classify as jax_classify
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu import train as jax_train
from xspect2_tpu.io.fasta import SeqRecord, write_fasta
from xspect2_tpu_torch import classify, model_cache, train

DISPLAY = {"470": "Synthetic baumannii", "471": "Synthetic pittii"}


def _training_tree(root, rng, svm=True):
    """Two species of 8 kbp (one FASTA each under ``cobs/<label>/``) and,
    with ``svm``, two variant genomes per species under ``svm/<label>/``."""
    genomes = {}
    for label in DISPLAY:
        base = random_dna(rng, 8000)
        genomes[label] = base
        (root / "cobs" / label).mkdir(parents=True)
        write_fasta([SeqRecord(base, id=label)], root / "cobs" / label / "a.fasta")
        if svm:
            (root / "svm" / label).mkdir(parents=True)
            for j in range(2):
                variant = list(base)
                variant[500 * (j + 1) : 500 * (j + 1) + 300] = random_dna(rng, 300)
                write_fasta([SeqRecord("".join(variant), id=f"{label}v{j}")],
                            root / "svm" / label / f"ACC{j}.fasta")
    return genomes


def _train_both(tmp_path, monkeypatch, svm=True, **kwargs):
    """Train the same tree with both packages; returns (jax root, port
    root, genomes).  Each package writes under its own data root."""
    tree = tmp_path / "train"
    genomes = _training_tree(tree, np.random.default_rng(12345), svm=svm)
    roots = {}
    for name, trainer, extra in (("jax", jax_train, {}), ("port", train, {"device": "cpu"})):
        roots[name] = tmp_path / f"{name}-data"
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(roots[name]))
        trainer.train_from_directory("Synthetic", tree, **kwargs, **extra)
    return roots["jax"], roots["port"], genomes


@pytest.fixture()
def fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


@pytest.mark.parametrize(
    "svm, kwargs",
    [
        (True, dict(meta=True, translation_dict=DISPLAY, author="tester", author_email="t@example.com")),
        (True, dict(meta=False, svm_step=3, training_accessions={"470": ["A1"], "471": ["B1"]},
                    svm_accessions={"470": ["A2"], "471": ["B2"]})),
        (False, dict(meta=True, translation_dict=DISPLAY, training_accessions={"470": ["A1", "A2"], "471": ["B1"]})),
    ],
    ids=["svm-meta", "svm-step3-accessions", "plain-meta"],
)
def test_model_trees_are_byte_identical(tmp_path, monkeypatch, svm, kwargs, capsys):
    jax_root, port_root, _ = _train_both(tmp_path, monkeypatch, svm=svm, **kwargs)
    _assert_same_tree(port_root / "models", jax_root / "models")
    slugs = sorted(p.name for p in (port_root / "models").glob("*.json"))
    want = ["synthetic-genus.json", "synthetic-species.json"] if kwargs["meta"] else ["synthetic-species.json"]
    assert slugs == want
    meta = json.loads((port_root / "models" / "synthetic-species.json").read_text())
    assert meta["model_class"] == ("ProbabilisticFilterSVMModel" if svm else "ProbabilisticFilterModel")
    assert (port_root / "models" / "synthetic-species" / "scores.csv").exists() == svm
    if not svm:
        assert "SVM directory not found" in capsys.readouterr().out


def test_registry_listings_and_updates_equal(tmp_path, monkeypatch):
    jax_root, port_root, _ = _train_both(
        tmp_path, monkeypatch, meta=True, translation_dict=DISPLAY, author="tester", author_email="t@example.com")
    for root in (jax_root, port_root):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(root))
        models = mm.get_models()
        assert {k: sorted(v) for k, v in models.items()} == {
            k: sorted(v) for k, v in jax_mm.get_models().items()} == {"Species": ["Synthetic"], "Genus": ["Synthetic"]}
        assert mm.is_svm_model("synthetic-species") and jax_mm.is_svm_model("synthetic-species")
        assert not mm.is_svm_model("synthetic-genus")
        assert mm.get_model_metadata("synthetic-species") == jax_mm.get_model_metadata("synthetic-species")
        assert mm.get_model_display_names("synthetic-species") == jax_mm.get_model_display_names(
            "synthetic-species") == ["Synthetic baumannii", "Synthetic pittii"]
        assert mm.get_available_mlst_schemes() == jax_mm.get_available_mlst_schemes() == {}
        assert mm.get_species_model_path("Synthetic") == jax_mm.get_species_model_path("Synthetic")
        assert mm.metadata_path("../Synthetic-species") == root / "models" / "synthetic-species.json"
    meta = mm.get_model_metadata("synthetic-species")
    assert meta["display_names"]["470"] == "Synthetic baumannii" and meta["author"] == "tester"
    assert meta["k"] == 21 and meta["kernel"] == "rbf" and meta["C"] == 1.0
    with pytest.raises(ValueError, match="does not exist"):
        mm.get_model_metadata("nothing-here")
    with pytest.raises(ValueError, match="string"):
        mm.get_model_metadata(3)

    # the same updates through either package leave the same bytes
    for root, module in ((jax_root, jax_mm), (port_root, mm)):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(root))
        module.update_model_metadata("synthetic-species", "alice", "a@b.c")
        module.update_model_display_name("synthetic-species", "470", "Renamed")
    _assert_same_tree(port_root / "models", jax_root / "models")
    assert mm.get_model_metadata("synthetic-species")["author"] == "alice"
    assert "Renamed" in mm.get_model_display_names("synthetic-species")
    assert mm.ModelRegistry(jax_root / "models").read_metadata("synthetic-species")["display_names"]["470"] == "Renamed"


def test_facades_write_the_jax_json(tmp_path, monkeypatch, fresh_caches):
    jax_root, port_root, genomes = _train_both(tmp_path, monkeypatch, meta=True, translation_dict=DISPLAY)
    in_dir = tmp_path / "inputs"
    in_dir.mkdir()
    for i, label in enumerate(DISPLAY):
        write_fasta([SeqRecord(genomes[label], id=f"s{i}")], in_dir / f"s{i}.fasta")
    sample = tmp_path / "sample.fasta"
    write_fasta([SeqRecord(genomes["470"][:3000], id="c1"), SeqRecord(genomes["471"][2000:2500], id="c2")], sample)
    for name, root, module, extra in (("jax", jax_root, jax_classify, {}), ("port", port_root, classify, {"device": "cpu"})):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(root))
        out = tmp_path / name
        out.mkdir()
        module.classify_species("Synthetic", in_dir, out / "res.json", **extra)
        module.classify_species("Synthetic", sample, out / "one.json", step=2, display_name=True, **extra)
        module.classify_genus("Synthetic", sample, out / "genus.json", **extra)
    for rel in ("res_1.json", "res_2.json", "one.json", "genus.json"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
    preds = {json.loads((tmp_path / "port" / f"res_{i}.json").read_text())["prediction"] for i in (1, 2)}
    assert preds == {"470", "471"}
    genus = json.loads((tmp_path / "port" / "genus.json").read_text())
    assert genus["scores"]["total"]["Synthetic"] == 1.0


@pytest.mark.parametrize("case", ["not-a-dir", "no-cobs", "empty-cobs", "svm-count", "svm-names", "display-name"])
def test_training_layout_errors_match_jax(tmp_path, monkeypatch, case):
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "data"))
    tree = tmp_path / "train"
    _training_tree(tree, np.random.default_rng(1))
    name, target = "Synthetic", tree
    if case == "not-a-dir":
        target = tree / "cobs" / "470" / "a.fasta"
    elif case == "no-cobs":
        shutil.rmtree(tree / "cobs")
    elif case == "empty-cobs":
        for label in DISPLAY:
            shutil.rmtree(tree / "cobs" / label)
    elif case == "svm-count":
        shutil.rmtree(tree / "svm" / "471")
    elif case == "svm-names":
        (tree / "svm" / "471").rename(tree / "svm" / "472")
    else:
        name = 3
    errors = []
    for trainer, extra in ((jax_train, {}), (train, {"device": "cpu"})):
        with pytest.raises((TypeError, ValueError)) as exc:
            trainer.train_from_directory(name, target, **extra)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]
    assert not list((tmp_path / "data").glob("models/*.json"))
