"""The port's CLI (``xspect2_tpu_torch.main``) writes the JAX CLI's files.

Mirrors ``tests/test_cli.py``, ``test_cli_mlst.py`` and
``test_reference_import.py::test_cli_import_command``.  Both packages
train the same seeded tree (two species with SVM genomes, and the genus
model), each under its own ``XSPECT_DATA_ROOT``; every command then runs
through both CLIs with ``CliRunner``, the port's with ``--device cpu``,
each package under its own root and after a reload of its ``main``
(the registry's model choices are read at import).  Result JSON and
filtered FASTA must be byte-identical; files named with a ``uuid4`` are
matched by their stem, the uuid replaced.
"""

import importlib
import os
import re

import pytest
from click.testing import CliRunner

import xspect2_tpu.main as jax_main
import xspect2_tpu_torch.main as port_main
from tests.test_torch_train import _assert_same_tree
from tests.test_torch_train_directory import DISPLAY, _training_tree
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu import train as jax_train
from xspect2_tpu.io.fasta import SeqRecord, write_fasta
from xspect2_tpu_torch import model_cache, train

UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
PACKAGES = {"jax": (jax_main, []), "port": (port_main, ["--device", "cpu"])}


@pytest.fixture(scope="module")
def registries(tmp_path_factory):
    """The species (SVM) and genus models of one tree, trained by each
    package under its own data root: ({"jax": root, "port": root}, genomes)."""
    import numpy as np

    base = tmp_path_factory.mktemp("cli")
    genomes = _training_tree(base / "train", np.random.default_rng(4242))
    roots = {}
    old = os.environ.get("XSPECT_DATA_ROOT")
    try:
        for name, trainer, extra in (("jax", jax_train, {}), ("port", train, {"device": "cpu"})):
            roots[name] = base / f"{name}-data"
            os.environ["XSPECT_DATA_ROOT"] = str(roots[name])
            trainer.train_from_directory("Synthetic", base / "train", meta=True,
                                         translation_dict=DISPLAY, **extra)
    finally:
        if old is None:
            os.environ.pop("XSPECT_DATA_ROOT", None)
        else:
            os.environ["XSPECT_DATA_ROOT"] = old
    _assert_same_tree(roots["port"] / "models", roots["jax"] / "models")
    return roots, genomes


@pytest.fixture(autouse=True)
def _fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


def invoke(name, root, args, monkeypatch, cwd=None):
    """``args`` through package ``name``'s CLI under data root ``root``."""
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(root))
    module, extra = PACKAGES[name]
    cli = importlib.reload(module).cli
    if cwd is not None:
        monkeypatch.chdir(cwd)
    return CliRunner().invoke(cli, [*extra, *args])


def run_both(registries, tmp_path, monkeypatch, args):
    """Run ``args`` (``{out}`` -> each package's own output directory)
    through both CLIs; returns {name: (result, output dir)}."""
    roots, _ = registries
    out = {}
    for name in PACKAGES:
        out_dir = tmp_path / name
        out_dir.mkdir(exist_ok=True)
        result = invoke(name, roots[name], [a.replace("{out}", str(out_dir)) for a in args],
                        monkeypatch, cwd=out_dir)
        assert result.exit_code == 0, (name, result.output, result.exception)
        out[name] = (result, out_dir)
    return out


def assert_same_files(got_dir, want_dir):
    """Every file under both directories, paths and bytes, each uuid
    replaced by a placeholder."""
    def files(root):
        return {UUID.sub("<uuid>", str(p.relative_to(root))):
                UUID.sub("<uuid>", p.read_text(encoding="utf-8"))
                for p in sorted(root.rglob("*")) if p.is_file()}

    got, want = files(got_dir), files(want_dir)
    assert sorted(got) == sorted(want)
    for rel, text in want.items():
        assert got[rel] == text, rel
    return want


def _sample(tmp_path, genomes, name="sample.fasta", records=None):
    path = tmp_path / name
    write_fasta(records or [SeqRecord(genomes["470"], id="c1")], path)
    return path


def test_models_list_and_version(registries, monkeypatch):
    roots, _ = registries
    outputs = {name: invoke(name, roots[name], ["models", "list"], monkeypatch) for name in PACKAGES}
    assert outputs["port"].exit_code == 0
    assert outputs["port"].output == outputs["jax"].output
    assert "Species" in outputs["port"].output and "Synthetic" in outputs["port"].output
    versions = {name: invoke(name, roots[name], ["--version"], monkeypatch) for name in PACKAGES}
    assert versions["port"].exit_code == 0 and versions["port"].output == versions["jax"].output


@pytest.mark.parametrize("extra", [[], ["-n", "--exclude-species", "471"], ["--sparse-sampling-step", "3"]],
                         ids=["plain", "display-names-exclude", "step3"])
def test_classify_species(registries, tmp_path, monkeypatch, extra):
    sample = _sample(tmp_path, registries[1])
    out = run_both(registries, tmp_path, monkeypatch,
                   ["classify", "species", "-g", "Synthetic", "-i", str(sample), "-o", "{out}/out.json", *extra])
    assert out["port"][0].output == out["jax"][0].output
    files = assert_same_files(out["port"][1], out["jax"][1])
    assert '"prediction": "470"' in files["out.json"]


def test_classify_genus_and_default_output_name(registries, tmp_path, monkeypatch):
    """``-o`` left out: each CLI writes ``result_<uuid4>.json`` into the
    working directory, the uuid drawn at import."""
    sample = _sample(tmp_path, registries[1], records=[SeqRecord(registries[1]["471"][:4000], id="c")])
    out = run_both(registries, tmp_path, monkeypatch,
                   ["classify", "genus", "-g", "Synthetic", "-i", str(sample)])
    files = assert_same_files(out["port"][1], out["jax"][1])
    assert list(files) == ["result_<uuid>.json"]
    assert '"Synthetic": 1.0' in files["result_<uuid>.json"]


@pytest.mark.parametrize("threshold", ["-1", "0.7"])
def test_filter_species(registries, tmp_path, monkeypatch, threshold):
    genomes = registries[1]
    records = [SeqRecord(genomes["470"][i * 700 : i * 700 + 400], id=f"a{i}") for i in range(5)]
    records += [SeqRecord(genomes["471"][i * 700 : i * 700 + 400], id=f"b{i}") for i in range(5)]
    mixed = _sample(tmp_path, genomes, "mixed.fasta", records)
    out = run_both(registries, tmp_path, monkeypatch,
                   ["filter", "species", "-g", "Synthetic", "-s", "baumannii", "-i", str(mixed),
                    "-o", "{out}/filtered.fasta", "--classification-output-path", "{out}/cls.json",
                    "-t", threshold])
    files = assert_same_files(out["port"][1], out["jax"][1])
    assert set(files) == {"filtered.fasta", "cls.json"}
    assert files["filtered.fasta"].count(">a") == 5 and ">b" not in files["filtered.fasta"]


def test_filter_genus(registries, tmp_path, monkeypatch):
    import numpy as np

    genomes = registries[1]
    rng = np.random.default_rng(9)
    records = [SeqRecord(genomes["470"][i * 700 : i * 700 + 400], id=f"a{i}") for i in range(5)]
    records += [SeqRecord("".join(rng.choice(list("ACGT"), size=400)), id=f"junk{i}") for i in range(5)]
    mixed = _sample(tmp_path, genomes, "mixed.fasta", records)
    out = run_both(registries, tmp_path, monkeypatch,
                   ["filter", "genus", "-g", "Synthetic", "-i", str(mixed), "-o", "{out}/kept.fasta",
                    "-t", "0.7", "--classification-output-path", "{out}/genus.json"])
    files = assert_same_files(out["port"][1], out["jax"][1])
    assert ">a0" in files["kept.fasta"] and "junk" not in files["kept.fasta"]


def test_filter_species_bad_threshold(registries, monkeypatch):
    roots, _ = registries
    args = ["filter", "species", "-g", "Synthetic", "-i", ".", "-o", "x.fasta", "-t", "-3"]
    results = {name: invoke(name, roots[name], args, monkeypatch) for name in PACKAGES}
    assert results["port"].exit_code == results["jax"].exit_code != 0
    assert "Threshold" in results["port"].output
    assert results["port"].output.splitlines()[-1] == results["jax"].output.splitlines()[-1]


def test_all_pipeline(registries, tmp_path, monkeypatch):
    """Genus filter, species classification, and the MLST branch that
    finds no scheme: the same files (run uuid replaced) and output."""
    sample = _sample(tmp_path, registries[1])
    out = run_both(registries, tmp_path, monkeypatch,
                   ["all", "-g", "Synthetic", "-i", str(sample), "-o", "{out}/results"])
    texts = {name: UUID.sub("<uuid>", out[name][0].output.replace(str(out[name][1]), "<out>"))
             for name in PACKAGES}
    assert texts["port"] == texts["jax"]
    assert "No MLST schemes available" in texts["port"]
    files = assert_same_files(out["port"][1], out["jax"][1])
    species = [rel for rel in files if rel.startswith("results/species_classification_")]
    assert species and all('"prediction": "470"' in files[rel] for rel in species)
    assert any(rel.startswith("results/genus_classification_") for rel in files)


def test_models_train_directory(tmp_path, monkeypatch):
    """``models train directory`` writes byte-identical model trees."""
    import numpy as np

    tree = tmp_path / "train"
    _training_tree(tree, np.random.default_rng(7))
    for name in PACKAGES:
        result = invoke(name, tmp_path / f"{name}-data",
                        ["models", "train", "directory", "-g", "Cli", "-i", str(tree), "--svm-steps", "2",
                         "--author", "tester", "--author-email", "t@example.com"], monkeypatch)
        assert result.exit_code == 0, (name, result.output, result.exception)
    _assert_same_tree(tmp_path / "port-data" / "models", tmp_path / "jax-data" / "models")
    assert (tmp_path / "port-data" / "models" / "cli-species.json").exists()


@pytest.fixture()
def mlst_roots(tmp_path, monkeypatch):
    """One two-locus Oxford scheme for ``abaumannii``, fitted by each
    package under its own data root; the ST-name lookup (a network call)
    answers alike in both."""
    import numpy as np

    from tests.conftest import random_dna
    from xspect2_tpu.models import mlst_model as jax_mlst
    from xspect2_tpu_torch.models import mlst_model as port_mlst

    rng = np.random.default_rng(12345)
    scheme = tmp_path / "scheme"
    alleles = {}
    for locus in ("Oxf_cpn60", "Oxf_gltA"):
        (scheme / locus).mkdir(parents=True)
        base = random_dna(rng, 450)
        for n in (1, 2, 3):
            v = list(base)
            for _ in range(n * 3):
                v[int(rng.integers(0, 450))] = "ACGT"[int(rng.integers(0, 4))]
            alleles[(locus, n)] = "".join(v)
            write_fasta([SeqRecord(alleles[(locus, n)], id=f"{locus}_{n}")],
                        scheme / locus / f"Allele_ID_{n}.fasta")
    roots = {}
    for name, module, extra in (("jax", jax_mlst, {}), ("port", port_mlst, {"device": "cpu"})):
        monkeypatch.setattr(module.ProbabilisticFilterMlstSchemeModel, "_resolve_strain_type",
                            lambda self, highest: "ST-offline")
        roots[name] = tmp_path / f"{name}-data"
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(roots[name]))
        definitions = importlib.import_module(f"{module.__name__.split('.')[0]}.definitions")
        model = module.ProbabilisticFilterMlstSchemeModel(
            31, "Oxford", definitions.get_xspect_model_path(), "https://example.org/s/1", "abaumannii", **extra)
        model.fit(scheme)
        model.save()
    return roots, alleles


@pytest.mark.parametrize("limit", [[], ["-l"]], ids=["all", "limit"])
def test_classify_mlst(mlst_roots, tmp_path, monkeypatch, limit):
    roots, alleles = mlst_roots
    sample = _sample(tmp_path, None, records=[SeqRecord(alleles[("Oxf_cpn60", 2)], id="probe")])
    for name in PACKAGES:
        (tmp_path / name).mkdir()
        result = invoke(name, roots[name], ["classify", "mlst", "-i", str(sample), "--organism", "abaumannii",
                                            "--mlst-scheme", "Oxford", "-o", str(tmp_path / name / "mlst.json"),
                                            *limit], monkeypatch)
        assert result.exit_code == 0, (name, result.output, result.exception)
    files = assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert '"Allele_ID_2"' in files["mlst.json"] and "ST-offline" in files["mlst.json"]


def test_classify_mlst_unknown_scheme(mlst_roots, monkeypatch):
    roots, _ = mlst_roots
    args = ["classify", "mlst", "-i", ".", "--organism", "abaumannii", "--mlst-scheme", "NopeScheme"]
    results = {name: invoke(name, roots[name], args, monkeypatch) for name in PACKAGES}
    assert results["port"].exit_code == results["jax"].exit_code != 0
    assert "not found" in results["port"].output
    assert results["port"].output.splitlines()[-1] == results["jax"].output.splitlines()[-1]


def test_models_import_command(tmp_path, monkeypatch):
    """``models import`` rebuilds a reference bundle from the mock NCBI
    and PubMLST servers: the same statuses and model trees."""
    from tests.mock_services import MockServices
    from tests.test_reference_import import _make_reference_bundle

    bundle = _make_reference_bundle(tmp_path)
    with MockServices() as services:
        monkeypatch.setenv("XSPECT_NCBI_URL", services.url)
        monkeypatch.setenv("XSPECT_PUBMLST_URL", f"{services.url}/db")
        for module in ("xspect2_tpu", "xspect2_tpu_torch"):
            monkeypatch.setattr(f"{module}.handlers.http.HttpClient._wait_turn", lambda self: None)
        results = {name: invoke(name, tmp_path / f"{name}-data", ["models", "import", "-p", str(bundle)],
                                monkeypatch) for name in PACKAGES}
    assert results["port"].exit_code == 0, results["port"].output
    assert results["port"].output == results["jax"].output
    assert "rebuilt" in results["port"].output
    _assert_same_tree(tmp_path / "port-data" / "models", tmp_path / "jax-data" / "models")
