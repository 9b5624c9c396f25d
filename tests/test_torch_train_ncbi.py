"""NCBI and PubMLST training of the port against the mock services.

``train_from_ncbi`` and ``train_mlst`` of both packages run against
``tests/mock_services.py`` (nothing leaves the machine), each under its
own ``XSPECT_DATA_ROOT``; the model trees must be byte-identical.  The
port's ``NCBIHandler`` is held to the NCBI half of
``tests/test_handlers.py``.
"""

import zipfile

import numpy as np
import pytest

import xspect2_tpu.handlers.ncbi as jax_ncbi
from tests.mock_services import (
    GENUS_TAX_ID,
    MLST_LOCI,
    MLST_ORGANISM,
    MLST_SCHEME,
    MLST_ST_FIELDS,
    SPECIES_TAX_IDS,
    MockServices,
    allele_seq,
    genome_for,
)
from tests.test_torch_train import _assert_same_tree
from xspect2_tpu import train as jax_train
from xspect2_tpu_torch import model_management as mm
from xspect2_tpu_torch import train
from xspect2_tpu_torch.handlers.ncbi import QUALITY_ORDER, AssemblyLevel, AssemblySource, NCBIHandler, _report_passes
from xspect2_tpu_torch.io.fasta import SeqRecord


@pytest.fixture(scope="module")
def services():
    with MockServices() as svc:
        yield svc


@pytest.fixture()
def no_wait(monkeypatch):
    """No sleeping in tests: drop the anonymous 5 rps limit of both packages."""
    for module in ("xspect2_tpu", "xspect2_tpu_torch"):
        monkeypatch.setattr(f"{module}.handlers.http.HttpClient._wait_turn", lambda self: None)


@pytest.fixture()
def ncbi(services):
    handler = NCBIHandler(base_url=services.url)
    handler.http.min_interval = 0  # tests should not sleep
    return handler


def _run_both(tmp_path, monkeypatch, jax_call, port_call):
    roots = {}
    for name, call in (("jax", jax_call), ("port", port_call)):
        roots[name] = tmp_path / f"{name}-data"
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(roots[name]))
        call()
    _assert_same_tree(roots["port"] / "models", roots["jax"] / "models")
    return roots["port"]


def test_train_from_ncbi_trees_equal_the_jax_package(services, tmp_path, monkeypatch, no_wait):
    monkeypatch.setenv("XSPECT_NCBI_URL", services.url)
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    _run_both(tmp_path, monkeypatch, lambda: jax_train.train_from_ncbi("Testus"),
              lambda: train.train_from_ncbi("Testus", device="cpu"))
    meta = mm.get_model_metadata(mm.get_species_model_path("Testus"))
    # Candidatus + " sp." species filtered; 101 + 102 trained, 4 + 4 accessions each
    assert sorted(meta["display_names"]) == ["101", "102"]
    assert meta["display_names"]["101"] == "Testus primus"
    assert meta["training_accessions"]["101"] == ["GCF_101.1", "GCF_101.2", "GCF_101.3", "GCF_101.4"]
    assert len(meta["svm_accessions"]["101"]) == 4
    model = ProbabilisticFilterSVMModel.load(mm.get_species_model_path("Testus"), device="cpu")
    hits = model.calculate_hits(genome_for("GCF_102.1")[100:400])
    assert max(hits, key=hits.get) == "102"
    assert mm.get_model_metadata(mm.get_genus_model_path("Testus"))["model_type"] == "Genus"


@pytest.mark.parametrize("flags", [
    {}, dict(allow_candidatus=True, allow_sp=True), dict(allow_inconclusive=True, min_n50=0),
    dict(exclude_atypical=False),
])
def test_species_selection_matches_jax(services, flags):
    """The accession plan of every species, placeholders kept on request
    (103 and 104 have no assemblies and drop out)."""
    plans = []
    for handler_cls, select in ((jax_ncbi.NCBIHandler, jax_train._select_species),
                                (NCBIHandler, train._select_species)):
        handler = handler_cls(base_url=services.url)
        handler.http.min_interval = 0
        kwargs = dict(min_n50=10000, exclude_atypical=True, allow_inconclusive=False,
                      allow_candidatus=False, allow_sp=False) | flags
        plans.append([(s.tax_id, s.name, s.accessions, s.index_accessions, s.svm_accessions)
                      for s in select(handler, "Testus", **kwargs)])
    assert plans[0] == plans[1]
    assert [p[0] for p in plans[1]] == [101, 102] and len(plans[1][0][2]) == 8


def test_train_from_ncbi_without_accessions_raises_as_jax(services, monkeypatch, no_wait, tmp_path):
    monkeypatch.setenv("XSPECT_NCBI_URL", services.url)
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path))
    errors = []
    for trainer, extra in ((jax_train, {}), (train, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            trainer.train_from_ncbi("Testus", min_n50=10**9, **extra)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "No species with accessions" in errors[0]
    with pytest.raises(TypeError, match="genus must be a string"):
        train.train_from_ncbi(3, device="cpu")


def test_train_mlst_trees_equal_the_jax_package(services, tmp_path, monkeypatch):
    monkeypatch.setenv("XSPECT_PUBMLST_URL", f"{services.url}/db")
    from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel

    _run_both(tmp_path, monkeypatch, lambda: jax_train.train_mlst(MLST_ORGANISM, MLST_SCHEME, author="a"),
              lambda: train.train_mlst(MLST_ORGANISM, MLST_SCHEME, author="a", device="cpu"))
    assert MLST_SCHEME in mm.get_available_mlst_schemes().get(MLST_ORGANISM, [])
    model = ProbabilisticFilterMlstSchemeModel.load(mm.get_mlst_model_path(MLST_ORGANISM, MLST_SCHEME), device="cpu")
    assert sorted(model.loci) == sorted(MLST_LOCI)
    # a genome embedding allele 1 of every locus types as ST 1 via the mock designation POST
    rng = np.random.default_rng(0)
    filler = "".join("ACGT"[b] for b in rng.integers(0, 4, size=400))
    genome = filler.join(allele_seq(locus, 1) for locus in MLST_LOCI)
    strain = model.predict(SeqRecord(genome, id="g1")).get_results()["g1"][0]["Strain type"]
    for locus in MLST_LOCI:
        assert next(iter(strain[locus])) == "Allele_ID_1", (locus, strain[locus])
    assert strain["ST_Name"] == MLST_ST_FIELDS


# ---------------------------------------------------------------- NCBIHandler


def test_enums_and_quality_order_match_jax():
    assert [(m.name, m.value) for m in AssemblyLevel] == [(m.name, m.value) for m in jax_ncbi.AssemblyLevel]
    assert [(m.name, m.value) for m in AssemblySource] == [(m.name, m.value) for m in jax_ncbi.AssemblySource]
    assert [m.value for m in QUALITY_ORDER] == [m.value for m in jax_ncbi.QUALITY_ORDER]


@pytest.mark.parametrize("report, min_n50, inconclusive", [
    ({"assembly_stats": {"contig_n50": 5}}, 10, True),
    ({"assembly_stats": {"contig_n50": 50}}, 10, True),
    ({"assembly_stats": {"contig_n50": 50}}, 10, False),
    ({"assembly_stats": {"contig_n50": 50}, "average_nucleotide_identity": {"taxonomy_check_status": "OK"}}, 10, False),
    ({"assembly_stats": {"contig_n50": 50}, "average_nucleotide_identity": {"taxonomy_check_status": "Failed"}}, 10, False),
    ({"assembly_stats": None}, 10, True),
])
def test_report_predicate_matches_jax(report, min_n50, inconclusive):
    assert _report_passes(report, min_n50, inconclusive) == jax_ncbi._report_passes(report, min_n50, inconclusive)


def test_base_url_and_rate_from_the_environment(monkeypatch):
    monkeypatch.setenv("XSPECT_NCBI_URL", "http://127.0.0.1:9/v2/")
    handler = NCBIHandler()
    assert handler.http.base_url == "http://127.0.0.1:9/v2" and handler.http.min_interval == 1 / 5
    keyed = NCBIHandler(api_key="k", base_url="http://h")
    assert keyed.http.min_interval == 1 / 10 and keyed.http.headers == {"api-key": "k"}


def test_genus_taxon_id(ncbi):
    assert ncbi.get_genus_taxon_id("Testus") == GENUS_TAX_ID


@pytest.mark.parametrize("genus, message", [
    ("Notagenus", "not a genus"), ("Eukaryus", "bacteria"), ("Nosuchthing", "Invalid genus name"),
])
def test_genus_taxon_id_rejects(ncbi, genus, message):
    with pytest.raises(ValueError, match=message):
        ncbi.get_genus_taxon_id(genus)


def test_species_subtree(ncbi):
    assert ncbi.get_species(GENUS_TAX_ID) == SPECIES_TAX_IDS


def test_taxon_names(ncbi):
    assert ncbi.get_taxon_names([101, 103]) == {101: "Testus primus", 103: "Candidatus Testus tertius"}
    with pytest.raises(ValueError, match="missing"):
        ncbi.get_taxon_names([101, 77777])
    with pytest.raises(ValueError, match="between 1 and 1000"):
        ncbi.get_taxon_names([])


def test_accessions_filters_n50_and_ani(ncbi):
    args = (101, AssemblyLevel.COMPLETE_GENOME, AssemblySource.REFSEQ)
    accs = ncbi.get_accessions(*args, count=10, min_n50=10000, exclude_atypical=True, allow_inconclusive=False)
    assert "GCF_101.low" not in accs and "GCF_101.ani" not in accs and "GCF_101.2" in accs
    accs2 = ncbi.get_accessions(*args, count=10, min_n50=10000, exclude_atypical=True, allow_inconclusive=True)
    assert "GCF_101.ani" in accs2


def test_quality_walk_collects_best_first(ncbi):
    accs = ncbi.get_highest_quality_accessions(101, AssemblySource.REFSEQ, 8, 10000, True, False)
    assert accs[0] == "GCF_101.1" and len(accs) == 8 and len(set(accs)) == 8


def test_quality_walk_descends_to_contig(ncbi):
    accs = ncbi.get_highest_quality_accessions(102, AssemblySource.REFSEQ, 8, 10000, True, False)
    assert accs == [f"GCF_102.{i}" for i in range(1, 9)]


def test_download_assemblies_zip_layout(ncbi, tmp_path):
    ncbi.download_assemblies(["GCF_101.1", "GCF_101.2"], tmp_path)
    with zipfile.ZipFile(tmp_path / "ncbi_dataset.zip") as zf:
        names = zf.namelist()
    assert "ncbi_dataset/data/dataset_catalog.json" in names
    assert any(n.endswith("GCF_101.1_genomic.fna") for n in names)


def test_download_reference_genome(ncbi, tmp_path):
    fna = ncbi.download_reference_genome(101, tmp_path)
    assert fna == tmp_path / "101.fna"
    assert genome_for("GCF_101.1") in fna.read_text()
    assert not (tmp_path / "ncbi_dataset.zip").exists()


def test_download_reference_genome_missing(ncbi, tmp_path):
    assert ncbi.download_reference_genome(103, tmp_path) is None


def test_retry_absorbs_transient_500():
    with MockServices(flaky=True) as svc:
        handler = NCBIHandler(base_url=svc.url)
        handler.http.min_interval = 0
        handler.http.backoff = 0.01
        assert handler.get_genus_taxon_id("Testus") == GENUS_TAX_ID
        assert handler.get_species(GENUS_TAX_ID) == SPECIES_TAX_IDS
