"""The port's misclassification detection and ``predict(..., validation=True)``
against the JAX package.

Mirrors ``tests/test_misclassification.py`` and
``tests/test_mapping_robustness.py`` on the port's own copies (Ripley's
K, the seed-and-vote mapper, read simulation, the orchestrator), each
held equal to the JAX package's on the same inputs.  Then the filter,
SVM, blocked genus and xxh3 genus models of both packages classify one
read file with ``validation=True``, each package under its own
``XSPECT_DATA_ROOT`` with the same seeded reference genomes: the result
JSON and every file under ``misclassification/`` must be byte-identical.
"""

import json
import shutil

import numpy as np
import pytest

import xspect2_tpu.misclassification_detection as jax_mc
import xspect2_tpu.misclassification_detection.mapping as jax_mapping
import xspect2_tpu.misclassification_detection.point_pattern_analysis as jax_ppa
import xspect2_tpu.misclassification_detection.simulate_reads as jax_sim
import xspect2_tpu_torch.misclassification_detection as mc
from tests.conftest import random_dna
from tests.mock_services import MockServices, genome_for
from tests.test_mapping_robustness import _extract_reads, _genome, _mutate
from tests.test_torch_train import _assert_same_tree
from xspect2_tpu import train as jax_train
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta as jax_write_fasta
from xspect2_tpu.models.filter_model import ProbabilisticFilterModel as JaxFilterModel
from xspect2_tpu.models.single_filter_model import ProbabilisticSingleFilterModel as JaxGenusModel
from xspect2_tpu.models.svm_model import ProbabilisticFilterSVMModel as JaxSVMModel
from xspect2_tpu_torch import train
from xspect2_tpu_torch.io.fasta import SeqRecord, reverse_complement, write_fasta
from xspect2_tpu_torch.misclassification_detection import detect_misclassification
from xspect2_tpu_torch.misclassification_detection.mapping import (
    LONG_READ_PRESET,
    SHORT_READ_PRESET,
    MappingHandler,
    _best_start_cluster,
    preset_for_read_length,
)
from xspect2_tpu_torch.misclassification_detection.point_pattern_analysis import PointPatternAnalysis
from xspect2_tpu_torch.misclassification_detection.simulate_reads import (
    extract_random_reads,
    mutate_read_codes,
    mutate_sequence,
)
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

# ---------------------------------------------------------------- Ripley's K


@pytest.mark.parametrize("pattern", ["uniform", "clustered", "edge", "pair"])
def test_ripleys_k_matches_jax(pattern):
    rng = np.random.default_rng(3)
    length = 1_000_000
    points = {
        "uniform": lambda: rng.integers(0, length, size=500),
        "clustered": lambda: 500_000 + rng.integers(0, 5_000, size=200),
        "edge": lambda: np.concatenate([rng.integers(0, 3_000, 50), length - 1 - rng.integers(0, 3_000, 50)]),
        "pair": lambda: np.array([10, 20]),
    }[pattern]().tolist()
    got = PointPatternAnalysis(points, length)
    want = jax_ppa.PointPatternAnalysis(points, length)
    assert got.ripleys_k() == want.ripleys_k()
    assert got.ripleys_k_edge_corrected() == want.ripleys_k_edge_corrected()
    clustered = got.ripleys_k_edge_corrected()[0]
    assert clustered == (pattern != "uniform")


def test_ripleys_needs_two_points():
    with pytest.raises(ValueError, match="2 points"):
        PointPatternAnalysis([5], 100)


# ---------------------------------------------------------------- mapper


def test_reverse_complement_matches_jax():
    seq = "ACGTUacgtuRYKMBVDHrykmbvdhNnSWsw-"
    assert reverse_complement(seq) == JaxSeqRecord(seq, id="x").reverse_complement().seq
    rec = SeqRecord("AACG", id="r", description="r d").reverse_complement()
    assert (rec.seq, rec.id, rec.description) == ("CGTT", "r", "r d")


def test_mapper_recovers_start_coordinates(tmp_path, rng):
    genome = random_dna(rng, 50_000)
    ref_path = tmp_path / "ref.fna"
    write_fasta([SeqRecord(genome[:20_000], id="chr1"), SeqRecord(genome[20_000:], id="chr2")], ref_path)
    true_starts = sorted(int(s) for s in rng.integers(0, 49_850, size=50))
    reads = []
    for i, s in enumerate(true_starts):
        seq = genome[s : s + 150]
        reads.append(SeqRecord(reverse_complement(seq) if i % 2 else seq, id=f"r{i}"))
    reads_path = tmp_path / "reads.fasta"
    write_fasta(reads, reads_path)

    tsvs = []
    for module in (mc.mapping, jax_mapping):
        handler = module.MappingHandler(str(ref_path), str(reads_path))
        handler.map_reads_onto_reference()
        handler.extract_starting_coordinates()
        tsvs.append((handler.tsv, open(handler.tsv, "rb").read(), handler.get_start_coordinates()))
        assert handler.get_total_genome_length() == 50_000
    assert tsvs[0] == tsvs[1]
    coords = tsvs[0][2]
    # reads across the contig boundary map nowhere; the rest map exactly
    inside = {s if s < 20_000 else s - 20_000 for s in true_starts if not s < 20_000 < s + 150}
    assert set(coords) == inside


def test_mapper_errors_and_unmapped_tsv(tmp_path):
    ref = tmp_path / "ref.fna"
    write_fasta([SeqRecord("ACGT" * 100, id="c")], ref)
    with pytest.raises(ValueError, match="reference genome"):
        MappingHandler(str(tmp_path / "missing.fna"), str(ref))
    with pytest.raises(ValueError, match="reads"):
        MappingHandler(str(ref), str(tmp_path / "missing.fasta"))
    handler = MappingHandler(str(ref), str(ref))
    handler.extract_starting_coordinates()  # before mapping: the dummy row
    assert handler.get_start_coordinates() == [1000]
    empty = tmp_path / "empty.fna"
    empty.write_text("", encoding="utf-8")
    with pytest.raises(ValueError, match="empty"):
        MappingHandler(str(empty), str(ref)).map_reads_onto_reference()


@pytest.mark.parametrize("tolerance", [0, 12, 120])
def test_best_start_cluster_matches_jax(tolerance):
    starts = np.random.default_rng(tolerance).integers(0, 2_000, size=300)
    assert _best_start_cluster(starts, tolerance) == jax_mapping._best_start_cluster(starts, tolerance)


# ---------------------------------------------------------------- simulation


def test_simulated_reads_match_jax(tmp_path, rng):
    genome = random_dna(rng, 10_000)
    path = tmp_path / "g.fasta"
    write_fasta([SeqRecord(genome[:6_000], id="g1"), SeqRecord(genome[6_000:], id="g2"),
                 SeqRecord(genome[:100], id="short")], path)
    reads = extract_random_reads(path, read_length=150, num_reads=20, seed=1)
    want = jax_sim.extract_random_reads(path, read_length=150, num_reads=20, seed=1)
    assert [(r.id, r.seq) for r in reads] == [(r.id, r.seq) for r in want]
    assert all(len(r.seq) == 150 and r.seq in genome for r in reads)
    with pytest.raises(ValueError, match="long enough"):
        extract_random_reads(path, read_length=20_000)
    codes = rng.integers(0, 4, size=(40, 150), dtype=np.uint8)
    codes[3, 7] = 255
    mutated = mutate_read_codes(codes, sub_rate=0.01, indel_rate=0.005, seed=5)
    np.testing.assert_array_equal(mutated, jax_sim.mutate_read_codes(codes, sub_rate=0.01, indel_rate=0.005, seed=5))
    assert mutated[3, 7] == 255 and (mutated != codes).any()
    assert mutate_sequence(genome[:300], 0.05, 0.01, seed=2) == jax_sim.mutate_sequence(genome[:300], 0.05, 0.01, seed=2)


# ---------------------------------------------------------------- mapping robustness


def _map_both(tmp_path, genome, reads):
    ref_path = tmp_path / "ref.fasta"
    reads_path = tmp_path / "reads.fasta"
    write_fasta([SeqRecord(genome, id="chr1")], ref_path)
    write_fasta(reads, reads_path)
    handlers = []
    for module in (mc.mapping, jax_mapping):
        handler = module.MappingHandler(str(ref_path), str(reads_path))
        handler.map_reads_onto_reference()
        handler.extract_starting_coordinates()
        handlers.append(handler)
    assert handlers[0]._alignments == handlers[1]._alignments
    return handlers[0]


def _recovery(handler, true_starts, reads, tolerance):
    mapped = {read_id: start for _ci, read_id, start in handler._alignments}
    ok = sum(1 for j, rec in enumerate(reads)
             if rec.id in mapped and abs(mapped[rec.id] - true_starts[j]) <= tolerance)
    return ok / len(reads)


def test_preset_split_matches_reference_lengths():
    assert preset_for_read_length(100) is SHORT_READ_PRESET
    assert preset_for_read_length(150) is SHORT_READ_PRESET
    assert preset_for_read_length(151) is LONG_READ_PRESET
    assert preset_for_read_length(10_000) is LONG_READ_PRESET
    assert (SHORT_READ_PRESET, LONG_READ_PRESET) == tuple(
        type(SHORT_READ_PRESET)(**vars(p)) for p in (jax_mapping.SHORT_READ_PRESET, jax_mapping.LONG_READ_PRESET))


@pytest.mark.parametrize("snp_rate", [0.02, 0.05])
def test_short_reads_with_snps_and_indels(tmp_path, rng, snp_rate):
    genome = _genome(rng)
    reads, starts = _extract_reads(rng, genome, n=120, length=150, snp_rate=snp_rate, indel_rate=0.005)
    handler = _map_both(tmp_path, genome, [SeqRecord(r.seq, id=r.id) for r in reads])
    rate = _recovery(handler, starts, reads, tolerance=30)
    assert rate >= 0.95, f"start recovery {rate:.2f} at snp_rate={snp_rate}"


def test_long_reads_with_heavy_errors(tmp_path, rng):
    """1-10 kb reads at ~5% SNPs + 1% indels (ONT-like error regime)."""
    genome = _genome(rng)
    reads, starts = [], []
    for j in range(40):
        length = int(rng.integers(1000, 10_000))
        r, s = _extract_reads(rng, genome, n=1, length=length, snp_rate=0.05, indel_rate=0.01)
        reads.append(SeqRecord(r[0].seq, id=f"r{j}"))
        starts.append(s[0])
    handler = _map_both(tmp_path, genome, reads)
    rate = _recovery(handler, starts, reads, tolerance=250)
    assert rate >= 0.95, f"long-read start recovery {rate:.2f}"


def test_ripleys_verdict_stable_under_mutation(tmp_path, rng):
    """Clustered mutated reads stay 'clustered'; stratified ones do not."""
    genome = _genome(rng)
    clustered_reads, _ = _extract_reads(rng, genome, n=60, length=150, snp_rate=0.03, indel_rate=0.005,
                                        clustered=(40_000, 44_000))
    handler = _map_both(tmp_path, genome, [SeqRecord(r.seq, id=r.id) for r in clustered_reads])
    ppa = PointPatternAnalysis(handler.get_start_coordinates(), handler.get_total_genome_length())
    assert ppa.ripleys_k_edge_corrected()[0] is True
    uniform_reads = []
    for j, base in enumerate(range(0, len(genome) - 2000, 2000)):
        start = base + int(rng.integers(0, 500))
        uniform_reads.append(SeqRecord(_mutate(rng, genome[start : start + 150], 0.03, 0.005), id=f"u{j}"))
    handler2 = _map_both(tmp_path, genome, uniform_reads)
    ppa2 = PointPatternAnalysis(handler2.get_start_coordinates(), handler2.get_total_genome_length())
    assert ppa2.ripleys_k_edge_corrected()[0] is False


# ---------------------------------------------------------------- orchestrator


def _suspect_case(rng, clustered):
    """30 majority reads of 470 and 15 suspect reads of 471 (clustered in a
    400 bp hotspot or spread), and the 471 genome."""
    genome_good, genome_sus = random_dna(rng, 60_000), random_dna(rng, 60_000)
    records, hits = [], {}
    for i in range(30):
        records.append(SeqRecord(genome_good[i * 1800 : i * 1800 + 150], id=f"good{i}"))
        hits[f"good{i}"] = {"470": 120, "471": 3}
    for i in range(15):
        s = 30_000 + i * 20 if clustered else i * 3900
        records.append(SeqRecord(genome_sus[s : s + 150], id=f"sus{i}"))
        hits[f"sus{i}"] = {"470": 2, "471": 110}
    return genome_sus, records, hits


@pytest.mark.parametrize("clustered", [True, False])
def test_detect_misclassification_matches_jax(tmp_path, monkeypatch, clustered):
    genome_sus, records, hits = _suspect_case(np.random.default_rng(12345), clustered)
    outs = []
    for name, detect, rec_cls, writer in (("jax", jax_mc.detect_misclassification, JaxSeqRecord, jax_write_fasta),
                                          ("port", detect_misclassification, SeqRecord, write_fasta)):
        root = tmp_path / name
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(root))
        (root / "misclassification" / "471").mkdir(parents=True)
        writer([rec_cls(genome_sus, id="chr")], root / "misclassification" / "471" / "471.fna")
        copy = {k: dict(v) for k, v in hits.items()}
        outs.append(detect(copy, [rec_cls(r.seq, id=r.id) for r in records], min_reads=10))
    assert outs[0] == outs[1]
    _assert_same_tree(tmp_path / "port" / "misclassification", tmp_path / "jax" / "misclassification")
    out = outs[1]
    assert all(f"good{i}" in out for i in range(30))
    if clustered:
        assert set(out["misclassified"]) == {471} and len(out["misclassified"][471]) == 15
        assert not any(f"sus{i}" in out for i in range(15))
    else:
        assert "misclassified" not in out and all(f"sus{i}" in out for i in range(15))


def test_detect_downloads_a_missing_reference_from_ncbi(tmp_path, monkeypatch):
    """A group whose reference is not seeded is downloaded (mock NCBI: 101
    has one) or skipped (103 has none), as in the JAX package."""
    rng = np.random.default_rng(8)
    ref = genome_for("GCF_101.1")
    records, hits = [], {}
    for i in range(40):
        records.append(SeqRecord(random_dna(rng, 150), id=f"m{i}"))
        hits[f"m{i}"] = {"102": 90, "101": 1, "103": 0}
    for i in range(12):
        records.append(SeqRecord(ref[1000 + 7 * i : 1150 + 7 * i], id=f"c{i}"))
        hits[f"c{i}"] = {"101": 100, "102": 1, "103": 0}
        records.append(SeqRecord(random_dna(rng, 150), id=f"t{i}"))
        hits[f"t{i}"] = {"103": 80, "101": 2, "102": 0}
    with MockServices() as svc:
        monkeypatch.setenv("XSPECT_NCBI_URL", svc.url)
        for module in ("xspect2_tpu", "xspect2_tpu_torch"):
            monkeypatch.setattr(f"{module}.handlers.http.HttpClient._wait_turn", lambda self: None)
        outs = []
        for name, detect, rec_cls in (("jax", jax_mc.detect_misclassification, JaxSeqRecord),
                                      ("port", detect_misclassification, SeqRecord)):
            monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / name))
            copy = {k: dict(v) for k, v in hits.items()}
            outs.append(detect(copy, [rec_cls(r.seq, id=r.id) for r in records]))
    assert outs[0] == outs[1]
    assert set(outs[1]["misclassified"]) == {101} and all(f"t{i}" in outs[1] for i in range(12))
    _assert_same_tree(tmp_path / "port" / "misclassification", tmp_path / "jax" / "misclassification")
    assert (tmp_path / "port" / "misclassification" / "101" / "101.fna").exists()
    assert not (tmp_path / "port" / "misclassification" / "103" / "103.fna").exists()


# ---------------------------------------------------------------- predict(validation=True)

LABELS = ("470", "471", "472")
GENOME = 60_000


def _write_fastq(path, reads):
    path.write_text("".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads), encoding="utf-8")


@pytest.fixture(scope="module")
def validation_models(tmp_path_factory):
    """Both packages' SVM species, plain species, blocked genus and xxh3
    genus models trained on three 60 kbp species, each under its own data
    root with the species' genomes seeded as references; and a FASTQ of
    560 150 bp reads: 500 spread over 470, 30 of 471 in one 600 bp
    hotspot, 30 of 472 spread."""
    base = tmp_path_factory.mktemp("validation")
    rng = np.random.default_rng(2024)
    genomes = {label: random_dna(rng, GENOME) for label in LABELS}
    for tree_name, svm in (("svm-tree", True), ("plain-tree", False)):
        for label, g in genomes.items():
            (base / tree_name / "cobs" / label).mkdir(parents=True)
            write_fasta([SeqRecord(g, id=label)], base / tree_name / "cobs" / label / "g.fasta")
            if svm:
                (base / tree_name / "svm" / label).mkdir(parents=True)
                for j in range(2):
                    s = int(rng.integers(0, GENOME - 20_000))
                    write_fasta([SeqRecord(g[s : s + 20_000], id=f"{label}s{j}")],
                                base / tree_name / "svm" / label / f"A{j}.fasta")
    metagenome = base / "Compat.fasta"
    write_fasta([SeqRecord(g, id=label) for label, g in genomes.items()], metagenome)
    reads = []
    for i in range(500):
        s = int(rng.integers(0, GENOME - 150))
        reads.append((f"a{i}", genomes["470"][s : s + 150]))
    for i in range(30):
        s = 20_000 + int(rng.integers(0, 450))
        reads.append((f"b{i}", genomes["471"][s : s + 150]))
    for i in range(30):
        s = i * 1_990 + int(rng.integers(0, 100))
        reads.append((f"c{i}", genomes["472"][s : s + 150]))
    order = rng.permutation(len(reads))
    fastq = base / "reads.fastq"
    _write_fastq(fastq, [reads[i] for i in order])

    roots = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, trainer, genus_cls, rec_cls, writer, extra in (
            ("jax", jax_train, JaxGenusModel, JaxSeqRecord, jax_write_fasta, {}),
            ("port", train, ProbabilisticSingleFilterModel, SeqRecord, write_fasta, {"device": "cpu"}),
        ):
            root = roots[name] = base / f"{name}-data"
            mp.setenv("XSPECT_DATA_ROOT", str(root))
            trainer.train_from_directory("Valid", base / "svm-tree", meta=True, **extra)
            trainer.train_from_directory("Plain", base / "plain-tree", **extra)
            compat = genus_cls(21, "Compat", None, None, "Genus", root / "models", hash_family="xxh3", **extra)
            compat.fit(metagenome, "Compat")
            compat.save()
            for label, g in genomes.items():
                (root / "misclassification" / label).mkdir(parents=True)
                writer([rec_cls(g, id=f"chr{label}")], root / "misclassification" / label / f"{label}.fna")
    return roots, fastq


@pytest.mark.parametrize("kind", ["svm", "filter", "genus", "xxh3-genus"])
def test_validation_result_json_matches_jax(validation_models, tmp_path, monkeypatch, kind):
    roots, fastq = validation_models
    slug, jax_cls, cls = {
        "svm": ("valid-species", JaxSVMModel, ProbabilisticFilterSVMModel),
        "filter": ("plain-species", JaxFilterModel, ProbabilisticFilterModel),
        "genus": ("valid-genus", JaxGenusModel, ProbabilisticSingleFilterModel),
        "xxh3-genus": ("compat-genus", JaxGenusModel, ProbabilisticSingleFilterModel),
    }[kind]
    data = {}
    for name, model_cls, extra in (("jax", jax_cls, {}), ("port", cls, {"device": "cpu"})):
        root = tmp_path / name
        # each test validates on a fresh copy of the trained root
        shutil.copytree(roots[name], root)
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(root))
        model = model_cls.load(root / "models" / f"{slug}.json", **extra)
        if name == "port" and kind in ("svm", "filter"):
            # validation never takes the reads route, which 560 reads of one length would
            monkeypatch.setattr(model, "_predict_reads_file", lambda *a: pytest.fail("reads route"))
        res = model.predict(fastq, validation=True)
        res.input_source = fastq.name
        data[name] = json.dumps(res.to_dict(), indent=4)
        plain = model.predict(fastq, step=2, validation=True)
        data[name] += json.dumps(plain.to_dict())
    assert data["port"] == data["jax"]
    _assert_same_tree(tmp_path / "port" / "misclassification", tmp_path / "jax" / "misclassification")
    result = json.loads(data["port"].split("\n}")[0] + "\n}")
    if kind in ("svm", "filter"):
        # the hotspot group of 471 moves, the spread group of 472 stays
        assert sorted(result["misclassified"]) == ["471"] and len(result["misclassified"]["471"]) == 30
        assert all(f"c{i}" in result["hits"] for i in range(30))
        assert not any(f"b{i}" in result["hits"] for i in range(30))
        assert (tmp_path / "port" / "misclassification" / "472" / "472_mapped.start_coordinates.tsv").exists()
        if kind == "svm":
            assert result["prediction"] == "470"
    else:
        assert result["misclassified"] is None and len(result["hits"]) == 560


def test_validation_keeps_the_hits_of_the_reads_route(validation_models, tmp_path, monkeypatch):
    """Every record kept by validation has the counts of the reads route."""
    roots, fastq = validation_models
    shutil.copytree(roots["port"], tmp_path / "port")
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "port"))
    model = ProbabilisticFilterModel.load(tmp_path / "port" / "models" / "plain-species.json", device="cpu")
    fast = model._predict_reads_file(fastq, None, 1, False)
    assert fast is not None
    validated = model.predict(fastq, validation=True)
    assert set(validated.hits) | set(validated.misclassified[471]) == set(fast.hits)
    for rid, hits in validated.hits.items():
        assert hits == fast.hits[rid]
    for rid, hits in validated.misclassified[471].items():
        assert hits == fast.hits[rid]


def test_validation_with_display_names_raises_as_in_jax(validation_models, tmp_path, monkeypatch):
    """The JAX package's grouping reads the class id as an integer, so
    display-name keys raise ``ValueError``; the port keeps that."""
    roots, fastq = validation_models
    errors = []
    for name, model_cls, extra in (("jax", JaxFilterModel, {}), ("port", ProbabilisticFilterModel, {"device": "cpu"})):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / name))
        model = model_cls.load(roots[name] / "models" / "plain-species.json", **extra)
        with pytest.raises(ValueError) as exc:
            model.predict(fastq, display_name=True, validation=True)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "invalid literal for int()" in errors[0]
