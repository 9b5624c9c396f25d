"""The port's MLST ``predict`` and ``classify_mlst`` equal the JAX package's.

Kept apart from ``tests/test_torch_mlst.py`` so that the slowest MLST
tests run on a test worker of their own: the same synthetic three-locus
scheme (4, 40 and 6 alleles) is trained by both packages, and the same
numpy-seeded genomes go through ``predict`` of both, as a record stream
at several batch sizes, one record, and a FASTA path, and through
``classify_mlst``; the port's batching of loci and its on-device
reduction are checked on the same scheme.  The port runs on ``device="cpu"`` through its kernels'
plain versions.  The ST-name lookup (a network call) is replaced in
both.  Every comparison is exact.
"""

import json

import numpy as np
import pytest

from tests.conftest import random_dna
from xspect2_tpu import classify as jax_classify
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta
from xspect2_tpu.models import mlst_model as jax_mlst
from xspect2_tpu_torch import classify, model_cache
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.io.fasta import SeqRecord
from xspect2_tpu_torch.models import mlst_model as port_mlst
from xspect2_tpu_torch.models.result import MlstResult
from xspect2_tpu_torch.ops import query

K = 31
LOCI = {"Oxf_cpn60": (4, 450), "Oxf_gltA": (40, 450), "Oxf_rpoB": (6, 300)}
MODEL_ARGS = ("Oxford", "https://example.org/schemes/1", "abaumannii")


@pytest.fixture(scope="module")
def scheme(tmp_path_factory):
    """The scheme as ``Allele_ID_<n>.fasta`` files, its alleles, and a
    model of each package trained on it."""
    root = tmp_path_factory.mktemp("mlst")
    rng = np.random.default_rng(12345)
    alleles = {}
    for locus, (count, length) in LOCI.items():
        (root / "scheme" / locus).mkdir(parents=True)
        base = random_dna(rng, length)
        for n in range(1, count + 1):
            variant = list(base)
            for _ in range(n * 3):
                variant[int(rng.integers(0, length))] = "ACGT"[int(rng.integers(0, 4))]
            alleles[(locus, n)] = "".join(variant)
            write_fasta(
                [JaxSeqRecord(alleles[(locus, n)], id=f"{locus}_{n}")],
                root / "scheme" / locus / f"Allele_ID_{n}.fasta",
            )
    (root / "jax").mkdir()
    (root / "port").mkdir()
    name, url, organism = MODEL_ARGS
    jax_model = jax_mlst.ProbabilisticFilterMlstSchemeModel(K, name, root / "jax", url, organism)
    jax_model.fit(root / "scheme")
    jax_model.save()
    model = port_mlst.ProbabilisticFilterMlstSchemeModel(K, name, root / "port", url, organism, device="cpu")
    model.fit(root / "scheme")
    model.save()
    return root, alleles, jax_model, model


@pytest.fixture()
def no_lookup(monkeypatch):
    """The ST-name lookup is a network call: both packages answer alike."""
    for module in (jax_mlst, port_mlst):
        monkeypatch.setattr(
            module.ProbabilisticFilterMlstSchemeModel, "_resolve_strain_type",
            lambda self, highest: "ST-" + "-".join(
                next(iter(v)).split("_")[-1] for v in highest.values() if isinstance(v, dict)),
        )


def _genome(rng, alleles, length):
    """A random genome with one allele of every locus embedded; returns
    the sequence and the alleles picked."""
    seq = random_dna(rng, length)
    pos, picks = 2_000, {}
    for locus, (count, _) in LOCI.items():
        picks[locus] = int(rng.integers(1, count + 1))
        allele = alleles[(locus, picks[locus])]
        seq = seq[:pos] + allele + seq[pos + len(allele) :]
        pos += 8_000
    return seq, picks


def _inputs(alleles):
    rng = np.random.default_rng(99)
    long = [_genome(rng, alleles, 25_000) for _ in range(3)]
    seqs = {f"long{i}": s for i, (s, _) in enumerate(long)}
    seqs["short0"] = alleles[("Oxf_gltA", 7)] + random_dna(rng, 300)
    seqs["short1"] = random_dna(rng, 900)
    seqs["long3"] = _genome(rng, alleles, 12_000)[0] + "N" * 40 + random_dna(rng, 500)
    return seqs, {f"long{i}": p for i, (_, p) in enumerate(long)}


@pytest.mark.parametrize("batch_genomes", [1, 3, None])
def test_predict_iterator_matches_jax_and_per_genome(scheme, no_lookup, batch_genomes, monkeypatch):
    """A mixed stream (long, short, long): groups flush when the split
    status changes; every batch size gives the per-genome results."""
    _, alleles, jax_model, model = scheme
    monkeypatch.delenv("XSPECT_MLST_BATCH_GENOMES", raising=False)
    seqs, _ = _inputs(alleles)
    got = model.predict((SeqRecord(s, id=i) for i, s in seqs.items()), batch_genomes=batch_genomes)
    want = jax_model.predict((JaxSeqRecord(s, id=i) for i, s in seqs.items()), batch_genomes=batch_genomes)
    assert isinstance(got, MlstResult)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert got.hits == {i: model.calculate_hits(s) for i, s in seqs.items()}


def test_predict_record_path_and_limit_match_jax(scheme, no_lookup, tmp_path):
    _, alleles, jax_model, model = scheme
    seqs, _ = _inputs(alleles)
    got = model.predict(SeqRecord(seqs["long0"]), limit=True)
    want = jax_model.predict(JaxSeqRecord(seqs["long0"]), limit=True)
    assert list(got.hits) == ["test"]  # "<unknown id>" becomes "test"
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    fasta = tmp_path / "mixed.fasta"
    write_fasta([JaxSeqRecord(s, id=i) for i, s in seqs.items()], fasta)
    for limit in (False, True):
        got = model.predict(fasta, limit=limit, batch_genomes=2)
        want = jax_model.predict(fasta, limit=limit, batch_genomes=2)
        assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    with pytest.raises(ValueError, match="SeqRecord, a record iterator"):
        model.predict(17)


def test_classify_mlst_writes_the_jax_json(scheme, no_lookup, tmp_path, monkeypatch):
    root, alleles, _, _ = scheme
    seqs, _ = _inputs(alleles)
    fasta = tmp_path / "genomes.fasta"
    write_fasta([JaxSeqRecord(s, id=i) for i, s in seqs.items()], fasta)
    monkeypatch.setattr("xspect2_tpu.model_management.get_mlst_model_path",
                        lambda organism, scheme: root / "jax" / "abaumannii-oxford-mlst.json")
    monkeypatch.setattr("xspect2_tpu_torch.model_management.get_mlst_model_path",
                        lambda organism, scheme: root / "port" / "abaumannii-oxford-mlst.json")
    jax_model_cache.clear()
    model_cache.clear()
    try:
        for limit in (False, True):
            jax_classify.classify_mlst(fasta, "abaumannii", "Oxford", tmp_path / "jax.json", limit)
            classify.classify_mlst(fasta, "abaumannii", "Oxford", tmp_path / "port.json", limit, device="cpu")
            assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
        assert json.loads((tmp_path / "port.json").read_text())["Input_source"] == "genomes.fasta"
    finally:
        jax_model_cache.clear()
        model_cache.clear()


def test_loci_share_one_prepared_batch(scheme, monkeypatch):
    """Loci of one allele length share ONE prepared batch, one packed
    wire and ONE multi-index query: two queries for the three loci of
    the scheme, not three, and the fetch is [C] or [B, C] per locus."""
    _, alleles, _, model = scheme
    calls = []
    real = query.multi_records_query

    def spy(tables, geoms, *args, **kwargs):
        calls.append(len(tables))
        return real(tables, geoms, *args, **kwargs)

    monkeypatch.setattr(query, "multi_records_query", spy)
    rng = np.random.default_rng(3)
    genome = random_dna(rng, 30_000)
    dispatched = model._dispatch_loci(genome, step=1)
    assert sorted(calls) == [1, 2]  # the 450 bp loci together, the 300 bp locus alone
    assert [tuple(o.shape) for o, _ in dispatched] == [(4,), (40,), (6,)]
    calls.clear()
    grouped = model._dispatch_loci_group([genome, random_dna(rng, 12_000)], step=1)
    assert sorted(calls) == [1, 2]
    assert [tuple(o.shape) for o, _ in grouped] == [(2, 4), (2, 40), (2, 6)]

    # one batch queried through two engines uploads its wire once
    pieces = model.sequence_splitter(genome, 450)
    records = [(f"p{i}", dna.encode(p)) for i, p in enumerate(pieces)]
    batch = query.prepare_batch(records, K, chunk=model.engines[0].chunk)
    assert batch._device_wire == {}
    model.engines[0].count_hits(batch, block=False)
    assert len(batch._device_wire) == 1
    wire_before = next(iter(batch._device_wire.values()))
    out1 = model.engines[1].count_hits(batch, block=False)
    assert next(iter(batch._device_wire.values())) is wire_before
    fresh = query.prepare_batch(records, K, chunk=model.engines[1].chunk)
    np.testing.assert_array_equal(
        out1.numpy()[: batch.num_records].astype(np.int64), model.engines[1].count_hits(fresh))


def test_device_reduction_matches_host_reduction(scheme):
    """The on-device reduction is the host rule it replaces: per-piece
    counts <= 50 zeroed, then summed (split path); raw counts of the one
    piece (short path)."""
    _, alleles, _, model = scheme
    rng = np.random.default_rng(8)
    genome = _genome(rng, alleles, 30_000)[0]
    reduced = model._fetch_counts(model._dispatch_loci(genome, step=1))
    for li, totals in enumerate(reduced):
        assert totals.ndim == 1 and totals.dtype == np.int64
        pieces = model.sequence_splitter(genome, model.avg_locus_bp_size[li])
        raw = model.engines[li].count_hits_records(
            [(f"p{i}", dna.encode(p)) for i, p in enumerate(pieces)])
        want = np.where(raw > port_mlst.CHUNK_SCORE_THRESHOLD, raw, 0).sum(axis=0)
        np.testing.assert_array_equal(totals, want)
        assert totals.max() > 200
    short = random_dna(rng, 900)
    for li, row in enumerate(model._fetch_counts(model._dispatch_loci(short, step=1))):
        assert row.ndim == 1
        np.testing.assert_array_equal(row, model.engines[li].count_hits_records([("p0", dna.encode(short))])[0])
