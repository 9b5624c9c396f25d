"""The xxh3 genus filter's records route equals the JAX package's per-record count.

The plain PyTorch XXH3 (int64 tensors holding uint64 bits) and probe
positions are held bit for bit against ``xspect2_tpu.core.xxh3`` /
``core.compat`` at every k from 4 to 32; the per-record counts of
``ops.bloom.xxh3_records_count`` (on the CPU, its plain version) against
the JAX filter's ``count_hits_device`` record by record; and the genus
model's ``predict`` and ``classify_genus``, which now take this route in
batches, against the JAX package's result JSON, byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from tests.conftest import random_dna
from xspect2_tpu import classify as jax_classify
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.core import compat as jax_compat
from xspect2_tpu.core import xxh3 as jax_xxh3
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta as jax_write_fasta
from xspect2_tpu.models.single_filter_model import ProbabilisticSingleFilterModel as JaxGenusModel
from xspect2_tpu_torch import classify, model_cache
from xspect2_tpu_torch.core import compat, dna, xxh3
from xspect2_tpu_torch.io.fasta import SeqRecord
from xspect2_tpu_torch.models import filter_model
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.ops import bloom, query

M64 = (1 << 64) - 1


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32/uint64 numpy -> int64 tensor of the same bits."""
    return torch.from_numpy(np.asarray(a).astype(np.uint64).view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.fixture()
def fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


# ---------------------------------------------------------------- the hash


@pytest.mark.parametrize("k", range(4, 33))
def test_plain_digests_equal_the_jax_xxh3_at_every_k(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=600, dtype=np.uint8)
    hi, lo, _ = dna.canonical_kmers(codes, k)
    # and the extreme k-mers: all A, all T (k-mers, not canonical)
    hi = np.concatenate([hi, [0, (1 << max(0, 2 * (k - 16))) - 1]]).astype(np.uint32)
    lo = np.concatenate([lo, [0, (1 << (2 * min(k, 16))) - 1]]).astype(np.uint32)
    got = _u64(bloom.xxh3_digests_plain(_t(hi), _t(lo), k))
    ascii = compat.ascii_from_packed(hi, lo, k)
    np.testing.assert_array_equal(got, jax_xxh3.xxh3_64_batch(ascii))
    np.testing.assert_array_equal(got, xxh3.xxh3_64_batch(ascii))
    np.testing.assert_array_equal(got, jax_compat.kmer_digests(hi, lo, k))
    assert int(got[-1]) == jax_xxh3.xxh3_64(b"T" * k) and int(got[-2]) == jax_xxh3.xxh3_64(b"A" * k)


def test_plain_digests_refuse_k_outside_4_to_32():
    z = torch.zeros(1, dtype=torch.int64)
    for k in (3, 33):
        with pytest.raises(ValueError, match="4 <= k <= 32"):
            bloom.xxh3_digests_plain(z, z, k)


@pytest.mark.parametrize("num_bits,num_hashes", [
    (64, 1), (1000, 3), (306_721_869, 7), (2**31 + 11, 5), (2**32 - 5, 7), (2**32 - 1, 9),
])
def test_plain_probe_positions_equal_derive_probe_positions(num_bits, num_hashes):
    rng = np.random.default_rng(num_bits % 1000)
    d = rng.integers(0, 2**64, size=3000, dtype=np.uint64)
    # digests whose d + i*h2 wraps 2^64 early, and the extremes
    top = np.uint64(M64) - rng.integers(0, 2**20, size=200, dtype=np.uint64)
    d = np.concatenate([d, top, np.array([0, 1, M64, 2**63, 2**63 - 1, num_bits, num_bits - 1], dtype=np.uint64)])
    h2 = ((d >> np.uint64(33)) ^ (d << np.uint64(29))) | np.uint64(1)
    with np.errstate(over="ignore"):
        wrapped = d + np.uint64(num_hashes - 1) * h2
    assert num_hashes == 1 or (wrapped < d).any()  # some probes wrap before the modulo
    got = bloom.probe_positions_plain(_t(d), num_bits, num_hashes).numpy()
    want = jax_compat.derive_probe_positions(d, num_bits, num_hashes)
    np.testing.assert_array_equal(got.astype(np.uint64), want)
    np.testing.assert_array_equal(want, compat.derive_probe_positions(d, num_bits, num_hashes))
    assert got.min() >= 0 and got.max() < num_bits


# ---------------------------------------------------------------- per-record counts


def _records(rng, genome, k, n):
    """Records drawn from the genome (some reverse-complemented), random
    ones, records with N runs and one barely longer than k."""
    out = []
    for i in range(n):
        length = int(rng.integers(k + 1, 700)) if i else k + 1
        if i % 4 == 3:
            codes = rng.integers(0, 4, size=length, dtype=np.uint8)
        else:
            at = int(rng.integers(0, len(genome) - length))
            codes = genome[at : at + length].copy()
            if i % 2:
                codes = (3 - codes[::-1]).astype(np.uint8)
        if i % 3 == 1 and length > 40:
            at = int(rng.integers(0, length - 12))
            codes[at : at + int(rng.integers(1, 12))] = 255  # an N run
        out.append((f"r{i}", codes))
    return out


@pytest.mark.parametrize("k", [5, 12, 21, 31])
@pytest.mark.parametrize("step", [1, 3, 4])
def test_records_route_counts_equal_the_jax_count_per_record(k, step):
    rng = np.random.default_rng(100 * k + step)
    genome = rng.integers(0, 4, size=4000, dtype=np.uint8)
    jfilt = jax_compat.XXH3BloomFilter.for_items(len(genome), 0.05, k)
    filt = compat.XXH3BloomFilter.for_items(len(genome), 0.05, k, device="cpu")
    for f in (jfilt, filt):
        f.insert_packed(*dna.canonical_kmers(genome, k))
    records = _records(rng, genome, k, 40)
    batch = query.prepare_batch(records, k, step=step, chunk=4096)
    got = filt.count_hits_batch(batch)
    want = []
    for _, codes in records:
        hi, lo, valid = dna.canonical_kmers(codes, k, step=step)
        want.append(jfilt.count_hits_device(hi, lo, valid))
        assert want[-1] == filt.count_hits_host(hi, lo, valid)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and 0 < got.sum() < sum(len(c) for _, c in records)

    # the wrapper itself, on the raw batch tensors (the CPU takes the plain version)
    before = bloom.xxh3_records_count.launches
    max_records = query._next_pow2(max(8, batch.num_records))
    raw = [torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid)]
    words = torch.from_numpy(filt.words.view(np.int32))
    out = bloom.xxh3_records_count(words, *raw, max_records=max_records, k=k,
                                   num_bits=filt.num_bits, num_hashes=filt.num_hashes)
    assert out.dtype == torch.int32 and tuple(out.shape) == (max_records,)
    np.testing.assert_array_equal(out[: len(records)].numpy(), want)
    assert int(out[len(records):].sum()) == 0 and bloom.xxh3_records_count.launches == before


def test_records_count_drops_record_ids_outside_the_range_and_checks_its_inputs():
    k = 21
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, size=2000, dtype=np.uint8)
    filt = compat.XXH3BloomFilter.for_items(len(genome), 0.01, k, device="cpu")
    filt.insert_packed(*dna.canonical_kmers(genome, k))
    batch = query.prepare_batch([("a", genome[:300]), ("b", genome[500:900])], k, chunk=1024)
    codes, rec_ids, valid = (torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid))
    words = torch.from_numpy(filt.words.view(np.int32))
    geom = dict(k=k, num_bits=filt.num_bits, num_hashes=filt.num_hashes)
    out = bloom.xxh3_records_count(words, codes, rec_ids, valid, max_records=8, **geom)
    assert out[:2].tolist() == [300 - k + 1, 400 - k + 1]
    # record 1 lies outside [0, 1): only record 0 counts
    out = bloom.xxh3_records_count(words, codes, rec_ids, valid, max_records=1, **geom)
    assert out.tolist() == [300 - k + 1]
    with pytest.raises(ValueError, match="words"):
        bloom.xxh3_records_count(words[:-1], codes, rec_ids, valid, max_records=8, **geom)
    with pytest.raises(ValueError, match="4 <= k <= 32"):
        bloom.xxh3_records_count(words, codes, rec_ids, valid, max_records=8, **dict(geom, k=3))
    with pytest.raises(ValueError, match="rec_ids"):
        bloom.xxh3_records_count(words, codes, rec_ids.long(), valid, max_records=8, **geom)
    with pytest.raises(ValueError, match="n_pos"):
        bloom.xxh3_records_count(words, codes[:100], rec_ids, valid, max_records=8, **geom)


# ---------------------------------------------------------------- the genus model


def _fit_both(tmp_path, genome, k=21):
    meta = tmp_path / "metagenome.fasta"
    meta.write_text(f">g1\n{genome[:5000]}\n>g2\n{genome[5000:]}\n", encoding="utf-8")
    args = (k, "CompatRec", "a", "a@b.c", "Genus")
    jax_model = JaxGenusModel(*args, tmp_path / "jax", hash_family="xxh3")
    model = ProbabilisticSingleFilterModel(*args, tmp_path / "port", hash_family="xxh3", device="cpu")
    for m in (jax_model, model):
        m.fit(meta, "CompatRec metagenome")
        m.save()
    return jax_model, model


@pytest.mark.parametrize("step", [1, 4])
def test_predict_over_a_multi_record_file_writes_the_jax_json(tmp_path, monkeypatch, step):
    rng = np.random.default_rng(31 + step)
    genome = random_dna(rng, 10_000)
    jax_model, model = _fit_both(tmp_path, genome)
    records = [JaxSeqRecord(genome[i * 300 : i * 300 + 150 + 37 * i], id=f"c{i}") for i in range(12)]
    records += [JaxSeqRecord(random_dna(rng, 260), id="random"),
                JaxSeqRecord(genome[7000:7400] + "NNNN" + genome[7400:7700], id="gap"),
                JaxSeqRecord(genome[100:122], id="k_plus_one")]
    fasta = tmp_path / "in.fasta"
    jax_write_fasta(records, fasta)
    # three record batches: the model launches once per batch, not per record
    monkeypatch.setattr(filter_model, "_MAX_RECORD_BATCH_RECORDS", 6)
    calls = []
    real = compat.XXH3BloomFilter.count_hits_batch
    monkeypatch.setattr(compat.XXH3BloomFilter, "count_hits_batch",
                        lambda self, batch: calls.append(batch.num_records) or real(self, batch))
    for kwargs in ({}, {"display_name": True}, {"exclude_ids": ["metagenome"]}, {"exclude_ids": ["other"]}):
        got = model.predict(fasta, step=step, **kwargs)
        want = jax_model.predict(fasta, step=step, **kwargs)
        assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert calls == [6, 6, 3] * 4
    got = model.predict(fasta, step=step)
    assert got.hits["c3"] == {"metagenome": -(-(150 + 37 * 3 - 21 + 1) // step)}
    assert got.hits["k_plus_one"] == {"metagenome": -(-2 // step)}  # 22 bases: two windows
    assert got.num_kmers["gap"] == -(-(704 - 20) // step)


def test_a_reads_file_takes_the_records_route_and_writes_the_jax_json(tmp_path, monkeypatch):
    """A FASTQ of 520 reads of one length, which would take a blocked
    model's reads route, takes the records route under the xxh3 filter."""
    rng = np.random.default_rng(17)
    genome = random_dna(rng, 10_000)
    jax_model, model = _fit_both(tmp_path, genome)
    reads = [genome[s : s + 100] for s in rng.integers(0, 9_900, size=400)]
    reads += [random_dna(rng, 100) for _ in range(119)] + [genome[:50] + "N" * 10 + genome[60:100]]
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("".join(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n" for i, seq in enumerate(reads)),
                     encoding="utf-8")
    monkeypatch.setattr(filter_model.ProbabilisticFilterModel, "_count_reads",
                        lambda *a: pytest.fail("reads route"))
    for kwargs in ({}, {"step": 3, "display_name": True}):
        got = model.predict(fastq, **kwargs)
        want = jax_model.predict(fastq, **kwargs)
        assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert len(got.hits) == 520 and got.hits["r0"] == {"metagenome - metagenome": -(-80 // 3)}


def test_a_record_of_at_most_k_bases_raises_in_batch_mode(tmp_path):
    rng = np.random.default_rng(3)
    genome = random_dna(rng, 10_000)
    jax_model, model = _fit_both(tmp_path, genome)
    for seqs in ([genome[:400], genome[500:521], genome[900:1300]], [genome[:21]]):
        for m, rec in ((jax_model, JaxSeqRecord), (model, SeqRecord)):
            with pytest.raises(ValueError, match="Invalid sequence, must be longer than k"):
                m.predict([rec(s, id=f"s{i}") for i, s in enumerate(seqs)])
    with pytest.raises(ValueError, match="Invalid sequence, must be longer than k"):
        model.calculate_hits(genome[:21], exclude_ids=["metagenome"])
    assert model.calculate_hits(genome[:22]) == jax_model.calculate_hits(genome[:22]) == {"metagenome": 2}
    assert model.calculate_hits(SeqRecord(genome[50:450], id="x"), step=5) == jax_model.calculate_hits(
        JaxSeqRecord(genome[50:450], id="x"), step=5)


@pytest.mark.parametrize("step", [1, 4])
def test_classify_genus_over_multi_record_files_writes_the_jax_json(tmp_path, data_root, fresh_caches, step):
    from xspect2_tpu.definitions import get_xspect_model_path

    rng = np.random.default_rng(41)
    genome = random_dna(rng, 12_000)
    meta = tmp_path / "compatrec.fasta"
    meta.write_text(f">m\n{genome}\n", encoding="utf-8")
    jax_model = JaxGenusModel(21, "CompatRec", "t", "t@x.y", "Genus", get_xspect_model_path(), hash_family="xxh3")
    jax_model.fit(meta, "CompatRec")
    jax_model.save()
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    contigs = [JaxSeqRecord(genome[i * 900 : i * 900 + 250 + 61 * i], id=f"ctg{i}") for i in range(9)]
    contigs.append(JaxSeqRecord(genome[10_000:10_300] + "N" * 30 + random_dna(rng, 200), id="mixed"))
    jax_write_fasta(contigs, in_dir / "asm.fasta")
    jax_write_fasta([JaxSeqRecord(random_dna(rng, 150), id=f"read{i}") for i in range(20)], in_dir / "reads.fa")
    jax_classify.classify_genus("CompatRec", in_dir, tmp_path / "jax" / "g.json", step=step)
    classify.classify_genus("CompatRec", in_dir, tmp_path / "port" / "g.json", step=step, device="cpu")
    for j in (1, 2):
        assert (tmp_path / "port" / f"g_{j}.json").read_bytes() == (tmp_path / "jax" / f"g_{j}.json").read_bytes()


def test_every_kernel_library_names_a_source_in_csrc():
    from xspect2_tpu_torch.ops import _kernels

    for name in _kernels.SIGNATURES:
        sources = _kernels._sources(name)
        assert sources[0].name == f"{name}.cu" and all(p.exists() for p in sources)
    assert [p.name for p in _kernels._sources("xxh3_bloom")][:2] == ["xxh3_bloom.cu", "xxh3.cuh"]
