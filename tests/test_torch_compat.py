"""The port's xxh3 compat genus path and sequence filtering equal the JAX package's.

The numpy XXH3-64, the probe positions and the filter words are held
against ``xspect2_tpu.core.xxh3`` / ``core.compat`` on the same
numpy-seeded sequences; ``count_hits_device`` of the port (on
``device="cpu"``, the plain version of the bit-test kernel) against the
JAX device count and the host count; the xxh3 genus model's files and
result JSON, and the FASTA files written by ``filter_species`` /
``filter_genus``, against the JAX package's, byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from tests.conftest import random_dna
from xspect2_tpu import classify as jax_classify
from xspect2_tpu import filter_sequences as jax_filter
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.core import compat as jax_compat
from xspect2_tpu.core import xxh3 as jax_xxh3
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta as jax_write_fasta
from xspect2_tpu.models.single_filter_model import ProbabilisticSingleFilterModel as JaxGenusModel
from xspect2_tpu_torch import classify, convert, file_io, filter_sequences, model_cache
from xspect2_tpu_torch.core import compat, dna, xxh3
from xspect2_tpu_torch.io.fasta import SeqRecord, parse_fasta, write_fasta
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.ops import bloom

K = 21


@pytest.fixture()
def fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


# ---------------------------------------------------------------- hashing


@pytest.mark.parametrize("length", [4, 8, 9, 16, 17, 21, 31, 128, 129, 240])
def test_xxh3_batch_matches_jax_package_and_scalar(length):
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, size=(50, length), dtype=np.uint8)
    got = xxh3.xxh3_64_batch(rows)
    np.testing.assert_array_equal(got, jax_xxh3.xxh3_64_batch(rows))
    assert int(got[0]) == xxh3.xxh3_64(bytes(rows[0])) == jax_xxh3.xxh3_64(bytes(rows[0]))
    np.testing.assert_array_equal(xxh3.xxh3_64_batch(rows, seed=7), jax_xxh3.xxh3_64_batch(rows, seed=7))


@pytest.mark.parametrize("k", [5, 16, 21, 31])
def test_digests_and_probe_positions_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=400, dtype=np.uint8)
    hi, lo, valid = dna.canonical_kmers(codes, k)
    np.testing.assert_array_equal(compat.ascii_from_packed(hi, lo, k), jax_compat.ascii_from_packed(hi, lo, k))
    digests = compat.kmer_digests(hi, lo, k)
    np.testing.assert_array_equal(digests, jax_compat.kmer_digests(hi, lo, k))
    for num_bits, h in ((1000, 1), (306_721_869, 7), (2**32 - 5, 3)):
        got = compat.derive_probe_positions(digests, num_bits, h)
        np.testing.assert_array_equal(got, jax_compat.derive_probe_positions(digests, num_bits, h))
        assert got.shape == (len(hi), h) and int(got.max()) < num_bits
    assert compat.rbloom_geometry(32_000_000, 0.01) == jax_compat.rbloom_geometry(32_000_000, 0.01)
    with pytest.raises(ValueError):
        compat.ascii_from_packed(hi, lo, 33)


# ---------------------------------------------------------------- filter


def _filters(seq, fpr=0.01):
    n = len(seq) - K + 1
    jax_filter_ = jax_compat.XXH3BloomFilter.for_items(n, fpr, K)
    filt = compat.XXH3BloomFilter.for_items(n, fpr, K, device="cpu")
    jax_filter_.insert_sequence(seq)
    filt.insert_sequence(seq)
    return jax_filter_, filt


def test_filter_words_match_jax_and_chunked_insert_changes_nothing(monkeypatch):
    rng = np.random.default_rng(1)
    genome = random_dna(rng, 6000)[:3000] + "N" + random_dna(rng, 3000)
    jax_filter_, filt = _filters(genome)
    assert (filt.num_bits, filt.num_hashes, filt.k) == (jax_filter_.num_bits, jax_filter_.num_hashes, K)
    assert filt.num_hashes == 7
    np.testing.assert_array_equal(filt.words, jax_filter_.words)
    monkeypatch.setattr(compat, "_INSERT_WINDOWS", 257)
    chunked = compat.XXH3BloomFilter.for_items(len(genome) - K + 1, 0.01, K, device="cpu")
    chunked.insert_sequence(genome)
    np.testing.assert_array_equal(chunked.words, filt.words)
    short = compat.XXH3BloomFilter(1000, 3, K, device="cpu")
    short.insert_sequence("ACGT")  # shorter than k: nothing to insert
    assert not short.words.any()


@pytest.mark.parametrize("probe_len", [21, 777, 5000])
def test_device_count_matches_jax_device_and_host(probe_len):
    rng = np.random.default_rng(probe_len)
    genome = random_dna(rng, 5000)
    jax_filter_, filt = _filters(genome)
    probe = genome[100 : 100 + probe_len // 2] + "N" + random_dna(rng, probe_len)
    hi, lo, valid = dna.canonical_kmers(dna.encode(probe), K)
    assert not valid.all()
    got = filt.count_hits_device(hi, lo, valid)
    assert got == jax_filter_.count_hits_device(hi, lo, valid)
    assert got == filt.count_hits_host(hi, lo, valid) == jax_filter_.count_hits_host(hi, lo, valid)
    assert filt.count_hits_sequence(probe) == filt.count_hits_sequence(probe, device=False) == got
    # the N-window rule: windows holding the N are skipped at insert and at query
    assert got <= int(valid.sum()) < len(valid)
    inside = genome[200:600]
    assert filt.count_hits_sequence(inside) == len(inside) - K + 1


def test_bloom_count_wrapper_checks_and_plain_version():
    words = torch.tensor([0b1011, -1], dtype=torch.int32)  # word 1 has all 32 bits set
    pos = torch.tensor([[0, 1], [0, 2], [3, 63], [35, 64], [-1, 0]], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, True])
    # k-mer 1 misses bit 2; k-mer 3 is masked; position 2^32-1 lies past the filter
    assert int(bloom.bloom_count(words, pos, valid)) == 2
    assert bloom.bloom_count(words, pos, valid).dtype == torch.int32
    assert bloom.bloom_count.launches == 0  # the CPU takes the plain version
    with pytest.raises(ValueError, match="words"):
        bloom.bloom_count(words.long(), pos, valid)
    with pytest.raises(ValueError, match="pos"):
        bloom.bloom_count(words, pos.long(), valid)
    with pytest.raises(ValueError, match="valid"):
        bloom.bloom_count(words, pos, valid[:2])
    big = compat.XXH3BloomFilter(2**32 + 64, 2, K, device="cpu")
    with pytest.raises(NotImplementedError, match="2\\^32"):
        big.count_hits_device(np.zeros(1, np.uint32), np.zeros(1, np.uint32), np.ones(1, bool))
    with pytest.raises(ValueError, match="4 <= k <= 32"):
        compat.XXH3BloomFilter(100, 2, 3)


def test_filter_files_load_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    jax_filter_, filt = _filters(random_dna(rng, 2000))
    jax_filter_.save(tmp_path / "jax.npz")
    filt.save(tmp_path / "port.npz")
    from_jax = compat.XXH3BloomFilter.load(tmp_path / "jax.npz", device="cpu")
    from_port = jax_compat.XXH3BloomFilter.load(tmp_path / "port.npz")
    for f in (from_jax, from_port):
        assert (f.num_bits, f.num_hashes, f.k) == (filt.num_bits, filt.num_hashes, K)
        np.testing.assert_array_equal(f.words, filt.words)
    carried = convert.bloom_filter_from_arrays(
        dict(num_bits=jax_filter_.num_bits, num_hashes=jax_filter_.num_hashes, k=K),
        jax_filter_.words, device="cpu")
    np.testing.assert_array_equal(carried.words, filt.words)
    with pytest.raises(ValueError, match="words"):
        convert.bloom_filter_from_arrays(dict(num_bits=64, num_hashes=1, k=K), jax_filter_.words)
    np.savez(tmp_path / "other.npz", words=filt.words, meta=np.frombuffer(b'{"format": "x"}', dtype=np.uint8))
    with pytest.raises(ValueError, match="not an xxh3 compat filter"):
        compat.XXH3BloomFilter.load(tmp_path / "other.npz")


# ---------------------------------------------------------------- genus model


def _fit_both(tmp_path, genome):
    meta = tmp_path / "metagenome.fasta"
    meta.write_text(f">g1\n{genome[:4000]}\n>g2\n{genome[4000:]}\n", encoding="utf-8")
    args = (K, "CompatGenus", "a", "a@b.c", "Genus")
    jax_model = JaxGenusModel(*args, tmp_path / "jax", hash_family="xxh3")
    model = ProbabilisticSingleFilterModel(*args, tmp_path / "port", hash_family="xxh3", device="cpu")
    for m in (jax_model, model):
        m.fit(meta, "CompatGenus metagenome")
        m.save()
    return jax_model, model


def test_xxh3_genus_model_files_and_results_match_jax(tmp_path, data_root):
    rng = np.random.default_rng(11)
    genome = random_dna(rng, 8000)
    jax_model, model = _fit_both(tmp_path, genome)
    assert model.to_dict() == jax_model.to_dict() and model.to_dict()["hash_family"] == "xxh3"
    slug = model.slug()
    assert (tmp_path / "port" / f"{slug}.json").read_bytes() == (tmp_path / "jax" / f"{slug}.json").read_bytes()
    assert model.get_index_path() == tmp_path / "port" / slug / "filter.xxh3.npz"
    np.testing.assert_array_equal(model.compat_filter.words, jax_model.compat_filter.words)

    # a model saved by either package loads in the other
    loaded = ProbabilisticSingleFilterModel.load(tmp_path / "jax" / f"{slug}.json", device="cpu")
    jax_loaded = JaxGenusModel.load(tmp_path / "port" / f"{slug}.json")
    assert loaded.hash_family == "xxh3" and loaded.index is None
    np.testing.assert_array_equal(loaded.compat_filter.words, jax_loaded.compat_filter.words)

    sub = genome[1000:1400]
    assert loaded.calculate_hits(sub) == jax_loaded.calculate_hits(sub) == {"metagenome": len(sub) - K + 1}
    assert loaded.calculate_hits(sub, step=7) == jax_loaded.calculate_hits(sub, step=7)
    assert loaded.calculate_hits(sub, exclude_ids=["metagenome"]) == {}
    with pytest.raises(ValueError, match="longer than k"):
        loaded.calculate_hits("A" * K)
    seqs = {"inside": sub, "outside": random_dna(rng, 400), "gap": genome[3990:4010] + "N" + genome[5000:5100]}
    for kwargs in ({}, {"step": 3}, {"display_name": True}, {"exclude_ids": ["metagenome"]}):
        got = loaded.predict([SeqRecord(s, id=i) for i, s in seqs.items()], **kwargs)
        want = jax_loaded.predict([JaxSeqRecord(s, id=i) for i, s in seqs.items()], **kwargs)
        assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert loaded.predict(SeqRecord(sub, id="inside")).get_scores()["inside"]["metagenome"] == 1.0
    got = loaded.predict([SeqRecord(s, id=i) for i, s in seqs.items()], validation=True)
    want = jax_loaded.predict([JaxSeqRecord(s, id=i) for i, s in seqs.items()], validation=True)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict()) and got.misclassified is None
    with pytest.raises(ValueError, match="No sequences"):
        loaded.predict([])
    (tmp_path / "port" / slug / "filter.xxh3.npz").unlink()
    with pytest.raises(FileNotFoundError):
        ProbabilisticSingleFilterModel.load(tmp_path / "port" / f"{slug}.json", device="cpu")


def test_classify_genus_with_the_compat_model_writes_the_jax_json(tmp_path, data_root, fresh_caches):
    from xspect2_tpu.definitions import get_xspect_model_path

    rng = np.random.default_rng(21)
    genome = random_dna(rng, 8000)
    meta = tmp_path / "compatgenus.fasta"
    meta.write_text(f">m\n{genome}\n", encoding="utf-8")
    # one registry: trained by the JAX package, read by both
    jax_model = JaxGenusModel(K, "CompatX", "t", "t@x.y", "Genus", get_xspect_model_path(), hash_family="xxh3")
    jax_model.fit(meta, "CompatX")
    jax_model.save()
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    jax_write_fasta([JaxSeqRecord(genome[2000:5000], id="c1"), JaxSeqRecord(random_dna(rng, 700), id="c2")],
                    in_dir / "a.fasta")
    jax_write_fasta([JaxSeqRecord(genome[100:900] + "NN" + genome[900:1200], id="d1")], in_dir / "b.fna")
    for step in (1, 4):
        jax_classify.classify_genus("CompatX", in_dir, tmp_path / "jax" / "g.json", step=step)
        classify.classify_genus("CompatX", in_dir, tmp_path / "port" / "g.json", step=step, device="cpu")
        for j in (1, 2):
            got = (tmp_path / "port" / f"g_{j}.json").read_bytes()
            assert got == (tmp_path / "jax" / f"g_{j}.json").read_bytes()
    assert json.loads((tmp_path / "port" / "g_1.json").read_text())["scores"]["c1"]["compatgenus"] == 1.0


# ---------------------------------------------------------------- filter_sequences


def _mixed_fasta(path, genomes, rng):
    records = []
    for i in range(8):
        records.append(JaxSeqRecord(genomes["470"][i * 700 : i * 700 + 400], id=f"a{i}", description=f"a{i} from 470"))
        records.append(JaxSeqRecord(genomes["471"][i * 700 : i * 700 + 400], id=f"b{i}"))
        records.append(JaxSeqRecord(random_dna(rng, 400), id=f"junk{i}"))
    jax_write_fasta(records, path)


@pytest.mark.parametrize("threshold", [0.7, -1])
def test_filter_species_and_genus_write_the_jax_fasta(session_data_root, tmp_path, fresh_caches, threshold):
    _, genomes = session_data_root
    mixed = tmp_path / "mixed.fasta"
    _mixed_fasta(mixed, genomes, np.random.default_rng(77))
    for pkg, kwargs, out in ((jax_filter, {}, tmp_path / "jax"), (filter_sequences, {"device": "cpu"}, tmp_path / "port")):
        out.mkdir()
        pkg.filter_species("Synthetic", "470", mixed, out / "species.fasta", threshold,
                           classification_output_path=out / "species.json", sparse_sampling_step=2, **kwargs)
        if threshold != -1:
            pkg.filter_genus("Synthetic", mixed, out / "genus.fasta", threshold,
                             classification_output_path=out / "genus.json", **kwargs)
    names = ["species.fasta", "species.json"] + (["genus.fasta", "genus.json"] if threshold != -1 else [])
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    kept = {r.id for r in parse_fasta(tmp_path / "port" / "species.fasta")}
    assert {f"a{i}" for i in range(8)} <= kept and not any(r.startswith("b") for r in kept)


def test_filter_over_a_directory_and_without_matches(session_data_root, tmp_path, fresh_caches, capsys):
    _, genomes = session_data_root
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _mixed_fasta(in_dir / "one.fasta", genomes, np.random.default_rng(1))
    jax_write_fasta([JaxSeqRecord(random_dna(np.random.default_rng(2), 500), id="junk")], in_dir / "two.fasta")
    for pkg, kwargs, out in ((jax_filter, {}, tmp_path / "jax"), (filter_sequences, {"device": "cpu"}, tmp_path / "port")):
        out.mkdir()
        pkg.filter_genus("Synthetic", in_dir, out / "kept.fasta", 0.7, **kwargs)
    assert "No sequences found for the given genus in two.fasta." in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["kept_1.fasta"]
    assert (tmp_path / "port" / "kept_1.fasta").read_bytes() == (tmp_path / "jax" / "kept_1.fasta").read_bytes()


def test_file_io_helpers_match_jax(tmp_path, capsys):
    from xspect2_tpu import file_io as jax_file_io

    src = tmp_path / "src.fasta"
    seq = random_dna(np.random.default_rng(3), 150)
    write_fasta([SeqRecord(seq, id="r1", description="r1 first"), SeqRecord(seq[:70], id="r2"),
                 SeqRecord(seq[:61], id="r3", description="third")], src)
    jax_write_fasta([JaxSeqRecord(seq, id="r1", description="r1 first"), JaxSeqRecord(seq[:70], id="r2"),
                     JaxSeqRecord(seq[:61], id="r3", description="third")], tmp_path / "jax_src.fasta")
    assert src.read_bytes() == (tmp_path / "jax_src.fasta").read_bytes()
    file_io.filter_sequences(src, tmp_path / "port.fasta", ["r1", "r3", "absent"])
    jax_file_io.filter_sequences(src, tmp_path / "jax.fasta", ["r1", "r3", "absent"])
    assert (tmp_path / "port.fasta").read_bytes() == (tmp_path / "jax.fasta").read_bytes()
    file_io.filter_sequences(src, tmp_path / "none.fasta", [])
    assert not (tmp_path / "none.fasta").exists() and "No IDs provided" in capsys.readouterr().out

    batch = f">Oxf_cpn60_1\n{seq[:60]}\n{seq[60:100]}\n\n>Oxf_cpn60_263 extra\r\n{seq[:90]}\n"
    for module, out in ((file_io, tmp_path / "port_locus"), (jax_file_io, tmp_path / "jax_locus")):
        out.mkdir()
        (out / "Allele_ID_1.fasta").write_text("kept\n", encoding="utf-8")  # existing files are not rewritten
        module.create_fasta_files(out, batch)
    assert sorted(p.name for p in (tmp_path / "port_locus").iterdir()) == ["Allele_ID_1.fasta", "Allele_ID_263.fasta"]
    for name in ("Allele_ID_1.fasta", "Allele_ID_263.fasta"):
        assert (tmp_path / "port_locus" / name).read_bytes() == (tmp_path / "jax_locus" / name).read_bytes()
