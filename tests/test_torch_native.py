"""The port's copy of the native bindings equals the JAX package's, and each
numpy fallback equals the native library."""

import numpy as np
import pytest

from xspect2_tpu import native as jax_native
from xspect2_tpu.core import dna as jax_dna
from xspect2_tpu.core.blocked_index import BlockedBitSlicedIndex as JaxIndex
from xspect2_tpu_torch import native
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex


def _fastq(path, rng):
    lines = []
    for i in range(50):
        seq = "".join(rng.choice(list("ACGTNacgt"), size=120))
        lines += [f"@id{i} desc", seq, "+", "I" * 120]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def test_parse_file_matches_jax_package_and_fallback(tmp_path, monkeypatch):
    fastq = tmp_path / "r.fastq"
    _fastq(fastq, np.random.default_rng(1))
    want = jax_native.parse_file(fastq)
    got = native.parse_file(fastq)
    monkeypatch.setattr(native, "_load", lambda: None)
    fallback = native.parse_file(fastq)
    for other in (got, fallback):
        np.testing.assert_array_equal(other[0], want[0])
        np.testing.assert_array_equal(other[1], want[1])
        assert other[2] == want[2]


def test_pack_2bit_fallback_matches_native(monkeypatch):
    rng = np.random.default_rng(2)
    reads = rng.integers(0, 4, size=(64, 150), dtype=np.uint8)
    reads[rng.integers(0, 64, 9), rng.integers(0, 150, 9)] = 255
    assert native.available()
    lib = native.pack_2bit(reads)
    monkeypatch.setattr(native, "_load", lambda: None)
    fallback = native.pack_2bit(reads)
    for a, b in zip(lib, fallback):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_classes,num_hashes", [(8, 2), (1, 3), (40, 7)])
def test_insert_kmers_native_and_fallback_match_jax_index(num_classes, num_hashes, monkeypatch):
    rng = np.random.default_rng(num_classes)
    genomes = [rng.integers(0, 4, size=2000, dtype=np.uint8) for _ in range(num_classes)]
    genomes[0][100] = 255
    names = [f"c{i}" for i in range(num_classes)]
    jidx = JaxIndex.create(21, names, 2000, num_hashes=num_hashes)
    for ci, g in enumerate(genomes):
        jax_native.insert_kmers(jidx, ci, g)
    idx = BlockedBitSlicedIndex.create(21, names, 2000, num_hashes=num_hashes)
    for ci, g in enumerate(genomes):
        native.insert_kmers(idx, ci, g)
    np.testing.assert_array_equal(idx.table, jidx.table)
    monkeypatch.setattr(native, "_load", lambda: None)
    fb = BlockedBitSlicedIndex.create(21, names, 2000, num_hashes=num_hashes)
    for ci, g in enumerate(genomes):
        native.insert_kmers(fb, ci, g)
    np.testing.assert_array_equal(fb.table, jidx.table)


@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("num_classes,num_hashes", [(8, 2), (1, 3)])
def test_count_hits_native_and_fallback_match_jax(step, num_classes, num_hashes, monkeypatch):
    """The host reference query, with the library and through its
    no-library path, equals the JAX package's at steps 1 and 4."""
    rng = np.random.default_rng(10 * num_classes + step)
    genomes = [rng.integers(0, 4, size=3000, dtype=np.uint8) for _ in range(num_classes)]
    names = [f"c{i}" for i in range(num_classes)]
    jidx = JaxIndex.create(21, names, 3000, num_hashes=num_hashes)
    idx = BlockedBitSlicedIndex.create(21, names, 3000, num_hashes=num_hashes)
    for ci, g in enumerate(genomes):
        jax_native.insert_kmers(jidx, ci, g)
        native.insert_kmers(idx, ci, g)
    query = np.concatenate([genomes[0][:1200], rng.integers(0, 4, size=800, dtype=np.uint8)])
    query[[50, 1500]] = 255
    want = jax_native.count_hits(jidx, query, step=step)
    assert native.available()
    got = native.count_hits(idx, query, step=step)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert want[0] > 0
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(native.count_hits(idx, query, step=step), want)


@pytest.mark.parametrize("k,step", [(21, 1), (21, 3), (31, 1), (5, 2)])
def test_canonical_kmers_native_and_fallback_match_jax(k, step, monkeypatch):
    rng = np.random.default_rng(k + step)
    codes = rng.integers(0, 4, size=2_000, dtype=np.uint8)
    codes[[7, 900]] = 255
    want = jax_native.canonical_kmers(codes, k, step=step)
    assert native.available()
    got = native.canonical_kmers(codes, k, step=step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [len(a) for a in native.canonical_kmers(codes[: k - 1], k)] == [0, 0, 0]
    # without the library: the numpy packing, which leaves the words of an
    # invalid window unset where the library zeroes them
    monkeypatch.setattr(native, "_load", lambda: None)
    fallback = native.canonical_kmers(codes, k, step=step)
    valid = want[2]
    np.testing.assert_array_equal(fallback[2], valid)
    for a, b in zip(fallback[:2], want[:2]):
        np.testing.assert_array_equal(a[valid], b[valid])
    for a, b in zip(fallback, jax_dna.canonical_kmers(codes, k, step=step)):
        np.testing.assert_array_equal(a, b)


def test_xxh3_64_batch_matches_jax_and_the_numpy_hash(monkeypatch):
    from xspect2_tpu_torch.core import xxh3

    rng = np.random.default_rng(5)
    for length in (0, 1, 4, 16, 21, 64, 129, 240):
        arr = rng.integers(0, 256, size=(50, length), dtype=np.uint8)
        for seed in (0, 2**64 - 1):
            want = jax_native.xxh3_64_batch(arr, seed)
            got = native.xxh3_64_batch(arr, seed)
            np.testing.assert_array_equal(got, want)
        if length >= 4:  # the numpy batch hash's range
            np.testing.assert_array_equal(native.xxh3_64_batch(arr), xxh3.xxh3_64_batch(arr))
    with pytest.raises(ValueError, match="0..240"):
        native.xxh3_64_batch(np.zeros((2, 241), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        native.xxh3_64_batch(np.zeros(4, np.uint8))
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.xxh3_64_batch(np.zeros((2, 5), np.uint8)) is None
