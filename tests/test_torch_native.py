"""The port's copy of the native bindings equals the JAX package's, and each
numpy fallback equals the native library."""

import numpy as np
import pytest

from xspect2_tpu import native as jax_native
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
