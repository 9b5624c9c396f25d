"""The port's read wire, kernels' plain versions and engine equal the JAX package.

One index is built with the JAX package's ``BlockedBitSlicedIndex`` and
carried across with ``convert.index_from_arrays``; the same numpy-seeded
reads then go through ``xspect2_tpu.ops.query.DeviceQueryEngine`` (JAX
on the CPU), the port's engine on the CPU (the kernels' plain versions)
and the host reference ``count_hits_host``.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from xspect2_tpu.core import dna as jax_dna
from xspect2_tpu.core.blocked_index import BlockedBitSlicedIndex as JaxIndex
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import convert
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.ops import query

# (classes, num_hashes): field-packed C=8 (P=4), C=1 (P=32), 2 class
# words, 16 class words
GEOMETRIES = {
    "c8_p4_h2": (8, 2),
    "c1_p32_h3": (1, 3),
    "c40_cw2_h7": (40, 7),
    "c512_cw16_h3": (512, 3),
}


def _genomes(rng, num_classes, length):
    return [rng.integers(0, 4, size=length, dtype=np.uint8) for _ in range(num_classes)]


def _jax_index(genomes, k, num_hashes):
    names = [f"c{i}" for i in range(len(genomes))]
    idx = JaxIndex.create(k, names, len(genomes[0]), fpr=0.01, num_hashes=num_hashes)
    for ci, g in enumerate(genomes):
        hi, lo, v = jax_dna.canonical_kmers(g, k)
        idx.insert_kmers(ci, hi, lo, v)
    return idx


def _reads(rng, genomes, n, read_len):
    """Reads from random classes, half reverse-complemented, some with Ns."""
    out = np.empty((n, read_len), dtype=np.uint8)
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        s = int(rng.integers(0, len(g) - read_len))
        r = g[s : s + read_len]
        out[i] = 3 - r[::-1] if i % 2 else r
    out[1, 5] = 255
    out[2, [0, read_len - 1]] = 255
    out[n - 1, read_len // 2] = 255
    return out


def _host_counts(idx, reads, step):
    rows = []
    for r in reads:
        hi, lo, valid = dna.canonical_kmers(r, idx.k, step=step)
        rows.append(idx.count_hits_host(hi, lo, valid))
    return np.stack(rows)


@pytest.fixture(scope="module")
def indices():
    rng = np.random.default_rng(99)
    out = {}
    for name, (num_classes, h) in GEOMETRIES.items():
        genomes = _genomes(rng, num_classes, 3000 if num_classes <= 40 else 400)
        jidx = _jax_index(genomes, 21, h)
        out[name] = (jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table), genomes)
    return out


def test_index_from_arrays_keeps_geometry(indices):
    jidx, idx, _ = indices["c8_p4_h2"]
    assert (idx.fields_per_word, idx.num_hashes) == (4, 2)
    assert idx.meta_dict() == jidx.meta_dict()
    np.testing.assert_array_equal(idx.device_table(), jidx.device_table())
    _, idx512, _ = indices["c512_cw16_h3"]
    assert idx512.class_words == 16


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("read_len,step", [(150, 1), (150, 2), (300, 4)])
def test_count_hits_reads_matches_jax_and_host(indices, name, read_len, step):
    jidx, idx, genomes = indices[name]
    rng = np.random.default_rng(read_len * 10 + step)
    n = 13  # not a multiple of reads_per_chunk: padding rows are queried too
    reads = _reads(rng, genomes, n, read_len)
    want = jax_query.DeviceQueryEngine(jidx, chunk=512).count_hits_reads(
        reads, step=step, reads_per_chunk=8
    )
    engine = query.DeviceQueryEngine(idx, device="cpu")
    got = engine.count_hits_reads(reads, step=step, reads_per_chunk=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host_counts(idx, reads, step))
    raw = engine.count_hits_reads(reads, step=step, reads_per_chunk=8, wire="raw")
    np.testing.assert_array_equal(raw, want)
    # the source class of each read without an N is hit in every window
    assert (got.max(axis=1)[3:-1] == -(-(read_len - 20) // step)).all()


@pytest.mark.parametrize("read_len,step,dtype", [
    (150, 1, torch.uint8), (275, 1, torch.uint8), (276, 1, torch.int32), (300, 2, torch.uint8),
])
def test_unsynchronized_result_dtype_and_padding(indices, read_len, step, dtype):
    _, idx, genomes = indices["c40_cw2_h7"]
    reads = _reads(np.random.default_rng(5), genomes, 10, read_len)
    engine = query.DeviceQueryEngine(idx, device="cpu")
    out = engine.count_hits_reads(reads, step=step, reads_per_chunk=16, block=False)
    assert out.dtype == dtype and tuple(out.shape) == (16, 40)
    # poisoned padding rows count nothing
    assert int(out[10:].long().sum()) == 0
    np.testing.assert_array_equal(out[:10].long().numpy(), _host_counts(idx, reads, step))


def test_pack_reads_wire_matches_jax_package():
    rng = np.random.default_rng(11)
    reads = rng.integers(0, 4, size=(37, 150), dtype=np.uint8)
    reads[3, 7] = reads[3, 140] = reads[20, 0] = 255
    for n_pad in (37, 64):
        got = query.pack_reads_wire(reads, 21, n_pad)
        want = jax_query.pack_reads_wire(reads, 21, n_pad)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("read_len", [150, 149, 300])
def test_unpack_restores_codes_and_poisons_padding(read_len):
    rng = np.random.default_rng(read_len)
    n, n_pad, k = 29, 40, 21
    reads = rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)
    reads[rng.integers(0, n, 6), rng.integers(0, read_len, 6)] = 255
    packed, rows, cols = jax_query.pack_reads_wire(reads, k, n_pad)
    assert (rows >= n_pad).any()  # sentinel entries are present
    codes = query.unpack_2bit(
        torch.from_numpy(packed), torch.from_numpy(rows), torch.from_numpy(cols), read_len
    ).numpy()
    want = np.zeros((n_pad, read_len), dtype=np.uint8)
    want[:n] = reads
    want[n:, ::k] = 255
    np.testing.assert_array_equal(codes, want)


def test_plain_read_query_matches_host_reference_with_k_below_16():
    """k <= 16 leaves the hi word empty; k=31 fills it."""
    rng = np.random.default_rng(3)
    for k in (15, 31):
        genomes = _genomes(rng, 5, 1500)
        jidx = _jax_index(genomes, k, 4)
        idx = convert.index_from_arrays(jidx.meta_dict(), jidx.table)
        reads = _reads(rng, genomes, 9, 100)
        got = query.DeviceQueryEngine(idx, device="cpu").count_hits_reads(reads, step=3)
        np.testing.assert_array_equal(got, _host_counts(idx, reads, 3))


def test_reads_query_rejects_bad_geometry(indices):
    _, idx, _ = indices["c8_p4_h2"]
    engine = query.DeviceQueryEngine(idx, device="cpu")
    geom = engine.geometry()
    codes = torch.zeros((4, 150), dtype=torch.uint8)
    with pytest.raises(ValueError):
        query.reads_query(codes, engine.table[:-1], step=1, **geom)
    with pytest.raises(ValueError):
        query.reads_query(codes.int(), engine.table, step=1, **geom)
    with pytest.raises(ValueError):
        engine.count_hits_reads(codes.numpy(), wire="fat")


@pytest.mark.parametrize("num_classes,fits", [(512, True), (2730, True), (2731, False)])
def test_reads_query_class_count_limit(num_classes, fits):
    """Three reads' counters must fit K2's shared memory: 2,730 classes at most."""
    class_words, rpb = -(-num_classes // 32), 4
    codes = torch.zeros((2, 30), dtype=torch.uint8)
    table = torch.zeros((3, class_words * rpb), dtype=torch.int32)
    geom = dict(
        k=21, step=1, num_blocks=3, rows_per_block=rpb, class_words=class_words,
        num_hashes=2, fields_per_word=1, num_classes=num_classes,
    )
    if fits:
        query._check_geometry(codes, table, **geom)
    else:
        with pytest.raises(ValueError, match="shared counters"):
            query.reads_query(codes, table, **geom)


def test_upload_wire_is_the_padded_packed_wire(indices):
    _, idx, genomes = indices["c8_p4_h2"]
    reads = _reads(np.random.default_rng(9), genomes, 21, 150)
    wire = query.DeviceQueryEngine(idx, device="cpu").upload_wire(reads, reads_per_chunk=16)
    want = jax_query.pack_reads_wire(reads, idx.k, 32)
    for g, w in zip(wire, want):
        np.testing.assert_array_equal(g.numpy(), w)

