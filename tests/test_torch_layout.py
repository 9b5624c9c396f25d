"""The table layout on the card: the index's own row-major table.

The engine uploads ``index.table`` as it is, int32 [num_blocks,
rows_per_block * class_words] with word (row, w) of a block at
``row * class_words + w``, and the class-word and block shards of the
sharded classifiers are slices of it.  The kernels' plain versions read
that layout; these tests hold their counts against the JAX package,
which queries its class-word-major device layout: its
``DeviceQueryEngine`` (JAX on the CPU) and ``count_hits_host``, at 2, 16
and 32 class words with 1 and 7 probes and at the MLST geometry (1,000
alleles, k=31, one probe) through the multi-index query.  Owned-block
counts of 2, 3 and 4 block shards sum to the whole table's.  Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_query import _genomes, _jax_index
from xspect2_tpu.core import dna as jax_dna
from xspect2_tpu.core.blocked_index import BlockedBitSlicedIndex as JaxIndex
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import convert
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.ops import query
from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard
from xspect2_tpu_torch.parallel.sharded import cls_table_shard

CHUNK = 8192


def _records(rng, genomes, n, lo, hi):
    """Records cut from random genomes, half reverse-complemented, some with an N."""
    out = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        length = int(rng.integers(lo, min(hi, len(g))))
        s = int(rng.integers(0, len(g) - length + 1))
        c = g[s : s + length].copy()
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        if i % 3 == 0:
            c[int(rng.integers(0, length))] = 255
        out.append((f"r{i}", c))
    return out


def _host(idx, records, k, step=1):
    return np.stack([idx.count_hits_host(*dna.canonical_kmers(c, k, step=step)) for _, c in records])


@pytest.mark.parametrize("num_classes,class_words", [(20, 1), (40, 2), (512, 16), (1000, 32)])
def test_engine_table_and_shards_are_slices_of_the_row_major_table(num_classes, class_words):
    rng = np.random.default_rng(num_classes)
    idx = BlockedBitSlicedIndex.create(21, [f"c{i}" for i in range(num_classes)], 3000)
    assert (idx.class_words, idx.fields_per_word) == (class_words, 1)
    idx.table[:] = rng.integers(0, 2**32, size=idx.table.size, dtype=np.uint64).astype(np.uint32)
    nb, rpb, cw = idx.num_blocks, idx.rows_per_block, idx.class_words
    t3 = idx.table.reshape(nb, rpb, cw)

    table = query.DeviceQueryEngine(idx, device="cpu").table
    assert table.dtype == torch.int32 and tuple(table.shape) == (nb, rpb * cw)
    np.testing.assert_array_equal(table.numpy().view(np.uint32), t3.reshape(nb, -1))
    assert not np.shares_memory(table.numpy(), idx.table)  # a copy: the index stays the host's

    for n in (2, 4):
        cw_local = -(-cw // n)
        local = -(-nb // n)
        for m in range(n):
            want = np.zeros((nb, rpb, cw_local), dtype=np.uint32)
            part = t3[:, :, m * cw_local : (m + 1) * cw_local]
            want[:, :, : part.shape[2]] = part
            np.testing.assert_array_equal(cls_table_shard(idx, n, m), want.reshape(nb, -1))
            want = np.zeros((local, rpb, cw), dtype=np.uint32)
            part = t3[m * local : (m + 1) * local]
            want[: len(part)] = part
            np.testing.assert_array_equal(blk_table_shard(idx, n, m), want.reshape(local, -1))


@pytest.fixture(scope="module")
def wide_indices():
    """JAX-built indices at 2, 16 and 32 class words with 1 and 7 probes,
    carried across, and their genomes."""
    rng = np.random.default_rng(5)
    out = {}
    for num_classes in (40, 512, 1000):
        genomes = _genomes(rng, num_classes, 400 if num_classes <= 40 else 150)
        for h in (1, 7):
            jidx = _jax_index(genomes, 21, h)
            out[num_classes, h] = (jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table), genomes)
    return out


@pytest.mark.parametrize("num_classes", [40, 512, 1000])
@pytest.mark.parametrize("num_hashes", [1, 7])
def test_plain_counts_over_the_row_major_table_equal_the_jax_package(wide_indices, num_classes, num_hashes):
    jidx, idx, genomes = wide_indices[num_classes, num_hashes]
    assert idx.class_words == {40: 2, 512: 16, 1000: 32}[num_classes] and idx.fields_per_word == 1
    rng = np.random.default_rng(num_classes + num_hashes)
    records = _records(rng, genomes, 11, 22, 400)
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    for step in (1, 3):
        batch = query.prepare_batch(records, 21, step=step, chunk=engine.chunk)
        jbatch = jax_query.prepare_batch(records, 21, step=step, chunk=engine.chunk)
        want = jax_query.DeviceQueryEngine(jidx, chunk=CHUNK).count_hits(jbatch)
        got = engine.count_hits(batch)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _host(idx, records, 21, step))
    # the read query's plain version reads the same layout
    reads = np.stack([g[:120] for g in genomes[:9]])
    reads[3, 40] = 255
    got = query.reads_query_plain(torch.from_numpy(reads), engine.table, step=1, **engine.geometry())
    want = [jidx.count_hits_host(*jax_dna.canonical_kmers(r, 21)) for r in reads]
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert got.sum() > 0


def test_mlst_geometry_tables_through_the_multi_query_plain():
    """Three 1,000-allele tables (k=31, fpr 0.001, h=1: cw=32, 8 rows a
    block) and a 40-allele one through ``multi_records_query_plain`` give
    the JAX engine's and the host's counts, table by table."""
    rng = np.random.default_rng(31)
    pairs, alleles = [], []
    for num_classes in (1000, 1000, 1000, 40):
        genomes = _genomes(rng, num_classes, 450)
        jidx = JaxIndex.create(31, [f"a{i}" for i in range(num_classes)], 450, fpr=0.001, num_hashes=1)
        for ci, g in enumerate(genomes):
            jidx.insert_kmers(ci, *jax_dna.canonical_kmers(g, 31))
        pairs.append((jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table)))
        alleles += genomes[:3]
    assert [(j.class_words, j.rows_per_block, j.num_hashes) for j, _ in pairs[:3]] == [(32, 8, 1)] * 3
    pool = np.concatenate([alleles[int(i)] for i in rng.integers(0, len(alleles), 30)])
    records = _records(rng, [pool], 9, 32, 2000)
    engines = [query.DeviceQueryEngine(p, device="cpu", chunk=CHUNK) for _, p in pairs]
    batch = query.prepare_batch(records, 31, chunk=CHUNK)
    max_records = query._next_pow2(max(8, batch.num_records))
    inputs = [torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid)]
    got = query.multi_records_query_plain(
        [e.table for e in engines], [e.geometry() for e in engines], *inputs, max_records=max_records)
    jbatch = jax_query.prepare_batch(records, 31, chunk=CHUNK)
    for (jidx, idx), g in zip(pairs, got):
        want = jax_query.DeviceQueryEngine(jidx, chunk=CHUNK).count_hits(jbatch)
        np.testing.assert_array_equal(g.numpy()[: len(records)], want)
        np.testing.assert_array_equal(g.numpy()[: len(records)], _host(idx, records, 31))
    assert sum(int(g.sum()) for g in got[:3]) > 0


@pytest.mark.parametrize("num_classes", [40, 512, 1000])
def test_owned_block_plain_counts_sum_to_the_whole(wide_indices, num_classes):
    _, idx, genomes = wide_indices[num_classes, 7]
    rng = np.random.default_rng(num_classes)
    records = _records(rng, genomes, 9, 22, 400)
    batch = query.prepare_batch(records, 21, chunk=CHUNK)
    inputs = [torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid)]
    reads = torch.from_numpy(np.stack([g[:100] for g in genomes[:6]]))
    engine = query.DeviceQueryEngine(idx, device="cpu")
    geom = engine.geometry()
    whole3 = query.records_query_plain(*inputs, engine.table, max_records=16, **geom)
    whole2 = query.reads_query_plain(reads, engine.table, step=1, **geom)
    assert whole3.sum() > 0 and whole2.sum() > 0
    for n_blk in (2, 3, 4):
        local = -(-idx.num_blocks // n_blk)
        sum3, sum2 = torch.zeros_like(whole3), torch.zeros_like(whole2)
        for m in range(n_blk):
            shard = torch.from_numpy(blk_table_shard(idx, n_blk, m).view(np.int32))
            window = dict(local_blocks=local, block_offset=m * local)
            sum3 += query.records_query_plain(*inputs, shard, max_records=16, **geom, **window)
            sum2 += query.reads_query_plain(reads, shard, step=1, **geom, **window)
        torch.testing.assert_close(sum3, whole3, rtol=0, atol=0)
        torch.testing.assert_close(sum2, whole2, rtol=0, atol=0)
