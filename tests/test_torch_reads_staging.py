"""K2's thread blocks stage their reads' codes: the block geometry keeps every
block's windows inside the stage, and the read query's plain version stays
equal to the JAX package at the shapes the staging has to cover.

``ops.query._reads_block`` picks K2's windows per block and counter rows;
``_window_span`` bounds the flat positions a block's windows start at.
Both are held against a brute-force walk over every block start for a
sweep of read lengths (20-5000, multiples of 16 and not), k and step.
The kernel itself runs only on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``); here the plain version at read lengths that are not
multiples of 16, above the 2,048-position stage, and steps 1-5 equals the
JAX package's read query on the CPU.
"""

import itertools

import numpy as np
import pytest
import torch

from xspect2_tpu.core import dna as jax_dna
from xspect2_tpu.core.blocked_index import BlockedBitSlicedIndex as JaxIndex
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import convert
from xspect2_tpu_torch.ops import query

STAGE = query._WINDOWS_PER_BLOCK  # positions a block stages (kMaxBlockPositions)


def _positions(read_len, k, step, n_reads):
    """Flat start positions of every kept window of n_reads reads, read-major."""
    starts = np.arange(0, read_len - k + 1, step)
    return (np.arange(n_reads)[:, None] * read_len + starts[None, :]).reshape(-1), len(starts)


@pytest.mark.parametrize("read_len", [20, 31, 100, 149, 150, 151, 250, 301, 1000, 2047, 2048, 2049, 3001, 5000])
def test_block_geometry_keeps_every_block_inside_the_stage(read_len):
    for k, step, num_classes in itertools.product((5, 21, 31), (1, 2, 3, 4, 5, 17), (1, 8, 40, 512, 2730)):
        if read_len <= k:
            continue
        wpb, max_reads = query._reads_block(read_len, k, step, num_classes)
        nkk = -(-(read_len - k + 1) // step)
        pos, n = _positions(read_len, k, step, wpb // nkk + 3)
        assert n == nkk
        # every run of wpb consecutive kept windows, wherever it starts
        # within a read, starts its windows within the stage ...
        starts = np.arange(nkk)
        span = pos[starts + wpb - 1] - pos[starts]
        assert span.max() < STAGE, (read_len, k, step, num_classes, wpb)
        assert span.max() == query._window_span(wpb - 1, read_len, step, nkk)
        # ... and touches at most max_reads reads, whose counters fit
        reads = (starts + wpb - 1) // nkk - starts // nkk + 1
        assert reads.max() <= max_reads <= query._counter_rows(num_classes)
        # wpb is the largest such count below the counters' own cap
        cap = min(STAGE, (query._counter_rows(num_classes) - 2) * nkk + 1)
        assert wpb == cap or (pos[starts + wpb] - pos[starts]).max() >= STAGE


def test_window_span_equals_a_walk_over_the_positions():
    rng = np.random.default_rng(2)
    for _ in range(300):
        k = int(rng.integers(4, 33))
        read_len = int(rng.integers(k + 1, 400))
        step = int(rng.integers(1, 9))
        pos, nkk = _positions(read_len, k, step, 8)
        m = int(rng.integers(0, 3 * nkk))
        starts = np.arange(min(nkk, len(pos) - m))
        assert query._window_span(m, read_len, step, nkk) == int((pos[starts + m] - pos[starts]).max())


def test_a_read_longer_than_the_stage_spans_several_blocks():
    wpb, max_reads = query._reads_block(5000, 21, 1, 8)
    assert wpb == STAGE - 20 and max_reads == 2  # the k-1 windows a read boundary skips
    wpb, _ = query._reads_block(150, 21, 4, 1)
    assert query._window_span(wpb - 1, 150, 4, 33) < STAGE <= query._window_span(wpb, 150, 4, 33)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(8)
    genomes = [rng.integers(0, 4, size=6000, dtype=np.uint8) for _ in range(8)]
    jidx = JaxIndex.create(21, [f"c{i}" for i in range(8)], 6000, fpr=0.01, num_hashes=2)
    for ci, g in enumerate(genomes):
        jidx.insert_kmers(ci, *jax_dna.canonical_kmers(g, 21))
    return jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table), genomes


@pytest.mark.parametrize("read_len,step", [(133, 1), (133, 2), (157, 3), (250, 4), (99, 5), (2100, 1), (2100, 3)])
def test_plain_read_query_equals_jax_at_the_staging_shapes(index, read_len, step):
    jidx, idx, genomes = index
    rng = np.random.default_rng(read_len + step)
    n = 6
    reads = np.empty((n, read_len), dtype=np.uint8)
    for i in range(n):
        g = genomes[i % 8]
        at = int(rng.integers(0, len(g) - read_len))
        reads[i] = g[at : at + read_len] if i % 2 else 3 - g[at : at + read_len][::-1]
    reads[1, read_len // 3] = 255
    reads[4, [0, read_len - 1]] = 255
    want = jax_query.DeviceQueryEngine(jidx, chunk=512).count_hits_reads(reads, step=step, reads_per_chunk=8)
    got = query.DeviceQueryEngine(idx, device="cpu").count_hits_reads(reads, step=step, reads_per_chunk=8)
    np.testing.assert_array_equal(got, want)
    geom = dict(step=step, **query.DeviceQueryEngine(idx, device="cpu").geometry())
    plain = query.reads_query_plain(torch.from_numpy(reads), query.table_tensor(idx, "cpu"), **geom)
    np.testing.assert_array_equal(plain.numpy(), want)
    # each read's source class hits every kept window without an N
    nkk = -(-(read_len - 20) // step)
    assert (got[[0, 2, 3, 5]].max(axis=1) == nkk).all()
