"""Synthetic inputs and the forced-sync clock that the port's tools share.

:func:`build_index` and :func:`simulate_reads` are the port's copies of
``build_or_load_index`` and ``simulate_reads`` of the JAX package's
``bench.py``, with the same seeds (42 for the genomes, 7 for the reads),
class names and ``pick_num_hashes`` geometry, so both give the same
table and reads.  Nothing is cached: the index is built in memory at
every call.  :func:`random_table` draws a uint32 table as the JAX tools
draw theirs, and :func:`seconds_per_call` times a call as they do.
"""

import sys
import time

import numpy as np
import torch

from xspect2_tpu_torch import native
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex

READ_LEN = 150
K = 21


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def build_index(num_classes: int, genome_mb: float, seed: int = 42):
    """A synthetic multi-species index and its genomes, ``(index, genomes)``:
    ``num_classes`` random genomes of ``genome_mb`` Mbp, the probe count and
    field packing picked as the JAX bench picks them."""
    genome_len = int(genome_mb * 1e6)
    rng = np.random.default_rng(seed)
    genomes = rng.integers(0, 4, size=(num_classes, genome_len), dtype=np.uint8)
    index = BlockedBitSlicedIndex.create(
        K,
        [f"{1000 + i}" for i in range(num_classes)],
        genome_len - K + 1,
        fpr=0.01,
        num_hashes=None,
    )
    t0 = time.time()
    for ci in range(num_classes):
        if native.available():
            native.insert_kmers(index, ci, genomes[ci])
        else:
            hi, lo, valid = dna.canonical_kmers(genomes[ci], K)
            index.insert_kmers(ci, hi, lo, valid)
    log(
        f"index: {num_classes} classes x {genome_len} bp, h={index.num_hashes} "
        f"P={index.fields_per_word}, {index.nbytes / 1e6:.0f} MB, built in {time.time() - t0:.0f} s"
    )
    return index, genomes


def simulate_reads(genomes: np.ndarray, num_reads: int, seed: int = 7):
    """150 bp reads of random class, position and strand: ``(reads, cls)``;
    ~0.2% of them carry one N (255)."""
    rng = np.random.default_rng(seed)
    num_classes, genome_len = genomes.shape
    cls = rng.integers(0, num_classes, size=num_reads)
    pos = rng.integers(0, genome_len - READ_LEN, size=num_reads)
    idx = pos[:, None] + np.arange(READ_LEN)[None, :]
    reads = genomes[cls[:, None], idx]
    rc = rng.random(num_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    reads = reads.astype(np.uint8)
    bad = rng.random(num_reads) < 0.002
    reads[bad, rng.integers(0, READ_LEN, size=int(bad.sum()))] = 255
    return reads, cls


def random_table(rng: np.random.Generator, num_rows: int, row_words: int, device) -> torch.Tensor:
    """A uniformly random uint32 table drawn as the JAX tools draw it,
    on ``device`` as int32 (uint32 bits) [num_rows, row_words]."""
    words = rng.integers(0, 2**32, size=(num_rows, row_words), dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def seconds_per_call(fn, iters: int, device: torch.device):
    """``(seconds a call, the first call's result)``: one warm-up call,
    then ``iters`` calls on the host clock, stopped after the device
    has finished them."""
    cuda = device.type == "cuda"
    first = fn()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.time()
    for _ in range(iters):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    return (time.time() - t0) / iters, first
