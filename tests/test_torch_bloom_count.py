"""The position-based K7 (``csrc/bloom_count.cu``): its tiling, and its count
against the JAX package's.

The kernel stages a tile of consecutive k-mers' positions and validity
bytes in shared memory with 16-byte loads behind a scalar head and before
a scalar tail, walks the tiles with a persistent grid, and tests a
k-mer's probes in a first group and the rest (h up to the group width),
or in groups (h above it), its positions staged or, for very large h,
read in place.  A numpy model of that arithmetic, with the constants read
from the source, shows that every k-mer is evaluated once, that every
probe it reads is its own and is read once, and that the staged element
at each slot is the global one, at any 4-byte-aligned start of ``pos``
and any start of ``valid``.  The kernel itself runs on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``); here the port's
``count_hits_device`` (the plain version, on the CPU) is held exactly
against the JAX package's jitted ``count_hits_device`` and the host count.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from xspect2_tpu.core import compat as jax_compat
from xspect2_tpu_torch.core import compat, dna
from xspect2_tpu_torch.ops import bloom

K = 21
SOURCE = Path(bloom.__file__).resolve().parent.parent / "csrc" / "bloom_count.cu"


def _constants() -> dict:
    text = SOURCE.read_text(encoding="utf-8")
    assert "constexpr int kTile = kThreads * kPerThread;" in text
    c = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    c["kTile"] = c["kThreads"] * c["kPerThread"]
    return c


C = _constants()
T = C["kTile"]


def _stage(addr: int, count: int, size: int, capacity: int):
    """The global elements ``0..count-1`` of a span starting at byte
    ``addr`` (elements of ``size`` bytes) as ``stage`` places them in a
    16-byte aligned buffer of ``capacity`` elements: the offset and the
    buffer of global element indices (-1 where nothing was written)."""
    v = 16 // size
    off = (addr // size) & (v - 1)
    head = min(count, (v - off) & (v - 1))
    nvec = (count - head) // v
    tail = head + nvec * v
    assert head < C["kThreads"] and count - tail < C["kThreads"]  # one scalar a thread
    if nvec:  # the vectors are aligned on both sides
        assert (addr + head * size) % 16 == 0 and (off + head) % v == 0
    dst = np.full(capacity, -1, dtype=np.int64)
    writes = np.zeros(capacity, dtype=np.int64)
    for lo, hi in ((0, head), (head, tail), (tail, count)):  # scalar head, vectors, scalar tail
        np.add.at(writes, off + np.arange(lo, hi), 1)
        dst[off + np.arange(lo, hi)] = np.arange(lo, hi)
    assert writes.max(initial=0) <= 1 and (writes > 0).sum() == count
    return off, dst


def _model(n: int, h: int, pos_addr: int, valid_addr: int, grid: int):
    """How often each k-mer is evaluated and each probe position read."""
    kmer_seen = np.zeros(n, dtype=np.int64)
    probe_seen = np.zeros(n * h, dtype=np.int64)
    staged = h <= C["kMaxStaged"]
    pos_words = (T * h + 4 + 3) & ~3
    tiles = -(-n // T)
    for b in range(grid):
        for tile in range(b, tiles, grid):
            first = tile * T
            count = min(T, n - first)
            if staged:
                pos_off, s_pos = _stage(pos_addr + first * h * 4, count * h, 4, pos_words)
            valid_off, s_valid = _stage(valid_addr + first, count, 1, T + 16)
            i = np.arange(C["kThreads"])[:, None] + np.arange(C["kPerThread"])[None, :] * C["kThreads"]
            i = i[i < count]
            assert (s_valid[valid_off + i] == i).all()
            kmer_seen[first + i] += 1
            if h <= C["kGroup"]:
                f = C["kFirstProbes"] if 0 < C["kFirstProbes"] < h else h
                groups = [(0, f), (f, h)]
            else:
                groups = [(g, min(h, g + C["kGroup"])) for g in range(0, h, C["kGroup"])]
            for lo, hi in groups:
                j = np.arange(lo, hi)
                slot = i[:, None] * h + j[None, :]
                if staged:
                    assert (s_pos[pos_off + slot] == slot).all()  # the staged element is the global one
                np.add.at(probe_seen, (first * h + slot).ravel(), 1)
    return kmer_seen, probe_seen


@pytest.mark.parametrize("n", [0, 1, 3, T - 1, T, T + 1, 872_817])
@pytest.mark.parametrize("h", [1, 2, 7, 8, 9, 17])
def test_tiling_counts_every_kmer_once(n, h):
    """Every k-mer evaluated once, every probe of it read once, at base
    offsets of 0, 4, 8 and 12 bytes mod 16 (the head and the tail), over a
    persistent grid smaller and larger than the tile count."""
    for pos_mod, valid_mod in ((0, 0), (4, 5), (8, 11), (12, 15)):
        for grid in (1, 3, 1056) if n < 10 * T else (1056,):
            kmer_seen, probe_seen = _model(n, h, 4096 + pos_mod, 8192 + valid_mod, grid)
            assert (kmer_seen == 1).all() and (probe_seen == 1).all()


def test_tiling_reads_wide_rows_in_place():
    """Above kMaxStaged probes the positions are read in place, with no
    staging, and still once each; the staged tile of the largest staged h
    fits the block's shared memory (227 KB)."""
    h = C["kMaxStaged"] + 1
    kmer_seen, probe_seen = _model(2 * T + 5, h, 4100, 8193, 2)
    assert (kmer_seen == 1).all() and (probe_seen == 1).all()
    pos_words = (T * C["kMaxStaged"] + 4 + 3) & ~3
    assert pos_words * 4 + T + 16 <= 232_448


def test_tiling_model_counts_like_the_plain_version():
    """The count read through the model's staged slots equals
    ``bloom_count_plain`` at a base 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(3)
    n, h = 3 * T + 7, 7
    words = rng.integers(0, 2**32, size=257, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 257 * 32 + 40, size=(n, h), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.8
    flat = pos.ravel()
    count = 0
    for tile in range(-(-n // T)):
        first, c = tile * T, min(T, n - tile * T)
        off, s_pos = _stage(4 + first * h * 4, c * h, 4, (T * h + 7) & ~3)
        staged = np.where(s_pos >= 0, flat[first * h + np.maximum(s_pos, 0)], 0)
        for i in range(c):
            if valid[first + i]:
                p = staged[off + i * h : off + (i + 1) * h].astype(np.int64)
                inside = (p >> 5) < len(words)
                bits = (words[np.where(inside, p >> 5, 0)] >> (p & 31).astype(np.uint32)) & 1
                count += bool((bits.astype(bool) & inside).all())
    want = bloom.bloom_count_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(pos.view(np.int32)), torch.from_numpy(valid))
    assert count == int(want)


@pytest.mark.parametrize("fpr,h", [(0.5, 1), (0.01, 7), (2.0**-17, 17)])
def test_count_hits_device_matches_jax_and_host(fpr, h):
    """The port's ``count_hits_device`` equals the JAX package's and the
    host count, exactly, on members, non-members and sequences with N
    windows, at h = 1, 7 and 17."""
    rng = np.random.default_rng(h)
    genome = rng.integers(0, 4, size=6000, dtype=np.uint8)
    hi, lo, valid = dna.canonical_kmers(genome, K)
    jax_filter = jax_compat.XXH3BloomFilter.for_items(len(hi), fpr, K)
    filt = compat.XXH3BloomFilter.for_items(len(hi), fpr, K, device="cpu")
    assert filt.num_hashes == jax_filter.num_hashes == h
    jax_filter.insert_packed(hi, lo, valid)
    filt.insert_packed(hi, lo, valid)
    assert np.array_equal(filt.words, jax_filter.words)
    with_n = genome[1000:3000].copy()
    with_n[rng.integers(0, len(with_n), 12)] = 255
    probes = {
        "members": genome[:2500],
        "non-members": rng.integers(0, 4, size=2500, dtype=np.uint8),
        "N windows": with_n,
        "mixed": np.concatenate([genome[4000:5000], rng.integers(0, 4, size=1000, dtype=np.uint8)]),
    }
    for name, seq in probes.items():
        q = dna.canonical_kmers(seq, K)
        got = filt.count_hits_device(*q)
        assert got == jax_filter.count_hits_device(*q) == filt.count_hits_host(*q), name
        if name == "members":
            assert got == len(seq) - K + 1
        if name == "N windows":
            assert not q[2].all() and got <= int(q[2].sum())


@pytest.mark.parametrize("h", [1, 17])
def test_bloom_count_on_the_cpu_is_the_contract(h):
    """On CPU tensors ``bloom_count`` is its plain version and launches
    nothing; its count is the contract's, stated in numpy: the valid
    k-mers whose h probe bits are all set, a position past the filter a
    miss, on a ``pos`` view 4 bytes past its buffer's start, with bool or
    uint8 validity, and zero at n = 0."""
    rng = np.random.default_rng(40 + h)
    n = 2000
    words = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint64).astype(np.uint32)
    words = words[0] | words[1] | words[2]  # 7 of 8 bits set, so some k-mers hit at h = 17
    buf = rng.integers(0, 64 * 32 + 64, size=n * h + 1, dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.8
    p = buf[1:].reshape(n, h).astype(np.int64)
    inside = (p >> 5) < len(words)
    bits = (words[np.where(inside, p >> 5, 0)].astype(np.int64) >> (p & 31)) & 1
    want = int(((bits == 1) & inside).all(axis=1)[valid].sum())
    assert 0 < want < int(valid.sum())
    w = torch.from_numpy(words.view(np.int32))
    pos = torch.from_numpy(buf.view(np.int32))[1:].view(n, h)
    before = bloom.bloom_count.launches
    for v in (torch.from_numpy(valid), torch.from_numpy(valid.astype(np.uint8))):
        got = bloom.bloom_count(w, pos, v)
        assert got.dtype == torch.int32 and got.shape == (1,) and int(got) == want
    empty = bloom.bloom_count(w, pos[:0], torch.zeros(0, dtype=torch.bool))
    assert int(empty) == 0 and bloom.bloom_count.launches == before
