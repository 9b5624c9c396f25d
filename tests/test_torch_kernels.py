"""The port's CUDA kernels equal their plain PyTorch versions on the card.

These tests need a CUDA card and skip without one.  They import neither
JAX nor the JAX package, so on a machine without JAX they run with
``python -m pytest -p no:cacheprovider --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.ops import query

# (classes, num_hashes): field-packed C=8 (P=4), C=1 (P=32), 2 class
# words, 16 class words
GEOMETRIES = {"c8_p4_h2": (8, 2), "c1_p32_h3": (1, 3), "c40_cw2_h7": (40, 7), "c512_cw16_h3": (512, 3)}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _index(num_classes, num_hashes, rng, length=3000):
    genomes = [rng.integers(0, 4, size=length, dtype=np.uint8) for _ in range(num_classes)]
    idx = BlockedBitSlicedIndex.create(
        21, [f"c{i}" for i in range(num_classes)], length, num_hashes=num_hashes
    )
    for ci, g in enumerate(genomes):
        hi, lo, v = dna.canonical_kmers(g, 21)
        idx.insert_kmers(ci, hi, lo, v)
    return idx, genomes


def _reads(rng, genomes, n, read_len):
    out = np.empty((n, read_len), dtype=np.uint8)
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        s = int(rng.integers(0, len(g) - read_len))
        out[i] = g[s : s + read_len] if i % 2 else 3 - g[s : s + read_len][::-1]
    out[rng.integers(0, n, n // 20), rng.integers(0, read_len, n // 20)] = 255
    return out


def _patch_lists(wire, rng):
    """The ascending list ``pack_reads_wire`` emits and the lists K1 must
    take in any order: ``(name, rows, cols, kernel launches)``."""
    rows, cols = wire[1], wire[2]
    perm = torch.from_numpy(rng.permutation(rows.numel())).to(rows.device)
    sentinel = query.upload_patch_list(np.full(8, wire[0].shape[0], dtype=np.int32), rows.device)
    return [("ascending", rows, cols, 1), ("shuffled", rows[perm], cols[perm], 2),
            ("empty", rows[:0], cols[:0], 1), ("sentinels only", sentinel, torch.zeros_like(sentinel), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("read_len", [5, 15, 31, 100, 150, 300, 301, 8193, 10001])
def test_unpack_kernel_matches_plain(cuda_device, read_len):
    """K1 equals its plain version on ``pack_reads_wire``'s list (one launch, the
    patches inside it) and on a shuffled, an empty and a sentinel-only
    list (a shuffled list takes the patch-only launch as well): reads
    shorter than 16 bases (the codes built with a running column), of
    lengths not a multiple of 4 or 16, and longer than the 8,192-code
    tile (every tile starting and ending inside a row)."""
    rng = np.random.default_rng(read_len)
    k = 21 if read_len > 21 else read_len - 2  # the padding rows are poisoned every k bases
    reads = rng.integers(0, 4, size=(1000, read_len), dtype=np.uint8)
    reads[rng.integers(0, 1000, 50), rng.integers(0, read_len, 50)] = 255
    reads[7, :] = 255  # a read of N only
    wire = query.wire_to_device(query.pack_reads_wire(reads, k, 1024), cuda_device)
    assert int((wire[1] >= 1024).sum()) > 0  # sentinel entries are present
    for name, rows, cols, launches in _patch_lists(wire, rng):
        before = query.unpack_2bit.launches
        got = query.unpack_2bit(wire[0], rows, cols, read_len)
        assert query.unpack_2bit.launches == before + launches, name
        torch.testing.assert_close(got, query.unpack_2bit_plain(wire[0], rows, cols, read_len), rtol=0, atol=0)


@pytest.mark.cuda
def test_unpack_kernel_at_the_species_reads_shape(cuda_device):
    """K1 at the main path's shape: 401,408 rows of 150 bases, the padding
    rows poisoned, 16,384 patch entries with the sentinels; one launch."""
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, size=(400_000, 150), dtype=np.uint8)
    bad = rng.random(400_000) < 0.002
    reads[bad, rng.integers(0, 150, size=int(bad.sum()))] = 255
    wire = query.wire_to_device(query.pack_reads_wire(reads, 21, 401_408), cuda_device)
    assert wire[1].numel() == 16_384
    before = query.unpack_2bit.launches
    got = query.unpack_2bit(*wire, 150)
    assert query.unpack_2bit.launches == before + 1
    torch.testing.assert_close(got, query.unpack_2bit_plain(*wire, 150), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("read_len,step", [(150, 1), (150, 2), (300, 4)])
def test_read_query_kernel_matches_plain_and_host(cuda_device, name, read_len, step):
    rng = np.random.default_rng(read_len + step)
    idx, genomes = _index(*GEOMETRIES[name], rng)
    reads = _reads(rng, genomes, 700, read_len)
    engine = query.DeviceQueryEngine(idx, device=cuda_device)
    codes = torch.from_numpy(reads).to(cuda_device)
    before = query.reads_query.launches
    got = query.reads_query(codes, engine.table, step=step, **engine.geometry())
    assert query.reads_query.launches == before + 1
    want = query.reads_query_plain(codes, engine.table, step=step, **engine.geometry())
    torch.testing.assert_close(got.long(), want.long(), rtol=0, atol=0)
    host = []
    for r in reads[:50]:
        hi, lo, valid = dna.canonical_kmers(r, 21, step=step)
        host.append(idx.count_hits_host(hi, lo, valid))
    np.testing.assert_array_equal(engine.count_hits_reads(reads[:50], step=step), np.stack(host))


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_bad_input(cuda_device):
    idx, _ = _index(8, 2, np.random.default_rng(0), length=500)
    engine = query.DeviceQueryEngine(idx, device=cuda_device)
    codes = torch.zeros((4, 150), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        query.reads_query(codes, engine.table, step=1, **engine.geometry())
    with pytest.raises(ValueError):
        query.reads_query(codes.to(torch.uint8), engine.table.cpu(), step=1, **engine.geometry())


def _records(rng, genomes, n, lo, hi, k=21):
    """Records of lengths in [lo, hi) from random classes, some with an N,
    half reverse-complemented."""
    out = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        length = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(g) - length))
        c = g[s : s + length].copy()
        if i % 2:
            c = 3 - c[::-1]
        if i % 3 == 0:
            c[int(rng.integers(0, length))] = 255
        out.append((f"r{i}", np.ascontiguousarray(c)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("num_records,step", [(1, 1), (9, 3), (300, 1)])
def test_records_wire_kernel_matches_plain(cuda_device, num_records, step):
    rng = np.random.default_rng(num_records + step)
    genomes = [rng.integers(0, 4, size=5000, dtype=np.uint8)]
    batch = query.prepare_batch(_records(rng, genomes, num_records, 22, 400), 21, step=step, chunk=8192)
    max_records = query._next_pow2(max(8, batch.num_records))
    _, _, offsets = query.packed_wire_for_batch(batch, max_records)
    offsets = torch.from_numpy(offsets).to(cuda_device)
    before = query.records_wire.launches
    rec, valid = query.records_wire(offsets, batch.num_positions, k=21, step=step)
    assert query.records_wire.launches == before + 1
    want_rec, want_valid = query.records_wire_plain(offsets, batch.num_positions, k=21, step=step)
    torch.testing.assert_close(rec, want_rec, rtol=0, atol=0)
    assert torch.equal(valid, want_valid)
    np.testing.assert_array_equal(valid.cpu().numpy(), batch.valid)


def _assembly(rng, length=4_000_000, contigs=86):
    """A 4 Mbp draft assembly: long-tailed contig lengths, a few N runs."""
    genome = rng.integers(0, 4, size=length, dtype=np.uint8)
    cuts = np.sort(rng.choice(np.arange(300, length - 300), contigs - 1, replace=False))
    out = []
    for i, c in enumerate(np.split(genome, cuts)):
        c = c.copy()
        if i % 10 == 0 and len(c) > 500:
            c[200:300] = 255
        out.append((f"c{i}", c))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["4 Mbp assembly", "65,536 short records"])
@pytest.mark.parametrize("step", [1, 4])
def test_restore_records_wire_kernel_matches_plain(cuda_device, shape, step):
    """K4 restores codes, record ids and validity in one launch on the
    ascending list of ``packed_wire_for_batch``, and equals its plain
    version there and on a shuffled (one more, patch-only launch), an empty
    and a sentinel-only list: on the flat wire of one 4 Mbp assembly and of
    65,536 short records, with max_records padded by empty records."""
    rng = np.random.default_rng(step)
    if shape == "4 Mbp assembly":
        records = _assembly(rng)
    else:
        genome = rng.integers(0, 4, size=200_000, dtype=np.uint8)
        records = _records(rng, [genome], 65_536, 22, 120)
    batch = query.prepare_batch(records, 21, step=step)
    max_records = query._next_pow2(max(8, batch.num_records)) * 2  # empty records past the real ones
    packed, bad_pos, offsets = query.upload_records_wire(batch, max_records, cuda_device)
    n_pos, n_tot = batch.num_positions, len(batch.codes)
    perm = torch.from_numpy(rng.permutation(bad_pos.numel())).to(cuda_device)
    sentinel = query.upload_patch_list(np.full(8, n_tot, dtype=np.int32), cuda_device)
    for name, patches, launches in (("ascending", bad_pos, 1), ("shuffled", bad_pos[perm], 2),
                                    ("empty", bad_pos[:0], 1), ("sentinels only", sentinel, 1)):
        before = query.records_wire.launches, query.unpack_2bit.launches
        got = query.restore_records_wire(packed, patches, offsets, n_pos, k=21, step=step)
        assert (query.records_wire.launches - before[0], query.unpack_2bit.launches - before[1]) == (
            launches, 0), name
        want = query.restore_records_wire_plain(packed, patches, offsets, n_pos, k=21, step=step)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    codes, rec, valid = query.restore_records_wire(packed, bad_pos, offsets, n_pos, k=21, step=step)
    real = int(batch.offsets[-1])  # the padding past it is not patched: no valid window reads it
    np.testing.assert_array_equal(codes[:real].cpu().numpy(), batch.codes[:real])
    np.testing.assert_array_equal(valid.cpu().numpy(), batch.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["55,925 reads padded to 65,536", "ends on a tile edge", "no empty record"])
@pytest.mark.parametrize("step", [1, 4])
def test_records_wire_kernel_past_empty_records(cuda_device, shape, step):
    """K4 at many short records with ``max_records`` padded by empty
    records (the first batch of a validated run: 55,925 reads of 150 bp
    in 65,536 record slots), at a batch whose last base ends a 4,096-position
    tile, and at one with no empty record: exact against its plain version,
    the positions past the last real base in record ``max_records - 1``."""
    rng = np.random.default_rng(step)
    n_real, read_len, max_records, chunk = {
        "55,925 reads padded to 65,536": (55_925, 150, 65_536, query.DEFAULT_CHUNK),
        "ends on a tile edge": (64, 256, 128, 4096),
        "no empty record": (8_192, 150, 8_192, query.DEFAULT_CHUNK),
    }[shape]
    genome = rng.integers(0, 4, size=400_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - read_len, size=n_real)
    records = [(f"r{i}", genome[s : s + read_len]) for i, s in enumerate(starts)]
    batch = query.prepare_batch(records, 21, step=step, chunk=chunk)
    real = int(batch.offsets[-1])
    if shape == "ends on a tile edge":
        assert real % 4096 == 0 and batch.num_positions == real
    packed, bad_pos, offsets = query.upload_records_wire(batch, max_records, cuda_device)
    n_pos = batch.num_positions
    for wire in ((packed, bad_pos, offsets), (None, None, offsets)):
        before = query.records_wire.launches
        if wire[0] is None:
            got = query.records_wire(offsets, n_pos, k=21, step=step)
            want = query.records_wire_plain(offsets, n_pos, k=21, step=step)
        else:
            got = query.restore_records_wire(*wire, n_pos, k=21, step=step)
            want = query.restore_records_wire_plain(*wire, n_pos, k=21, step=step)
        assert query.records_wire.launches == before + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    rec = got[0].cpu().numpy()
    assert (rec[real:] == max_records - 1).all()
    np.testing.assert_array_equal(rec[:real], np.repeat(np.arange(n_real), read_len))
    np.testing.assert_array_equal(got[1].cpu().numpy(), batch.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("step", [1, 3])
def test_records_query_kernel_matches_plain_and_host(cuda_device, name, step):
    rng = np.random.default_rng(len(name) + step)
    idx, genomes = _index(*GEOMETRIES[name], rng)
    records = _records(rng, genomes, 40, 22, 2500)
    engine = query.DeviceQueryEngine(idx, device=cuda_device, chunk=8192)
    batch = query.prepare_batch(records, 21, step=step, chunk=engine.chunk)
    max_records = query._next_pow2(max(8, batch.num_records))
    geom = dict(max_records=max_records, **engine.geometry())
    codes, rec_ids, valid = (torch.from_numpy(a).to(cuda_device) for a in (batch.codes, batch.rec_ids, batch.valid))
    before = query.records_query.launches
    got = query.records_query(codes, rec_ids, valid, engine.table, min_record_len=22, **geom)
    assert query.records_query.launches == before + 1
    want = query.records_query_plain(codes, rec_ids, valid, engine.table, **geom)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    host = np.stack([idx.count_hits_host(*dna.canonical_kmers(c, 21, step=step)) for _, c in records])
    for wire in ("packed", "raw"):
        np.testing.assert_array_equal(engine.count_hits(batch, wire=wire), host)


@pytest.mark.cuda
def test_records_query_counts_in_global_memory_when_a_span_does_not_fit(cuda_device):
    """A wrong shortest-record hint gives blocks spans wider than their
    shared counters: those blocks count with global atomics, exactly."""
    rng = np.random.default_rng(1)
    idx, genomes = _index(512, 3, rng, length=600)
    records = _records(rng, genomes, 200, 22, 40)
    batch = query.prepare_batch(records, 21, chunk=8192)
    engine = query.DeviceQueryEngine(idx, device=cuda_device)
    geom = dict(max_records=256, **engine.geometry())
    codes, rec_ids, valid = (torch.from_numpy(a).to(cuda_device) for a in (batch.codes, batch.rec_ids, batch.valid))
    got = query.records_query(codes, rec_ids, valid, engine.table, min_record_len=10**6, **geom)
    want = query.records_query_plain(codes, rec_ids, valid, engine.table, **geom)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(got.sum()) > 0


# K5's tables: field-packed C=4, two class words, 32 class words
MULTI_GEOMETRIES = [(4, 2), (40, 7), (1000, 1)]


def _multi_case(rng, cuda_device, num_records, lo, hi):
    indices, genomes = [], []
    for num_classes, h in MULTI_GEOMETRIES:
        idx, g = _index(num_classes, h, rng, length=600)
        indices.append(idx)
        genomes += g[:3]
    engines = [query.DeviceQueryEngine(idx, device=cuda_device, chunk=8192) for idx in indices]
    records = _records(rng, genomes, num_records, lo, hi)
    batch = query.prepare_batch(records, 21, chunk=8192)
    max_records = query._next_pow2(max(8, batch.num_records))
    inputs = [torch.from_numpy(a).to(cuda_device) for a in (batch.codes, batch.rec_ids, batch.valid)]
    return indices, engines, records, batch, max_records, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("num_records,lo,hi,hint", [(1, 400, 500, None), (5, 22, 500, 22), (300, 22, 600, 100), (300, 22, 40, 10**6)])
def test_multi_records_query_kernel_matches_plain_and_single(cuda_device, num_records, lo, hi, hint):
    """K5 over tables of three geometries, one launch for each probe
    path, equals its plain version, K3 per table and the host; a wrong
    record-length hint sends blocks to the global-atomic path and changes
    nothing."""
    rng = np.random.default_rng(num_records + lo)
    indices, engines, records, batch, max_records, inputs = _multi_case(rng, cuda_device, num_records, lo, hi)
    tables = [e.table for e in engines]
    geoms = [e.geometry() for e in engines]
    before = query.multi_records_query.launches
    got = query.multi_records_query(tables, geoms, *inputs, max_records=max_records, min_record_len=hint)
    assert query.multi_records_query.launches == before + len({query._probe_kind(g) for g in geoms})
    want = query.multi_records_query_plain(tables, geoms, *inputs, max_records=max_records)
    for idx, e, g, w in zip(indices, engines, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        single = query.records_query(*inputs, e.table, max_records=max_records, **e.geometry())
        torch.testing.assert_close(g, single, rtol=0, atol=0)
        host = np.stack([idx.count_hits_host(*dna.canonical_kmers(c, 21)) for _, c in records])
        np.testing.assert_array_equal(g[: len(records)].cpu().numpy(), host)
    assert sum(int(g.sum()) for g in got) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(query.REDUCE_MODES))
@pytest.mark.parametrize("threshold", [50, -1])
@pytest.mark.parametrize("max_records", [8, 256])
def test_reduce_kernel_matches_plain(cuda_device, mode, threshold, max_records):
    rng = np.random.default_rng(max_records + threshold)
    counts = [
        torch.from_numpy(rng.integers(0, 120, size=(max_records, c), dtype=np.int32)).to(cuda_device)
        for c in (4, 40, 1000)
    ]
    seg = np.sort(rng.integers(0, 5, size=max_records)).astype(np.int32)
    seg[rng.integers(0, max_records, 2)] = [-1, 7]  # outside [0, 5): add nothing
    seg_ids = torch.from_numpy(seg).to(cuda_device)
    before = query.reduce_record_counts.launches
    got = query.reduce_record_counts(counts, mode, threshold, seg_ids, 5)
    assert query.reduce_record_counts.launches == before + 1
    want = query.reduce_record_counts_plain(counts, mode, threshold, seg_ids, 5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_multi_packed_query_launches_each_kernel_once(cuda_device):
    """One fused call on ``packed_wire_for_batch``'s list: K4 once (codes, record ids
    and validity), K1 never, K5 once for each probe path among the tables
    (three here), K6 once."""
    rng = np.random.default_rng(3)
    indices, engines, records, batch, max_records, _ = _multi_case(rng, cuda_device, 20, 100, 600)
    wire = engines[0].upload_records_wire(batch, max_records)
    seg = np.zeros(max_records, dtype=np.int32)
    seg[: len(records)] = np.arange(len(records)) // 7
    fused = query.make_multi_packed_query(
        [e.geometry() for e in engines], 1, batch.num_positions,
        reduce_mode="thresholded_segment_totals", threshold=-1, num_segments=3,
    )
    names = ("unpack_2bit", "records_wire", "multi_records_query", "reduce_record_counts")
    before = {n: getattr(query, n).launches for n in names}
    outs = fused([e.table for e in engines], *wire, torch.from_numpy(seg).to(cuda_device))
    paths = len({query._probe_kind(e.geometry()) for e in engines})
    assert paths == 3
    assert {n: getattr(query, n).launches - before[n] for n in names} == {**dict.fromkeys(names, 1),
                                                                          "unpack_2bit": 0,
                                                                          "multi_records_query": paths}
    for idx, out in zip(indices, outs):
        host = np.stack([idx.count_hits_host(*dna.canonical_kmers(c, 21)) for _, c in records])
        want = np.stack([host[seg[: len(records)] == s].sum(axis=0) for s in range(3)])
        np.testing.assert_array_equal(out.cpu().numpy(), want)


def _bloom_tile() -> int:
    """K7's tile (k-mers a block stages at once), from ``csrc/bloom_count.cu``."""
    import re
    from pathlib import Path

    text = (Path(query.__file__).resolve().parent.parent / "csrc" / "bloom_count.cu").read_text(encoding="utf-8")
    c = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    return c["kThreads"] * c["kPerThread"]


@pytest.mark.cuda
@pytest.mark.parametrize("n_case", ["0", "1", "T-1", "T", "T+1", "100000"])
@pytest.mark.parametrize("fpr,h", [(0.5, 1), (0.01, 7), (2.0**-17, 17)])
def test_bloom_count_kernel_matches_plain_and_host(cuda_device, n_case, fpr, h):
    """The position-based K7 through ``count_hits_device`` and on its own, at
    h = 1, 7 and 17, at n on the tile's edges and n = 0, on members and
    non-members, and on a ``pos`` view 4 bytes past an aligned start: one
    launch a call (none at n = 0), the count exact against the plain
    version and the host."""
    from xspect2_tpu_torch.core import compat
    from xspect2_tpu_torch.ops import bloom

    t = _bloom_tile()
    n = {"0": 0, "1": 1, "T-1": t - 1, "T": t, "T+1": t + 1, "100000": 100_000}[n_case]
    rng = np.random.default_rng(n + h)
    genome = rng.integers(0, 4, size=max(20_000, n + 20), dtype=np.uint8)
    filt = compat.XXH3BloomFilter.for_items(len(genome) - 20, fpr, 21, device=cuda_device)
    assert filt.num_hashes == h
    filt.insert_packed(*dna.canonical_kmers(genome, 21))
    words = filt.device_words()
    members = genome[: n + 20]
    non_members = rng.integers(0, 4, size=n + 20, dtype=np.uint8)
    for name, probe in (("members", members), ("non-members", non_members)):
        probe = probe.copy()
        if n > 3:
            probe[rng.integers(0, len(probe), 3)] = 255
        hi, lo, valid = dna.canonical_kmers(probe, 21)
        assert len(hi) == n
        launches = 1 if n else 0
        before = bloom.bloom_count.launches
        got = filt.count_hits_device(hi, lo, valid)
        assert bloom.bloom_count.launches == before + launches, name
        assert got == filt.count_hits_host(hi, lo, valid), name
        if name == "members" and n:
            assert got == int(valid.sum()), name
        pos = filt._positions(hi, lo, valid).astype(np.uint32).view(np.int32)
        flat = torch.zeros(pos.size + 1, dtype=torch.int32, device=cuda_device)
        flat[1:] = torch.from_numpy(pos.ravel()).to(cuda_device)
        view = flat[1:].view(pos.shape)
        assert view.data_ptr() % 16 == 4 or not n
        mask = torch.from_numpy(valid).to(cuda_device)
        before = bloom.bloom_count.launches
        assert int(bloom.bloom_count(words, view, mask)) == got, name
        assert bloom.bloom_count.launches == before + launches, name
        assert int(bloom.bloom_count_plain(words, view, mask)) == got, name
    if n:  # a position past the filter is a miss on both
        view[0, 0] = -1
        mask[0] = True
        assert int(bloom.bloom_count(words, view, mask)) == int(bloom.bloom_count_plain(words, view, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [9, 120])
def test_bloom_count_kernel_groups_and_wide_rows(cuda_device, h):
    """h above the first group's width takes the group loop; above the
    staged limit the positions are read in place; the valid mask at an odd
    offset: one launch, the count exact against the plain version."""
    from xspect2_tpu_torch.ops import bloom

    g = torch.Generator(device=cuda_device).manual_seed(h)
    words = torch.randint(-2**31, 2**31 - 1, (1 << 12,), dtype=torch.int32, device=cuda_device, generator=g)
    for _ in range(5):  # bits set w.p. 63/64, so that some k-mers hit all probes
        words |= torch.randint(-2**31, 2**31 - 1, (1 << 12,), dtype=torch.int32, device=cuda_device, generator=g)
    n = 3 * _bloom_tile() + 5
    pos = torch.randint(0, (32 << 12) + 100, (n, h), dtype=torch.int32, device=cuda_device, generator=g)
    valid = (torch.rand(n + 3, device=cuda_device, generator=g) < 0.9)[3:]
    before = bloom.bloom_count.launches
    got = int(bloom.bloom_count(words, pos, valid))
    assert bloom.bloom_count.launches == before + 1
    want = int(bloom.bloom_count_plain(words, pos, valid))
    assert got == want and want > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 8, 12, 16, 21, 31, 32])
@pytest.mark.parametrize("hint", [None, 10**6])
def test_xxh3_records_kernel_matches_plain_and_host(cuda_device, k, hint):
    """The new K7 hashes on the card: its per-record counts equal its plain
    version and ``count_hits_host`` at every XXH3 length path and 16-base
    word boundary, on the shared-counter path (hint: the shortest record)
    and the global-atomic path (hint 10**6), one launch a batch."""
    from xspect2_tpu_torch.core import compat
    from xspect2_tpu_torch.ops import bloom

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, size=30_000, dtype=np.uint8)
    filt = compat.XXH3BloomFilter.for_items(len(genome), 0.01, k, device=cuda_device)
    filt.insert_packed(*dna.canonical_kmers(genome, k))
    records = _records(rng, [genome], 900, k + 1, 400, k=k) + _records(rng, [genome], 3, 5000, 9000, k=k)
    records.append(("random", rng.integers(0, 4, size=3000, dtype=np.uint8)))
    batch = query.prepare_batch(records, k, chunk=1 << 16)
    max_records = query._next_pow2(max(8, batch.num_records))
    wire = query.upload_records_wire(batch, max_records, cuda_device)
    codes, rec_ids, valid = query.restore_records_wire(*wire, batch.num_positions, k=k, step=1)
    geom = dict(max_records=max_records, k=k, num_bits=filt.num_bits, num_hashes=filt.num_hashes)
    words = filt.device_words()
    before = bloom.xxh3_records_count.launches
    got = bloom.xxh3_records_count(words, codes, rec_ids, valid, min_record_len=hint or k + 1, **geom)
    assert bloom.xxh3_records_count.launches == before + 1
    want = bloom.xxh3_records_count_plain(words, codes, rec_ids, valid, **geom)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    host = [filt.count_hits_host(*dna.canonical_kmers(c, k)) for _, c in records]
    np.testing.assert_array_equal(got[: len(records)].cpu().numpy(), host)
    if k >= 12:  # a random record hits by false positives only (at k < 12 the genome holds most k-mers)
        assert 0 < int(got[len(records) - 1]) < 3000 - k


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 4])
def test_xxh3_genus_model_launches_once_per_record_batch(cuda_device, tmp_path, step):
    from xspect2_tpu_torch.io.fasta import SeqRecord
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
    from xspect2_tpu_torch.ops import bloom

    rng = np.random.default_rng(step)
    genome = rng.integers(0, 4, size=50_000, dtype=np.uint8)
    (tmp_path / "g.fasta").write_text(">g\n" + dna.decode(genome) + "\n", encoding="utf-8")
    model = ProbabilisticSingleFilterModel(21, "X", None, None, "Genus", tmp_path, hash_family="xxh3",
                                           device=cuda_device)
    model.fit(tmp_path / "g.fasta", "X g")
    recs = [SeqRecord(dna.decode(genome[i * 400 : i * 400 + 150 + i]), id=f"r{i}") for i in range(100)]
    before = bloom.xxh3_records_count.launches, bloom.bloom_count.launches
    res = model.predict(recs, step=step)
    assert (bloom.xxh3_records_count.launches, bloom.bloom_count.launches) == (before[0] + 1, before[1])
    for i in (0, 57, 99):
        assert res.hits[f"r{i}"] == {"g": -(-(150 + i - 20) // step)}


# ------------------------------------------------------------------ owned-block mode, K8


def _block_shards(idx, n_blk, device):
    from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard

    local_blocks = -(-idx.num_blocks // n_blk)
    tables = [
        torch.from_numpy(blk_table_shard(idx, n_blk, m).view(np.int32)).to(device) for m in range(n_blk)
    ]
    return local_blocks, tables


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("n_blk,step", [(2, 1), (3, 3), (4, 1)])
def test_read_query_kernel_owned_block_mode_matches_plain_and_sums_to_the_whole(cuda_device, name, n_blk, step):
    """K2 on each block shard equals its plain version, and the shards'
    partial counts sum to the unsharded kernel's."""
    rng = np.random.default_rng(n_blk + step)
    idx, genomes = _index(*GEOMETRIES[name], rng)
    reads = _reads(rng, genomes, 500, 150)
    engine = query.DeviceQueryEngine(idx, device=cuda_device)
    codes = torch.from_numpy(reads).to(cuda_device)
    geom = dict(step=step, **engine.geometry())
    whole = query.reads_query(codes, engine.table, **geom).long()
    local_blocks, tables = _block_shards(idx, n_blk, cuda_device)
    total = torch.zeros_like(whole)
    for m, table in enumerate(tables):
        window = dict(local_blocks=local_blocks, block_offset=m * local_blocks)
        before = query.reads_query.launches
        got = query.reads_query(codes, table, **geom, **window).long()
        assert query.reads_query.launches == before + 1
        want = query.reads_query_plain(codes, table, **geom, **window).long()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        total += got
    torch.testing.assert_close(total, whole, rtol=0, atol=0)
    assert int(whole.sum()) > 0

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("read_len", [37, 133, 151, 2100, 5003])
def test_read_query_kernel_on_staged_codes_at_the_edge_shapes(cuda_device, name, read_len):
    """K2 on staged codes equals its plain version at read lengths that are
    not multiples of 16 and above the 2,048-position stage, at steps 1-5,
    on the whole table and in owned-block mode (every probe path)."""
    rng = np.random.default_rng(read_len)
    idx, genomes = _index(*GEOMETRIES[name], rng, length=12_000)
    reads = _reads(rng, genomes, 3000 if read_len < 1000 else 40, read_len)
    reads[-3:, ::21] = 255  # poisoned like padding rows: count nothing
    engine = query.DeviceQueryEngine(idx, device=cuda_device)
    codes = torch.from_numpy(reads).to(cuda_device)
    local_blocks, tables = _block_shards(idx, 2, cuda_device)
    for step in (1, 2, 3, 4, 5):
        geom = dict(step=step, **engine.geometry())
        got = query.reads_query(codes, engine.table, **geom).long()
        torch.testing.assert_close(got, query.reads_query_plain(codes, engine.table, **geom).long(), rtol=0, atol=0)
        assert int(got[-3:].sum()) == 0 and int(got.sum()) > 0
        total = torch.zeros_like(got)
        for m, table in enumerate(tables):
            window = dict(local_blocks=local_blocks, block_offset=m * local_blocks)
            part = query.reads_query(codes, table, **geom, **window).long()
            torch.testing.assert_close(part, query.reads_query_plain(codes, table, **geom, **window).long(),
                                       rtol=0, atol=0)
            total += part
        torch.testing.assert_close(total, got, rtol=0, atol=0)



@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("n_blk,step,hint", [(2, 1, 22), (3, 3, 22), (4, 1, 10**6)])
def test_records_query_kernel_owned_block_mode_matches_plain_and_sums_to_the_whole(
    cuda_device, name, n_blk, step, hint
):
    """K3 on each block shard equals its plain version on the shared and
    (with a wrong record-length hint) the global-atomic path, and the
    shards' partial counts sum to the unsharded kernel's."""
    rng = np.random.default_rng(n_blk * 10 + step)
    idx, genomes = _index(*GEOMETRIES[name], rng)
    records = _records(rng, genomes, 60, 22, 1200)
    engine = query.DeviceQueryEngine(idx, device=cuda_device, chunk=8192)
    batch = query.prepare_batch(records, 21, step=step, chunk=engine.chunk)
    max_records = query._next_pow2(max(8, batch.num_records))
    geom = dict(max_records=max_records, **engine.geometry())
    inputs = [torch.from_numpy(a).to(cuda_device) for a in (batch.codes, batch.rec_ids, batch.valid)]
    whole = query.records_query(*inputs, engine.table, min_record_len=22, **geom)
    local_blocks, tables = _block_shards(idx, n_blk, cuda_device)
    total = torch.zeros_like(whole)
    for m, table in enumerate(tables):
        window = dict(local_blocks=local_blocks, block_offset=m * local_blocks)
        got = query.records_query(*inputs, table, min_record_len=hint, **geom, **window)
        want = query.records_query_plain(*inputs, table, **geom, **window)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        total += got
    torch.testing.assert_close(total, whole, rtol=0, atol=0)
    assert int(whole.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("class_words", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("num_kmers", [1, 13, 4099])
def test_probe_select_kernel_matches_plain(cuda_device, class_words, num_kmers):
    from xspect2_tpu_torch.ops.probe_select import probe_select, probe_select_plain

    rng = np.random.default_rng(class_words * 100 + num_kmers)
    rpb = 128 // class_words
    blocks = torch.from_numpy(
        rng.integers(0, 2**32, size=(num_kmers, 128), dtype=np.uint64).astype(np.uint32).view(np.int32)
    ).to(cuda_device)
    sel = rng.integers(0, 2**32, size=(num_kmers, max(1, rpb // 32)), dtype=np.uint64)
    sel &= rng.integers(0, 2**32, size=sel.shape, dtype=np.uint64)  # about a quarter of the rows
    if rpb < 32:
        sel &= (1 << rpb) - 1
    sel[0] = 0  # no row selected: all-ones words
    selbits = torch.from_numpy(sel.astype(np.uint32).view(np.int32)).to(cuda_device)
    before = probe_select.launches
    got = probe_select(selbits, blocks, rows_per_block=rpb, class_words=class_words)
    assert probe_select.launches == before + 1
    want = probe_select_plain(selbits, blocks, rows_per_block=rpb, class_words=class_words)
    assert got.shape == (num_kmers, class_words) and got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got[0] == -1).all())
    with pytest.raises(ValueError):
        probe_select(selbits, blocks, rows_per_block=rpb, class_words=class_words * 2)


@pytest.mark.cuda
def test_microbench_probe_pipeline_equals_reads_query_on_the_card(cuda_device, capsys):
    from xspect2_tpu_torch.ops.probe_select import probe_select
    from xspect2_tpu_torch.tools import microbench_probe

    before = probe_select.launches
    res = microbench_probe.run(table_mb=2, classes=40, num_hashes=7, reads=512, reads_per_chunk=128,
                               iters=1, device=cuda_device)
    assert res["equal"] and "probe_select == reads_query: True" in capsys.readouterr().out
    assert probe_select.launches == before + 2 * 4  # a warm-up and one timed pass of 4 chunks


@pytest.mark.cuda
@pytest.mark.parametrize("row_words", [4, 32, 40, 128, 1024])
@pytest.mark.parametrize("n", [1, 13, 70_001])
def test_row_gather_kernel_matches_plain(cuda_device, row_words, n):
    """K9 in its three modes equals its plain version exactly: rows of one
    16 B vector to 4 KB (a width that is no power of two among them),
    indices at both ends and out of range (clamped), a window that clips
    on both sides, sums that wrap mod 2**32."""
    from xspect2_tpu_torch.ops.row_gather import row_gather, row_gather_plain

    rng = np.random.default_rng(row_words * 7 + n)
    rows = 3001
    table = torch.from_numpy(
        rng.integers(0, 2**32, size=(rows, row_words), dtype=np.uint32).view(np.int32)).to(cuda_device)
    idx = rng.integers(0, rows, size=n, dtype=np.int32)
    idx[: min(n, 4)] = [0, rows - 1, -3, rows + 5][: min(n, 4)]
    idx = torch.from_numpy(idx).to(cuda_device)
    for mode, window, t in (("total", None, table), ("per_row", None, table),
                            ("window", (1000, 700), table[1000:1700]), ("window", (0, rows), table)):
        before = row_gather.launches
        got = row_gather(t, idx, mode=mode, window=window)
        assert row_gather.launches == before + 1
        want = row_gather_plain(t, idx, mode=mode, window=window)
        assert got.dtype == torch.int32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="aligned"):
        row_gather(table.view(-1)[1 : 1 + 8 * row_words].view(8, row_words), idx)


# n at the edges of a grid stride of K9's launch, as names: the stride is
# the card's SMs times the indices an SM's blocks take a step
ROW_GATHER_NS = ("0", "1", "step-1", "step", "step+1", "5steps+3")


def _row_gather_n(name, step):
    return {"0": 0, "1": 1, "step-1": step - 1, "step": step, "step+1": step + 1, "5steps+3": 5 * step + 3}[name]


def _row_gather_table(rng, rows, row_words, device):
    return torch.from_numpy(
        rng.integers(0, 2**32, size=(rows, row_words), dtype=np.uint32).view(np.int32)).to(device)


def _row_gather_holds(table, idx, window):
    """K9 equals its plain version exactly in all three modes, one launch
    a call (none for no indices)."""
    from xspect2_tpu_torch.ops.row_gather import row_gather, row_gather_plain

    for mode, w, t in (("total", None, table), ("per_row", None, table),
                       ("window", window, table[window[0]: window[0] + window[1]])):
        before = row_gather.launches
        got = row_gather(t, idx, mode=mode, window=w)
        assert row_gather.launches == before + (1 if idx.numel() else 0)
        want = row_gather_plain(t, idx, mode=mode, window=w)
        assert got.dtype == torch.int32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("row_words", [4, 40, 128, 1024])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("n_name", ROW_GATHER_NS)
def test_row_gather_kernel_step_edges_and_unaligned_indices(cuda_device, row_words, shift, n_name):
    """K9 at rows of 16 B, 160 B, 512 B and 4 KB, at n of 0, 1 and around
    the grid stride of its launch (where each warp comes back for its next
    indices), on index views that start 0, 4, 8 and 12 B past a 16 B
    boundary, with indices out of range on both sides: exact in all three
    modes."""
    from xspect2_tpu_torch.ops.row_gather import grid_stride

    rng = np.random.default_rng(row_words * 31 + shift)
    rows = 2003
    table = _row_gather_table(rng, rows, row_words, cuda_device)
    step = grid_stride(row_words, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    n = _row_gather_n(n_name, step)
    pool = torch.from_numpy(rng.integers(-7, rows + 7, size=n + 8, dtype=np.int32)).to(cuda_device)
    base = pool.data_ptr() % 16 // 4  # torch's allocations start 16 B aligned; a view may not
    idx = pool[(shift - base) % 4:][:n]
    assert idx.numel() == n and (n == 0 or idx.data_ptr() % 16 == 4 * shift)
    _row_gather_holds(table, idx, (rows // 5, rows // 2))


@pytest.mark.cuda
@pytest.mark.parametrize("row_words", [4, 40, 128, 1024])
def test_row_gather_kernel_hot_row_and_sparse_window(cuda_device, row_words):
    """Every index naming one row (each load hits the same lines), and a
    window of 20 rows of 4,000 that clips both sides so that nearly every
    load is skipped: exact in all three modes."""
    rng = np.random.default_rng(row_words)
    rows = 4000
    table = _row_gather_table(rng, rows, row_words, cuda_device)
    hot = torch.full((9_001,), 1234, dtype=torch.int32, device=cuda_device)
    _row_gather_holds(table, hot, (1200, 100))
    idx = torch.from_numpy(rng.integers(-50, rows + 50, size=20_011, dtype=np.int32)).to(cuda_device)
    _row_gather_holds(table, idx, (1990, 20))


# ------------------------------------------------------------------ the row-major layout


def _index_k(num_classes, num_hashes, rng, k, fpr, length):
    genomes = [rng.integers(0, 4, size=length, dtype=np.uint8) for _ in range(num_classes)]
    idx = BlockedBitSlicedIndex.create(k, [f"c{i}" for i in range(num_classes)], length, fpr=fpr,
                                       num_hashes=num_hashes)
    for ci, g in enumerate(genomes):
        idx.insert_kmers(ci, *dna.canonical_kmers(g, k))
    return idx, genomes


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi,hint", [(300, 1500, None), (32, 80, 10**6)])
def test_multi_records_query_kernel_at_the_mlst_geometry(cuda_device, lo, hi, hint):
    """K5 over seven 1,000-allele tables (k=31, fpr 0.001, h=1: cw=32, 8
    rows a block) and one 40-class table (cw=2) in one call, one launch
    for each of the two probe paths, equals its plain version and the
    host counts; short records with a hint of 10**6 send the blocks to the
    global-atomic path."""
    rng = np.random.default_rng(lo)
    indices, genomes = [], []
    for num_classes, h in [(1000, 1)] * 7 + [(40, 3)]:
        idx, g = _index_k(num_classes, h, rng, 31, 0.001, 450)
        indices.append(idx)
        genomes += g[:2]
    assert [(i.class_words, i.rows_per_block) for i in indices[:7]] == [(32, 8)] * 7
    engines = [query.DeviceQueryEngine(idx, device=cuda_device, chunk=8192) for idx in indices]
    # records cut from a run of alleles of every table
    pool = np.concatenate([genomes[int(i)] for i in rng.integers(0, len(genomes), 40)])
    records = _records(rng, [pool], 40 if hint is None else 150, lo, hi)
    batch = query.prepare_batch(records, 31, chunk=8192)
    max_records = query._next_pow2(max(8, batch.num_records))
    inputs = [torch.from_numpy(a).to(cuda_device) for a in (batch.codes, batch.rec_ids, batch.valid)]
    tables, geoms = [e.table for e in engines], [e.geometry() for e in engines]
    before = query.multi_records_query.launches
    got = query.multi_records_query(tables, geoms, *inputs, max_records=max_records, min_record_len=hint)
    assert query.multi_records_query.launches == before + 2
    want = query.multi_records_query_plain(tables, geoms, *inputs, max_records=max_records)
    for idx, g, w in zip(indices, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        host = np.stack([idx.count_hits_host(*dna.canonical_kmers(c, 31)) for _, c in records])
        np.testing.assert_array_equal(g[: len(records)].cpu().numpy(), host)
    assert sum(int(g.sum()) for g in got) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("num_classes,num_hashes", [(40, 7), (512, 3), (1000, 1)])
@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("n_blk", [None, 3])
def test_records_query_kernel_reads_row_major_probe_rows(cuda_device, num_classes, num_hashes, step, n_blk):
    """K3 at 2, 16 and 32 class words (uint2 and uint4 probe rows), whole
    and in owned-block mode over 3 shards, equals its plain version, and
    the counts (summed over the shards) equal the host's."""
    from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard

    rng = np.random.default_rng(num_classes + step)
    idx, genomes = _index(num_classes, num_hashes, rng, length=600)
    assert idx.class_words == -(-num_classes // 32) and idx.fields_per_word == 1
    records = _records(rng, genomes, 50, 22, 500)
    engine = query.DeviceQueryEngine(idx, device=cuda_device, chunk=8192)
    batch = query.prepare_batch(records, 21, step=step, chunk=engine.chunk)
    max_records = query._next_pow2(max(8, batch.num_records))
    geom = dict(max_records=max_records, **engine.geometry())
    inputs = [torch.from_numpy(a).to(cuda_device) for a in (batch.codes, batch.rec_ids, batch.valid)]
    if n_blk is None:
        shards = [(engine.table, {})]
    else:
        local = -(-idx.num_blocks // n_blk)
        shards = [
            (torch.from_numpy(blk_table_shard(idx, n_blk, m).view(np.int32)).to(cuda_device),
             dict(local_blocks=local, block_offset=m * local))
            for m in range(n_blk)
        ]
    total = torch.zeros((max_records, num_classes), dtype=torch.int32, device=cuda_device)
    for table, window in shards:
        got = query.records_query(*inputs, table, min_record_len=22, **geom, **window)
        want = query.records_query_plain(*inputs, table, **geom, **window)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        total += got
    host = np.stack([idx.count_hits_host(*dna.canonical_kmers(c, 21, step=step)) for _, c in records])
    np.testing.assert_array_equal(total[: len(records)].cpu().numpy(), host)
    assert host.sum() > 0


# (read length, k, reads): the timed shape; a single short group (40 bp:
# 20 windows), one full group (52 bp: 32), a full group and one window
# (53 bp: 33), k = 31 at 150 bp; 333 reads are no multiple of the warps
# a block (6-8) and end in a partial chunk of 256
BODY_SHAPES = {"150bp_k21": (150, 21, 700), "40bp_k21": (40, 21, 333), "52bp_k21": (52, 21, 333),
               "53bp_k21": (53, 21, 333), "150bp_k31": (150, 31, 333)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["current", "reduceand", "cwmajor", "cwmajor_p4", "noplanes", "cwm_noplanes",
                                     "gatheronly"])
@pytest.mark.parametrize("num_classes", [8, 40, 128, 500])
@pytest.mark.parametrize("shape", list(BODY_SHAPES))
def test_body_variants_kernel_matches_plain_and_reads_query(cuda_device, variant, num_classes, shape):
    """K10 at 1, 2, 4 and 16 class words and h = 1, 3, 7 equals its plain
    version on reads that end in a partial chunk, with and without N
    codes, at read lengths that leave a partial or a single short group of
    32 windows and at k = 31; a counting variant also equals K2 on the
    same row-major table."""
    from xspect2_tpu_torch.ops import body_variants as bv

    read_len, k, n_reads = BODY_SHAPES[shape]
    rng = np.random.default_rng(num_classes)
    class_words, rows_per_block = bv.geometry(num_classes)
    table = torch.from_numpy(
        rng.integers(0, 2**32, size=(2003, bv.BLOCK_WORDS), dtype=np.uint32).view(np.int32)).to(cuda_device)
    t = bv.class_word_major(table, num_classes) if variant in bv.CLASS_WORD_MAJOR else table
    reads = torch.from_numpy(rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)).to(cuda_device)
    with_n = reads.clone()
    with_n[::9, 77 if read_len > 77 else read_len // 2] = 255
    for h in (1, 3, 7):
        kw = dict(num_classes=num_classes, num_hashes=h, reads_per_chunk=256, k=k)
        for r in (reads, with_n):
            before = bv.body_variants.launches
            got = bv.body_variants(variant, r, t, **kw)
            assert bv.body_variants.launches == before + 1
            torch.testing.assert_close(got, bv.body_variants_plain(variant, r, t, **kw), rtol=0, atol=0)
        if variant in bv.COUNTING:
            k2 = query.reads_query(reads, table, k=k, step=1, num_blocks=2003, rows_per_block=rows_per_block,
                                   class_words=class_words, num_hashes=h, fields_per_word=1,
                                   num_classes=num_classes)
            torch.testing.assert_close(bv.body_variants(variant, reads, t, **kw), k2.int(), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["current", "reduceand", "cwmajor", "cwmajor_p4", "noplanes", "cwm_noplanes",
                                     "gatheronly"])
def test_body_variants_launch_fits_every_read_length(cuda_device, variant):
    """The launch K10's library sizes (``launch_config``) at every read
    length 1-512 and class-word count: at least one warp a block, one
    block an SM, a ring of at least two 16 KB groups a warp, and no more
    shared memory than the card lets a block ask for; a launch at a read
    length leaves that length's sizing in place."""
    from xspect2_tpu_torch.ops import body_variants as bv

    for num_classes in (8, 40, 128, 256, 500):
        for read_len in range(1, bv.MAX_READ_LEN + 1):
            c = bv.launch_config(variant, read_len, num_classes, cuda_device)
            assert 1 <= c["warps_a_block"] <= 8 and c["blocks_an_sm"] >= 1 and c["stages"] >= 2, (read_len, c)
            assert c["dynamic_smem_bytes"] <= c["optin_smem_bytes"], (read_len, c)
            assert c["dynamic_smem_bytes"] // c["warps_a_block"] >= c["stages"] * 32 * 4 * bv.BLOCK_WORDS
            assert c["registers"] > 0 and c["sms"] > 0
    rng = np.random.default_rng(1)
    table = torch.from_numpy(
        rng.integers(0, 2**32, size=(2003, bv.BLOCK_WORDS), dtype=np.uint32).view(np.int32)).to(cuda_device)
    t = bv.class_word_major(table, 8) if variant in bv.CLASS_WORD_MAJOR else table
    before = bv.launch_config(variant, 150, 8, cuda_device)
    reads = torch.from_numpy(rng.integers(0, 4, size=(100, 150), dtype=np.uint8)).to(cuda_device)
    bv.body_variants(variant, reads, t, num_classes=8, num_hashes=3, reads_per_chunk=64)
    assert bv.launch_config(variant, 150, 8, cuda_device) == before


SVM_KERNELS = ["linear", "rbf", "poly", "sigmoid"]


def _random_head(rng, kernel, n_classes, per_class, n_features, device, n_sv=None):
    """An ``SVMHead`` of seeded parameters: support vectors of scores in
    [0, 1), ``per_class`` a class, dual coefficients in [-1, 1],
    intercepts in [-0.5, 0.5], gamma 1 / n_features, coef0 0.5.  With
    ``n_sv``, the first class holds all but one support vector a class
    and 8 of its dual coefficients are not zero, so that both versions
    sum the same few terms however many support vectors there are."""
    from xspect2_tpu_torch.models.svm_head import SVMHead

    n_support = [per_class] * n_classes if n_sv is None else [n_sv - n_classes + 1] + [1] * (n_classes - 1)
    total = sum(n_support)
    dual = rng.uniform(-1, 1, (n_classes - 1, total))
    if n_sv is not None:
        dual[:, : n_support[0]] *= np.isin(np.arange(n_support[0]), rng.choice(n_support[0], 8, replace=False))
    head = SVMHead(
        rng.random((total, n_features)), dual,
        rng.uniform(-0.5, 0.5, n_classes * (n_classes - 1) // 2), n_support,
        [f"c{i:03d}" for i in range(n_classes)], kernel, gamma=1.0 / n_features, degree=3, coef0=0.5,
    )
    return head.to(device)


def _check_svm_head(head, x, min_settled, form):
    """K11 against its plain version on rows ``x``, in the form its plan
    picks (``form``) and in each form it can take (the global form
    always, the staged form where the packed head fits): decisions within
    1e-12, indices equal on rows with every decision 1e-9 from zero (at
    least ``min_settled`` of them), one launch a call."""
    from xspect2_tpu_torch.ops import svm_head as sh

    want_pred, want_dec = sh.svm_head_plain(head, x, decisions=True)
    before = sh.svm_head.launches
    pred = head.predict_indices(x)
    dec = head.decision_values(x)
    assert sh.svm_head.launches == before + 2
    assert head.k11_plan.form == form
    both = sh.svm_head(head, x, decisions=True)
    assert sh.svm_head.launches == before + 3
    assert pred.dtype == torch.int64 and pred.shape == (x.shape[0],)
    assert dec.dtype == torch.float64 and dec.shape == want_dec.shape
    assert torch.equal(both[0], pred) and torch.equal(both[1], dec)
    settled = (want_dec.abs() > 1e-9).all(dim=1)
    assert int(settled.sum()) >= min_settled
    forms = ("staged", "global") if form == "staged" else ("global",)
    for each in forms:
        got_pred, got_dec = sh.svm_head(head, x, decisions=True, form=each)
        assert float((got_dec - want_dec).abs().max()) < 1e-12, each
        assert torch.equal(got_pred[settled], want_pred[settled]), each
        if each == form:
            assert torch.equal(got_pred, pred) and torch.equal(got_dec, dec)
    assert sh.svm_head.launches == before + 3 + len(forms)
    if form == "global":
        with pytest.raises(ValueError, match="no staged form"):
            sh.svm_head(head, x, form="staged")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SVM_KERNELS)
@pytest.mark.parametrize("n", [1, 7, 10_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_svm_head_kernel_matches_plain(cuda_device, kernel, n, dtype):
    """K11 at the smoke's head shape (40 classes, 2 support vectors a
    class, 40 scores), on contiguous rows and on a view whose rows lie
    48 apart, as the sharded step hands it a slice of its scores."""
    rng = np.random.default_rng(n + 10 * SVM_KERNELS.index(kernel))
    head = _random_head(rng, kernel, 40, 2, 40, cuda_device)
    wide = torch.from_numpy(rng.random((n, 48))).to(cuda_device, dtype)
    for x in (wide[:, :40].contiguous(), wide[:, :40]):
        _check_svm_head(head, x, n - n // 100, "staged")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SVM_KERNELS)
def test_svm_head_kernel_at_512_classes(cuda_device, kernel):
    """130,816 pairs a row, more than 500 a thread: the packed head (~7
    MB) does not fit shared memory, so the plan picks the global form."""
    rng = np.random.default_rng(512 + SVM_KERNELS.index(kernel))
    head = _random_head(rng, kernel, 512, 1, 512, cuda_device)
    x = torch.from_numpy(rng.random((7, 512))).to(cuda_device, torch.float32)
    _check_svm_head(head, x, 6, "global")


@pytest.mark.cuda
def test_svm_head_kernel_at_the_shared_memory_limit(cuda_device):
    """The most support vectors the card's opt-in shared memory holds run
    (above the 48 KB a block gets by default), one more raises
    ``ValueError`` before any launch."""
    from xspect2_tpu_torch.ops import svm_head as sh

    rng = np.random.default_rng(3)
    optin = sh.opt_in_bytes(cuda_device)
    most = (optin - 8 * 40 - 4 * 2) // 8
    assert most > 48 * 1024 // 8
    x = torch.from_numpy(rng.random((7, 40))).to(cuda_device)
    _check_svm_head(_random_head(rng, "rbf", 2, 0, 40, cuda_device, n_sv=most), x, 6, "global")
    head = _random_head(rng, "rbf", 2, 0, 40, cuda_device, n_sv=most + 1)
    before = sh.svm_head.launches
    with pytest.raises(ValueError, match=f"limit of {optin} B"):
        head.predict_indices(x)
    assert sh.svm_head.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SVM_KERNELS)
def test_svm_head_plan_follows_the_head_when_it_moves(cuda_device, kernel):
    """The plan is made at the first call on the card, kept for later
    calls, dropped when the head moves to the CPU and made anew (new
    buffers, the same answers) when it comes back."""
    from xspect2_tpu_torch.ops import svm_head as sh

    rng = np.random.default_rng(40 + SVM_KERNELS.index(kernel))
    head = _random_head(rng, kernel, 40, 2, 40, cuda_device)
    x = torch.from_numpy(rng.random((33, 40))).to(cuda_device)
    assert head.k11_plan is None
    first = sh.svm_head(head, x, decisions=True)
    plan = head.k11_plan
    assert plan is not None and plan.device == x.device and plan.form == "staged"
    sh.svm_head(head, x)
    assert head.k11_plan is plan
    head.cpu()
    assert head.k11_plan is None
    want = sh.svm_head(head, x.cpu(), decisions=True)
    head.to(cuda_device)
    again = sh.svm_head(head, x, decisions=True)
    assert head.k11_plan is not plan and head.k11_plan.buffer.data_ptr() != 0
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    assert float((again[1].cpu() - want[1]).abs().max()) < 1e-12
