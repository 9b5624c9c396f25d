"""The compact wires restored as K1 and K4 restore them equal the JAX package.

K4 (``csrc/records_wire.cu``) restores the codes, record ids and window
validity of the records wire in one launch; K1 (``csrc/unpack_2bit.cu``)
unpacks the 2-D read wire with its patches in one launch.  Both find a
tile's patch entries by searching the patch list, so both rely on the
lists of ``pack_reads_wire`` and ``packed_wire_for_batch`` being ascending:
pinned here for both.

On the CPU the wrappers run their plain versions, which are held exactly
against the JAX package's prepared batches (``prepare_batch``) and, through
the plain records query, against its packed-wire query.  The kernels'
index arithmetic (the tiles, the 32-way search, the running record and
phase counters of K4 with its search past a run of short or empty records, the staged span and the two unpack paths of K1) is
modelled here step for step in numpy, with the tile sizes read from the
sources, and the models are held against the plain versions across read
lengths that are not multiples of 4 or 16 and offsets with empty records.
The kernels themselves run on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_query import GEOMETRIES, _genomes, _jax_index
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import convert
from xspect2_tpu_torch.ops import query

CHUNK = 1024
CSRC = Path(query.__file__).resolve().parent.parent / "csrc"


def _constants(source: str) -> dict:
    """The ``constexpr int`` constants of a kernel source."""
    text = (CSRC / source).read_text(encoding="utf-8")
    return {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _records(rng, n, max_len, k):
    """``n`` records of k+1 to ``max_len`` bases (log-uniform), with N
    runs of 1-60 bases in every third."""
    out = []
    for i in range(n):
        length = int(np.exp(rng.uniform(np.log(k + 1), np.log(max_len + 1))))
        c = rng.integers(0, 4, size=max(length, k + 1), dtype=np.uint8)
        if i % 3 == 0:
            at = int(rng.integers(0, len(c)))
            c[at : at + int(rng.integers(1, 61))] = 255
        out.append((f"r{i}", c))
    return out


# ------------------------------------------------------------ the plain restore


@pytest.mark.parametrize("k", [5, 12, 21, 31])
@pytest.mark.parametrize("step", [1, 2, 3, 4, 5])
def test_plain_restore_equals_the_jax_prepared_batch(k, step):
    """Record ids and validity at every position, and the codes at every
    real position (so at every base a valid window reads), equal the JAX
    package's ``prepare_batch`` arrays, with ``max_records`` also padded
    by empty records; padding positions take the last record slot and are
    never valid."""
    rng = np.random.default_rng(k * 10 + step)
    for n_records in (1, 2, 37, 300):
        records = _records(rng, n_records, 5000, k)
        want = jax_query.prepare_batch(records, k, step=step, chunk=CHUNK)
        batch = query.prepare_batch(records, k, step=step, chunk=CHUNK)
        real = int(want.offsets[-1])
        windows = np.nonzero(want.valid)[0][:, None] + np.arange(k)
        for max_records in (query._next_pow2(max(8, n_records)), 4 * query._next_pow2(max(8, n_records))):
            wire = (torch.from_numpy(a) for a in query.packed_wire_for_batch(batch, max_records))
            codes, rec, valid = (t.numpy() for t in query.restore_records_wire(
                *wire, batch.num_positions, k=k, step=step))
            assert codes.shape == (batch.num_positions + k - 1,) and len(rec) == len(valid) == batch.num_positions
            np.testing.assert_array_equal(valid, want.valid)
            np.testing.assert_array_equal(rec[:real], want.rec_ids[:real])
            assert (rec[real:] == max_records - 1).all()
            np.testing.assert_array_equal(codes[windows], want.codes[windows])
            np.testing.assert_array_equal(codes[:real], want.codes[:real])


@pytest.mark.parametrize("num_records", [1, 8, 9, 65_536])
def test_a_batch_states_its_record_slots_and_shortest_record(num_records):
    """``max_records`` is the record count rounded up to a power of two, at
    least 8; ``min_record_len`` the shortest record; ``restore_batch``
    restores the wire uploaded at that capacity."""
    rng = np.random.default_rng(num_records)
    k, step = 5, 2
    lengths = rng.integers(k + 1, k + 20, size=num_records)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    codes = rng.integers(0, 4, size=int(offsets[-1]), dtype=np.uint8)
    names = [f"r{i}" for i in range(num_records)]
    batch = query.batch_from_flat(query.pad_codes(codes, k, CHUNK), offsets, names, k, step)
    slots = {1: 8, 8: 8, 9: 16, 65_536: 65_536}[num_records]
    assert (batch.max_records, batch.min_record_len, batch.k) == (slots, int(lengths.min()), k)
    assert batch.num_positions == query.padded_positions(len(codes), CHUNK)
    restored, rec_ids, valid = query.restore_batch(batch, "cpu")
    assert list(batch._device_wire) == [(slots, "cpu")]
    n_real = len(codes)
    assert np.array_equal(restored[:n_real].numpy(), codes)
    assert np.array_equal(rec_ids[:n_real].numpy(), batch.rec_ids[:n_real])
    assert np.array_equal(valid.numpy(), batch.valid)
    reads = rng.integers(0, 4, size=(num_records, k + 1), dtype=np.uint8)
    fixed = query.prepare_fixed_batch(reads, k, chunk=CHUNK)
    assert (fixed.max_records, fixed.min_record_len, fixed.k) == (slots, None, k)


@pytest.mark.parametrize("name", ["c8_p4_h2", "c40_cw2_h7"])
@pytest.mark.parametrize("step", [1, 3])
def test_records_query_on_the_restored_wire_equals_the_jax_packed_query(name, step):
    """The plain records query on the restored wire gives the counts of the
    JAX package's ``query_hits_packed_batch_device``."""
    num_classes, h = GEOMETRIES[name]
    rng = np.random.default_rng(num_classes + step)
    genomes = _genomes(rng, num_classes, 3000)
    jidx = _jax_index(genomes, 21, h)
    idx = convert.index_from_arrays(jidx.meta_dict(), jidx.table)
    records = []
    for i, (rid, c) in enumerate(_records(rng, 40, 2500, 21)):  # cut from the genomes, N runs kept
        g = genomes[i % num_classes]
        at = int(rng.integers(0, len(g) - len(c) + 1))
        records.append((rid, np.where(c > 3, c, g[at : at + len(c)]).astype(np.uint8)))
    want = jax_query.DeviceQueryEngine(jidx, chunk=CHUNK).count_hits(
        jax_query.prepare_batch(records, 21, step=step, chunk=CHUNK), wire="packed")
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    batch = query.prepare_batch(records, 21, step=step, chunk=engine.chunk)
    max_records = query._next_pow2(max(8, batch.num_records))
    codes, rec, valid = query.restore_records_wire(
        *query.upload_records_wire(batch, max_records, "cpu"), batch.num_positions, k=21, step=step)
    got = query.records_query_plain(codes, rec, valid, engine.table, max_records=max_records,
                                    **engine.geometry())
    np.testing.assert_array_equal(got[: len(records)].numpy(), want)
    assert int(got.sum()) > 0


# ------------------------------------------------------------ ascending patch lists


@pytest.mark.parametrize("read_len", [31, 100, 150, 151, 301])
@pytest.mark.parametrize("n,n_pad", [(1, 1), (700, 700), (700, 1024), (3000, 4096)])
def test_pack_reads_wire_emits_an_ascending_patch_list(read_len, n, n_pad):
    """Row-major (row, column) pairs: the reads' N bases, then the padding
    rows at every k-th base, then the sentinels (n_pad, 0); the rows never
    decrease and the real entries strictly increase."""
    rng = np.random.default_rng(read_len + n)
    reads = rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)
    reads[rng.integers(0, n, 3 * n // 10 + 1), rng.integers(0, read_len, 3 * n // 10 + 1)] = 255
    reads[n // 2, : read_len // 2] = 255
    packed, rows, cols = query.pack_reads_wire(reads, 21, n_pad)
    real = int((rows < n_pad).sum())
    assert real == int((reads > 3).sum()) + (n_pad - n) * len(range(0, read_len, 21))
    assert (np.diff(rows) >= 0).all()
    flat = rows[:real].astype(np.int64) * read_len + cols[:real]
    assert (np.diff(flat) > 0).all()
    assert (rows[real:] == n_pad).all() and (cols[real:] == 0).all()
    assert len(rows) == query._next_pow2(max(8, real))
    for g, w in zip((packed, rows, cols), jax_query.pack_reads_wire(reads, 21, n_pad)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_pack_reads_wire_without_an_n_emits_no_list():
    reads = np.random.default_rng(0).integers(0, 4, size=(64, 150), dtype=np.uint8)
    _, rows, cols = query.pack_reads_wire(reads, 21, 64)
    assert rows.shape == cols.shape == (0,)


@pytest.mark.parametrize("k", [5, 21, 31])
@pytest.mark.parametrize("n_records", [1, 300])
def test_packed_wire_for_batch_emits_an_ascending_patch_list(k, n_records):
    """The real records' N positions in order, then the sentinel
    ``len(batch.codes)``; none falls in the padding."""
    rng = np.random.default_rng(k + n_records)
    batch = query.prepare_batch(_records(rng, n_records, 3000, k), k, step=2, chunk=CHUNK)
    _, bad_pos, _ = query.packed_wire_for_batch(batch, query._next_pow2(max(8, n_records)))
    real = int((bad_pos < len(batch.codes)).sum())
    n_real = int(batch.offsets[-1])
    np.testing.assert_array_equal(bad_pos[:real], np.nonzero(batch.codes[:n_real] > 3)[0])
    assert (np.diff(bad_pos[:real]) > 0).all() and (bad_pos[real:] == len(batch.codes)).all()
    assert (np.diff(bad_pos) >= 0).all()


@pytest.mark.parametrize("route", ["reads", "records"])
def test_uploaded_builder_lists_are_marked_ascending(route):
    """The wires the paths upload (``DeviceQueryEngine.upload_wire``,
    ``upload_records_wire``) carry their patch list marked ascending, so K1
    and K4 set its patches in their one launch; the mark is the upload's
    finding, made where the list is built."""
    rng = np.random.default_rng(len(route))
    genomes = _genomes(rng, 2, 3000)
    jidx = _jax_index(genomes, 21, 2)
    engine = query.DeviceQueryEngine(convert.index_from_arrays(jidx.meta_dict(), jidx.table), device="cpu")
    if route == "reads":
        reads = rng.integers(0, 4, size=(700, 150), dtype=np.uint8)
        reads[rng.integers(0, 700, 40), rng.integers(0, 150, 40)] = 255
        patches = engine.upload_wire(reads, 512)[1]
    else:
        batch = query.prepare_batch(_records(rng, 37, 3000, 21), 21, chunk=CHUNK)
        patches = engine.upload_records_wire(batch, 64)[1]
    assert patches.numel() > 8 and query._ascending(patches)


@pytest.mark.parametrize("order", ["ascending", "equal runs", "one", "empty", "shuffled", "descending tail"])
def test_upload_patch_list_marks_only_a_list_that_never_decreases(order):
    """``upload_patch_list`` checks the order on the host: a list that never
    decreases (runs of equal rows included) is marked, any other is not and
    takes the patch-only launch; a marked list changed in place since, or a
    tensor uploaded another way, is not marked either."""
    rng = np.random.default_rng(len(order))
    base = np.sort(rng.integers(0, 1000, 64)).astype(np.int32)
    lists = {
        "ascending": np.unique(base), "equal runs": np.repeat(base[:8], 3), "one": base[:1],
        "empty": base[:0], "shuffled": rng.permutation(np.unique(base)),
        "descending tail": np.concatenate([base, base[-1:] - 1]),
    }
    arr = lists[order]
    t = query.upload_patch_list(arr, "cpu")
    np.testing.assert_array_equal(t.numpy(), arr)
    assert query._ascending(t) == (order not in ("shuffled", "descending tail"))
    assert not query._ascending(torch.from_numpy(arr.copy()))
    if len(arr) and query._ascending(t):
        t[0] = 10_000
        assert not query._ascending(t)


# ------------------------------------------------------------ the kernels' index arithmetic


def _warp_search(a, lo, hi, x, upper):
    """``wire::warp_search`` of csrc/wire_tile.cuh, lane by lane."""
    def before(i):
        return i < hi and (a[i] <= x if upper else a[i] < x)

    while hi - lo > 32:
        s = (hi - lo + 31) >> 5
        c = sum(before(lo + lane * s) for lane in range(32))
        if c == 0:
            return lo
        lo, hi = lo + (c - 1) * s + 1, min(hi, lo + c * s)
    return lo + sum(before(lo + lane) for lane in range(32))


def test_warp_search_is_searchsorted():
    rng = np.random.default_rng(3)
    for size in (0, 1, 31, 32, 33, 1000, 1024, 1025, 70_000):
        a = np.sort(rng.integers(-5, size // 3 + 5, size=size))
        for x in list(rng.integers(-8, size // 3 + 8, size=12)) + [a[0] if size else 0, a[-1] if size else 0]:
            for upper in (False, True):
                want = int(np.searchsorted(a, x, side="right" if upper else "left"))
                assert _warp_search(a, 0, size, int(x), upper) == want, (size, x, upper)


def _k4_model(offsets, n_pos, k, step):
    """Record ids and validity as K4's tiles and threads compute them, the
    ids out through the block's rotated shared-memory slots, and the most
    offsets any one thread loads while it moves from record to record."""
    c = _constants("records_wire.cu")
    per_thread = c["kPerThread"]
    tile = c["kThreads"] * per_thread
    r = len(offsets) - 1
    ends = offsets[1:]
    rec_ids = np.empty(n_pos, dtype=np.int64)
    valid = np.empty(n_pos, dtype=bool)
    most_loads = 0
    for p0 in range(0, n_pos, tile):
        first = _warp_search(ends, 0, r, p0, True)
        last = _warp_search(ends, 0, r, p0 + tile - 1, True)
        ids = np.full(tile, -1, dtype=np.int64)
        for p in range(p0, min(p0 + tile, n_pos), per_thread):
            lo, hi = first, last
            while lo < hi:
                mid = (lo + hi) >> 1
                lo, hi = (mid + 1, hi) if ends[mid] <= p else (lo, mid)
            rec = lo
            nxt = ends[rec] if rec < r else np.inf
            loads = 0
            for t in range(per_thread):
                pos = p + t
                if t == 0 or pos >= nxt:
                    if pos >= nxt:
                        # one step, then the upper bound of pos up to the tile's last record
                        rec += 1
                        nxt = ends[rec] if rec < r else np.inf
                        loads += 1
                        if pos >= nxt:
                            a, b = rec + 1, last
                            while a < b:
                                mid = (a + b) >> 1
                                a, b = (mid + 1, b) if ends[mid] <= pos else (a, mid)
                                loads += 1
                            rec = a
                            nxt = ends[rec] if rec < r else np.inf
                            loads += 1
                    rc = min(rec, r - 1)
                    start = int(offsets[rc])
                    nk = int(offsets[rc + 1]) - start - (k - 1)
                    rel = pos - start
                    phase = rel % step
                if pos < n_pos:
                    ids[pos - p0], valid[pos] = rc, rel < nk and phase == 0
                rel += 1
                phase = 0 if phase + 1 == step else phase + 1
            most_loads = max(most_loads, loads)
        # shared memory: quarter j of thread tid's ids at slot 4 tid + ((j + (tid >> 1)) & 3)
        slots = np.empty((tile // 4, 4), dtype=np.int64)
        for tid in range(tile // per_thread):
            for j in range(4):
                slots[4 * tid + ((j + (tid >> 1)) & 3)] = ids[per_thread * tid + 4 * j : per_thread * tid + 4 * j + 4]
        for slot in range(tile // 4):  # thread slot % threads, round slot // threads
            owner = slot >> 2
            pos = p0 + per_thread * owner + 4 * (((slot & 3) - (owner >> 1)) & 3)
            for e in range(4):
                if pos + e < n_pos:
                    rec_ids[pos + e] = slots[slot, e]
    return rec_ids, valid, most_loads


@pytest.mark.parametrize("case", ["assembly", "short records", "empty records between", "one record"])
@pytest.mark.parametrize("step", [1, 3, 5])
def test_k4_tile_walk_equals_the_plain_version(case, step):
    """K4's walk (a tile's first and last record by the 32-way search, a
    binary search between them, then one record at a time with the phase
    as a running counter) gives ``records_wire_plain``'s record ids and
    validity, also for empty records among the real ones and past them,
    and for positions past every offset."""
    rng = np.random.default_rng(step)
    lengths = {
        "assembly": rng.integers(300, 9000, size=12),
        "short records": rng.integers(6, 40, size=700),
        "empty records between": rng.integers(0, 3, size=900) * rng.integers(1, 60, size=900),
        "one record": np.array([7_000]),
    }[case]
    offsets = np.zeros(query._next_pow2(len(lengths) + 1) + 1, dtype=np.int32)
    offsets[1 : len(lengths) + 1] = np.cumsum(lengths)
    offsets[len(lengths) + 1 :] = offsets[len(lengths)]
    n_pos = int(offsets[-1]) + 3000  # padding past the last record
    want_rec, want_valid = query.records_wire_plain(torch.from_numpy(offsets), n_pos, k=5, step=step)
    rec, valid, _ = _k4_model(offsets, n_pos, 5, step)
    np.testing.assert_array_equal(rec, want_rec.numpy())
    np.testing.assert_array_equal(valid, want_valid.numpy())


@pytest.mark.parametrize("case", ["padded short records", "ends on a tile edge", "no empty record"])
def test_k4_search_past_empty_records_equals_the_plain_version(case):
    """Short records padded with many empty ones up to ``max_records``
    (the shape of a validated batch of reads): K4's step-then-search gives
    the plain version's ids and validity, and no thread loads more than a
    step and a binary search's worth of offsets, where a walk one record at
    a time would load one offset per empty record."""
    c = _constants("records_wire.cu")
    tile = c["kThreads"] * c["kPerThread"]
    n_real, read_len, max_records = {
        "padded short records": (700, 30, 2048),
        "ends on a tile edge": (tile // 32 * 3, 32, 1024),  # the last base ends a tile
        "no empty record": (1024, 30, 1024),
    }[case]
    offsets = np.zeros(max_records + 1, dtype=np.int32)
    offsets[1 : n_real + 1] = np.arange(1, n_real + 1) * read_len
    offsets[n_real + 1 :] = offsets[n_real]
    n_pos = int(offsets[-1]) + (0 if case == "ends on a tile edge" else 2 * tile + 5)
    if case == "ends on a tile edge":
        assert n_pos % tile == 0
    for step in (1, 4):
        want_rec, want_valid = query.records_wire_plain(torch.from_numpy(offsets), n_pos, k=21, step=step)
        rec, valid, loads = _k4_model(offsets, n_pos, 21, step)
        np.testing.assert_array_equal(rec, want_rec.numpy())
        np.testing.assert_array_equal(valid, want_valid.numpy())
        assert loads <= 2 + int(np.log2(max_records)), loads
    assert (want_rec.numpy()[int(offsets[n_real]) :] == max_records - 1).all()


def _k1_model(packed, rows, cols, read_len):
    """The codes as K1's tiles compute them on an ascending patch list: the
    staged packed span (at most the tile plus 30 bytes, in a buffer with
    slack for windows that read past it), the 5-byte window within a row,
    a window of each row across a row end, the running counter for rows
    shorter than 16, the tile's patch entries from the 32-way search of
    its row range."""
    c = _constants("unpack_2bit.cu")
    tile = 16 * c["kThreads"] * c["kChunks"]
    n, l4 = packed.shape
    flat = packed.reshape(-1)
    total = n * read_len
    out = np.zeros(total, dtype=np.uint8)
    for o0 in range(0, total, tile):
        ln = min(tile, total - o0)
        row0, col0 = divmod(o0, read_len)
        row_last = row0 + (col0 + ln - 1) // read_len
        col_last = (col0 + ln - 1) % read_len
        p0 = row0 * l4 + (col0 >> 2)
        a = p0 & ~15
        b = min((row_last * l4 + (col_last >> 2)) | 15, n * l4 - 1) + 1
        assert b - a <= tile + 30, (read_len, o0)
        span = np.zeros(tile + 48, dtype=np.uint8)  # kSpan: what lies past b is masked off
        span[: b - a] = flat[a:b]
        base = (p0 - a) - (col0 >> 2)
        for q in range(0, ln, 16):
            dr, col = divmod(col0 + q, read_len)
            at = base + dr * l4
            if col + 16 <= read_len:
                s = span[at + (col >> 2) : at + (col >> 2) + 5]
                r = 2 * (col & 3)
                w = sum(int(s[j]) << (8 * j) for j in range(5 if r else 4))
                codes = [(w >> (r + 2 * t)) & 3 for t in range(16)]
            elif read_len >= 16:
                m = read_len - col
                s = span[at + (col >> 2) : at + (col >> 2) + 5]
                w = (sum(int(s[j]) << (8 * j) for j in range(5)) >> (2 * (col & 3))) & ((1 << (2 * m)) - 1)
                nxt = sum(int(span[at + l4 + j]) << (8 * j) for j in range(4))
                w = (w | (nxt << (2 * m))) & 0xFFFFFFFF
                codes = [(w >> (2 * t)) & 3 for t in range(16)]
            else:
                codes = []
                for _ in range(min(16, ln - q)):
                    codes.append((int(span[at + (col >> 2)]) >> (2 * (col & 3))) & 3)
                    col += 1
                    if col == read_len:
                        col, at = 0, at + l4
            out[o0 + q : o0 + q + min(16, ln - q)] = codes[: min(16, ln - q)]
        lo = _warp_search(rows, 0, len(rows), row0, False)
        hi = _warp_search(rows, 0, len(rows), row_last, True)
        for e in range(lo, hi):
            f = (int(rows[e]) - row0) * read_len + int(cols[e]) - col0
            if 0 <= cols[e] < read_len and 0 <= f < ln:
                out[o0 + f] = 255
    return out.reshape(n, read_len)


@pytest.mark.parametrize(
    "read_len", [1, 2, 3, 4, 5, 15, 16, 17, 31, 100, 150, 151, 301, 2047, 5003, 8192, 8193, 10_001]
)
def test_k1_tiles_equal_the_plain_version(read_len):
    """K1's tiles stage at most their shared-memory span at every read
    length, and their codes and patches equal ``unpack_2bit_plain``: tiles
    that start and end mid-row, rows longer than a tile, rows of 1-3
    bases."""
    rng = np.random.default_rng(read_len)
    c = _constants("unpack_2bit.cu")
    tile = 16 * c["kThreads"] * c["kChunks"]
    n = max(2, (3 * tile + 777) // read_len + 1)
    reads = rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)
    reads[rng.integers(0, n, n // 7 + 1), rng.integers(0, read_len, n // 7 + 1)] = 255
    packed, rows, cols = query.pack_reads_wire(reads, 21 if read_len > 21 else 1, n + 3)
    want = query.unpack_2bit_plain(torch.from_numpy(packed), torch.from_numpy(rows), torch.from_numpy(cols),
                                   read_len).numpy()
    np.testing.assert_array_equal(_k1_model(packed, rows, cols, read_len), want)
