"""K10, the read query's body formulations, and the body and SPMD tools.

K10's plain version (the wrapper on CPU tensors) runs each of the seven
formulations of the JAX package's ``tools/microbench_body.py`` on a small
numpy-seeded table and reads: the four counting variants must equal the
JAX package's ``DeviceQueryEngine`` on a ``BlockedBitSlicedIndex`` whose
``table`` holds the same bytes, and the three checksums the JAX tool's
formula per chunk, written out here in numpy with the hashes of the JAX
package's ``hashing.block_and_rows``.  Both ported tools run with
``device="cpu"`` at a tiny size; the SPMD tool's meshes must equal the
port's single engine, the JAX engine and the JAX ``ShardedClassifier`` on
the 8 virtual CPU devices, exactly.
"""

import contextlib
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from xspect2_tpu import native as jax_native
from xspect2_tpu.core import dna as jax_dna
from xspect2_tpu.core import hashing as jax_hashing
from xspect2_tpu.core.blocked_index import BlockedBitSlicedIndex as JaxIndex
from xspect2_tpu.ops.query import DeviceQueryEngine as JaxEngine
from xspect2_tpu.parallel import ShardedClassifier as JaxSharded
from xspect2_tpu.parallel import make_mesh as jax_make_mesh
from xspect2_tpu_torch.core.hashing import block_words_fieldbase_torch
from xspect2_tpu_torch.ops import body_variants as bv
from xspect2_tpu_torch.ops.query import _canonical_windows_plain
from xspect2_tpu_torch.tools import microbench_body, microbench_spmd

ROOT = Path(__file__).resolve().parent.parent
K = 21
READ_LEN = 150
NK = READ_LEN - K + 1
TABLE_MB = 0.25
H = 7
N_READS = 300  # chunks of 128: the last one partial
RPC = 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Every tensor here is small: one intra-op thread keeps the plain
    versions' many small ops from waiting on other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(num_classes):
    """The JAX tool's draws at ``TABLE_MB``: table first, then the reads."""
    class_words, rows_per_block = bv.geometry(num_classes)
    num_blocks = int(TABLE_MB * 1e6 / (rows_per_block * class_words * 4))
    rng = np.random.default_rng(0)
    table = rng.integers(0, 2**32, size=(num_blocks, rows_per_block * class_words), dtype=np.uint32)
    reads = rng.integers(0, 4, size=(N_READS, READ_LEN), dtype=np.uint8)
    return table, reads


def _cwm(table, num_classes):
    class_words, rows_per_block = bv.geometry(num_classes)
    return np.ascontiguousarray(
        table.reshape(-1, rows_per_block, class_words).transpose(0, 2, 1).reshape(table.shape)
    )


def _port(variant, table, reads, num_classes):
    t = _cwm(table, num_classes) if variant in bv.CLASS_WORD_MAJOR else table
    out = bv.body_variants(
        variant, torch.from_numpy(reads), torch.from_numpy(t.view(np.int32)), num_classes=num_classes,
        num_hashes=H, reads_per_chunk=RPC,
    )
    return out.numpy()


def _pack_and_hash(reads, num_blocks, rows_per_block, k=K):
    """The JAX tool's ``pack_and_hash`` (``tools/microbench_body.py:67-95``)
    in numpy, then the JAX package's ``block_and_rows``."""
    r = reads.astype(np.uint32)
    nk = r.shape[1] - k + 1
    lo_bases = min(k, 16)
    hi_bases = k - lo_bases
    z = np.zeros((r.shape[0], nk), np.uint32)
    f_hi, f_lo, r_hi, r_lo = z.copy(), z.copy(), z.copy(), z.copy()
    for j in range(k):
        c = r[:, j : j + nk]
        cm = np.where(c > 3, 0, c).astype(np.uint32)
        if j < hi_bases:
            f_hi = (f_hi << np.uint32(2)) | cm
        else:
            f_lo = (f_lo << np.uint32(2)) | cm
    for t in range(k):
        c = r[:, k - 1 - t : k - 1 - t + nk]
        cm = np.where(c > 3, 0, 3 - c).astype(np.uint32)
        if t < hi_bases:
            r_hi = (r_hi << np.uint32(2)) | cm
        else:
            r_lo = (r_lo << np.uint32(2)) | cm
    fwd_le = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    hi = np.where(fwd_le, f_hi, r_hi).reshape(-1)
    lo = np.where(fwd_le, f_lo, r_lo).reshape(-1)
    return jax_hashing.block_and_rows(hi, lo, num_blocks, rows_per_block, H, xp=np)


def _tool_checksums(variant, table, reads, num_classes, k=K):
    """The JAX tool's checksum of ``variant`` for each chunk of ``RPC``
    reads: the AND-ed probe words (``body_noplanes``,
    ``body_cwmajor_noplanes``) or every gathered block word and row id
    (``body_gatheronly``), wrapped to uint32."""
    class_words, rows_per_block = bv.geometry(num_classes)
    blocks3 = table.reshape(-1, rows_per_block, class_words)
    sums = []
    for c0 in range(0, reads.shape[0], RPC):
        block, rows = _pack_and_hash(reads[c0 : c0 + RPC], table.shape[0], rows_per_block, k)
        if variant == "gatheronly":
            want = table[block].sum(dtype=np.uint64) + rows.sum(dtype=np.uint64)
        else:
            probes = blocks3[block[:, None], rows]  # [k-mers, h, cw]
            want = np.bitwise_and.reduce(probes, axis=1).sum(dtype=np.uint64)
        sums.append(np.uint32(int(want) & 0xFFFFFFFF))
    return sums


_JAX_COUNTS: dict = {}


def _jax_counts(num_classes):
    """The JAX engine's hits on an index whose table holds the tool's bytes."""
    if num_classes not in _JAX_COUNTS:
        table, reads = _inputs(num_classes)
        class_words, rows_per_block = bv.geometry(num_classes)
        jidx = JaxIndex(K, [f"c{i}" for i in range(num_classes)], table.shape[0], rows_per_block, H, 0.01,
                        table=table)
        _JAX_COUNTS[num_classes] = JaxEngine(jidx).count_hits_reads(reads, reads_per_chunk=RPC, wire="raw")
    return _JAX_COUNTS[num_classes]


@pytest.mark.parametrize("num_classes", [8, 40])
@pytest.mark.parametrize("variant", bv.COUNTING)
def test_counting_variants_equal_the_jax_engine(variant, num_classes):
    table, reads = _inputs(num_classes)
    got = _port(variant, table, reads, num_classes)
    want = _jax_counts(num_classes)
    assert got.dtype == np.int32 and got.shape == (N_READS, num_classes)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) > 0


@pytest.mark.parametrize("num_classes", [8, 40])
@pytest.mark.parametrize("variant", ["noplanes", "cwm_noplanes", "gatheronly"])
def test_checksums_equal_the_jax_tools_formula(variant, num_classes):
    """One uint32 sum a chunk of ``RPC`` reads on every row of that chunk:
    the AND-ed probe words (``body_noplanes``, ``body_cwmajor_noplanes``) or
    every gathered block word and row id (``body_gatheronly``)."""
    table, reads = _inputs(num_classes)
    got = _port(variant, table, reads, num_classes).view(np.uint32)
    for chunk, want in enumerate(_tool_checksums(variant, table, reads, num_classes)):
        c0 = chunk * RPC
        assert (got[c0 : c0 + RPC] == want).all(), (variant, c0)


# (read length, k) at the edges of a group of 32 windows (40 bp: 20
# windows, 52: 32, 53: 33), of k (1, 16, 17, 31, 32) and of the read
# (a read of one window; 512 bp, the longest the kernel takes)
EDGE_SHAPES = [(40, 21), (52, 21), (53, 21), (150, 31), (512, 32), (1, 1), (17, 16), (33, 17), (21, 21)]


@pytest.mark.parametrize("read_len,k", EDGE_SHAPES)
def test_the_hash_prologue_at_edge_read_lengths(read_len, k):
    """The plain version's windows and hashes equal the JAX tool's pack and
    ``block_and_rows`` at every edge shape, N codes included."""
    rng = np.random.default_rng(read_len * 33 + k)
    reads = rng.integers(0, 4, size=(16, read_len), dtype=np.uint8)
    reads[rng.random(reads.shape) < 0.05] = 255
    nk = read_len - k + 1
    hi, lo, _ = _canonical_windows_plain(torch.from_numpy(reads).long(), k, nk)
    block, rows, _ = block_words_fieldbase_torch(hi.reshape(-1), lo.reshape(-1), 1009, 16, H)
    want_block, want_rows = _pack_and_hash(reads, 1009, 16, k)
    np.testing.assert_array_equal(block.numpy(), want_block.astype(np.int64))
    np.testing.assert_array_equal(rows.numpy(), want_rows.astype(np.int64))


@pytest.mark.parametrize("read_len,k", [(40, 21), (150, 31)])
@pytest.mark.parametrize("variant", ["noplanes", "cwm_noplanes", "gatheronly"])
def test_checksums_at_edge_read_lengths(variant, read_len, k):
    """A single short group (40 bp) and k = 31: each chunk's checksum is
    the JAX tool's formula, on reads with N codes that end in a partial
    chunk."""
    table, _ = _inputs(40)
    rng = np.random.default_rng(read_len + k)
    reads = rng.integers(0, 4, size=(N_READS, read_len), dtype=np.uint8)
    reads[::9, read_len // 2] = 255
    t = _cwm(table, 40) if variant in bv.CLASS_WORD_MAJOR else table
    got = bv.body_variants(variant, torch.from_numpy(reads), torch.from_numpy(t.view(np.int32)), num_classes=40,
                           num_hashes=H, reads_per_chunk=RPC, k=k).numpy().view(np.uint32)
    for chunk, want in enumerate(_tool_checksums(variant, table, reads, 40, k)):
        assert (got[chunk * RPC : (chunk + 1) * RPC] == want).all(), (variant, chunk)


@pytest.mark.parametrize("num_classes", [8, 40, 128, 512])
def test_the_hash_prologue_equals_block_and_rows(num_classes):
    """The plain version's windows and hashes equal the JAX tool's pack and
    the JAX package's ``block_and_rows``, N codes (packed as 0) included."""
    class_words, rows_per_block = bv.geometry(num_classes)
    rng = np.random.default_rng(num_classes)
    reads = rng.integers(0, 4, size=(64, READ_LEN), dtype=np.uint8)
    reads[rng.integers(0, 64, 20), rng.integers(0, READ_LEN, 20)] = 255
    hi, lo, _ = _canonical_windows_plain(torch.from_numpy(reads).long(), K, NK)
    block, rows, _ = block_words_fieldbase_torch(hi.reshape(-1), lo.reshape(-1), 1009, rows_per_block, H)
    want_block, want_rows = _pack_and_hash(reads, 1009, rows_per_block)
    np.testing.assert_array_equal(block.numpy(), want_block.astype(np.int64))
    np.testing.assert_array_equal(rows.numpy(), want_rows.astype(np.int64))


def test_windows_over_an_n_count():
    """A code above 3 packs as 0 in both strands and its windows still
    count, as in the JAX tool, where the JAX engine skips them: the
    counting variants agree, reads without an N equal the JAX engine's
    and reads with one count at least as many hits."""
    table, reads = _inputs(8)
    reads = reads.copy()
    reads[::7, 40] = 255
    outs = {v: _port(v, table, reads, 8) for v in bv.COUNTING}
    for v in bv.COUNTING[1:]:
        np.testing.assert_array_equal(outs[v], outs["current"])
    class_words, rows_per_block = bv.geometry(8)
    jidx = JaxIndex(K, [f"c{i}" for i in range(8)], table.shape[0], rows_per_block, H, 0.01, table=table)
    want = JaxEngine(jidx).count_hits_reads(reads, reads_per_chunk=RPC, wire="raw")
    has_n = np.zeros(N_READS, bool)
    has_n[::7] = True
    np.testing.assert_array_equal(outs["current"][~has_n], want[~has_n])
    assert (outs["current"][has_n] >= want[has_n]).all()
    assert (outs["current"][has_n] > want[has_n]).any()


@pytest.mark.parametrize(
    "variant,num_classes,read_len,table_width,match",
    [
        ("fastest", 8, 150, 128, "unknown variant"),
        ("current", 96, 150, 128, "power of two"),
        ("current", 1024, 150, 128, "blocks of 128"),
        ("cwmajor_p4", 8, 300, 128, "fewer than 256"),
        ("current", 8, 600, 128, "read length"),
        ("reduceand", 8, 150, 64, "table must be"),
    ],
)
def test_the_wrapper_checks_its_inputs(variant, num_classes, read_len, table_width, match):
    reads = torch.zeros((4, read_len), dtype=torch.uint8)
    table = torch.zeros((16, table_width), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        bv.body_variants(variant, reads, table, num_classes=num_classes, num_hashes=3, reads_per_chunk=2)


def _jax_names(source: str, pattern: str) -> list:
    return re.findall(pattern, source)


def test_microbench_body_prints_the_jax_tools_lines():
    source = (ROOT / "tools" / "microbench_body.py").read_text()
    names = _jax_names(source, r'"(\w+)": make_scan\(')
    compared = re.search(r'for name in \(([^)]*)\):\n\s+same = ', source).group(1)
    compared = re.findall(r'"(\w+)"', compared)
    assert tuple(names) == bv.VARIANTS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = microbench_body.main(["--table-mb", "0.1", "--reads", "64", "--reads-per-chunk", "32", "--iters", "1",
                                   "--num-hashes", "3", "--device", "cpu"])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    rate = [re.fullmatch(r"(\w+) +[\d,]+ reads/s  \([\d.]+ M kmers/s\)", line) for line in lines[: len(names)]]
    assert all(rate) and [m.group(1) for m in rate] == names
    assert lines[len(names) :] == [f"current == {name}: True" for name in compared]


def _jax_spmd_index(num_classes, genome_len, num_reads):
    """The JAX tool's index and reads (``tools/microbench_spmd.py:50-79``)."""
    rng = np.random.default_rng(0)
    genomes = rng.integers(0, 4, size=(num_classes, genome_len), dtype=np.uint8)
    idx = JaxIndex.create(K, [str(i) for i in range(num_classes)], genome_len, fpr=0.01, num_hashes=7)
    for ci in range(num_classes):
        if jax_native.available():
            jax_native.insert_kmers(idx, ci, genomes[ci])
        else:
            hi, lo, v = jax_dna.canonical_kmers(genomes[ci], K)
            idx.insert_kmers(ci, hi, lo, v)
    cls = rng.integers(0, num_classes, size=num_reads)
    pos = rng.integers(0, genome_len - 150, size=num_reads)
    reads = genomes[cls[:, None], pos[:, None] + np.arange(150)[None, :]].astype(np.uint8)
    return idx, reads


def test_microbench_spmd_meshes_equal_the_single_engine_and_jax():
    source = (ROOT / "tools" / "microbench_spmd.py").read_text()
    rpc = 256
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = microbench_spmd.run(num_classes=64, genome_len=4000, num_reads=1024, reads_per_chunk=rpc, iters=1,
                                  device="cpu")
    jidx, jreads = _jax_spmd_index(64, 4000, 1024)
    np.testing.assert_array_equal(res["index"].table, jidx.table)
    np.testing.assert_array_equal(res["reads"], jreads)
    single = res["single"]
    assert single.shape == (1024, 64) and int(single.sum()) > 0
    np.testing.assert_array_equal(single, JaxEngine(jidx).count_hits_reads(jreads, reads_per_chunk=rpc, wire="raw"))
    assert list(res["meshes"]) == ["4x2", "8x1"]
    for mesh in res["meshes"].values():
        np.testing.assert_array_equal(mesh["counts"], single)
    assert len(jax.devices()) >= 8
    jclf = JaxSharded(jidx, jax_make_mesh(n_data=4, n_cls=2, devices=jax.devices()[:8]))
    np.testing.assert_array_equal(jclf.count_hits_reads(jreads, reads_per_chunk=rpc // 4), single)

    lines = buf.getvalue().splitlines()
    assert len(lines) == 5
    labels = [re.match(r"(.*): [\d,]+ reads/s$", lines[i]) for i in (0, 1, 3)]
    assert all(labels)
    jax_single = re.search(r'"(single-device +)",', source).group(1)
    assert [m.group(1) for m in labels] == [jax_single, "sharded mesh 4x2 (SPMD)", "sharded mesh 8x1 (SPMD)"]
    assert 'f"sharded mesh {n_data}x{n_cls} (SPMD)"' in source
    for i in (2, 4):
        assert re.fullmatch(r"  overhead vs single-device program: [+-]\d+\.\d% \(same total work, same silicon\)",
                            lines[i])


def test_microbench_spmd_repeats_report_the_median_window():
    """With repeats, each rate is the median window's and each overhead the
    median of the windows' overheads, its range beside it; the printed
    lines are those of one window."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = microbench_spmd.run(num_classes=64, genome_len=2000, num_reads=256, reads_per_chunk=64, iters=1,
                                  meshes=((2, 2),), device="cpu", repeats=3)
    seconds = res["seconds"]
    assert res["repeats"] == 3 and all(len(v) == 3 for v in seconds.values())
    assert res["single_reads_per_s"] == pytest.approx(256 / np.median(seconds["single"]))
    mesh = res["meshes"]["2x2"]
    overheads = [(ts / t1 - 1) * 100 for ts, t1 in zip(seconds["2x2"], seconds["single"])]
    assert mesh["overhead_pct"] == pytest.approx(np.median(overheads))
    assert mesh["overhead_pct_range"] == (min(overheads), max(overheads))
    assert mesh["reads_per_s"] == pytest.approx(256 / np.median(seconds["2x2"]))
    np.testing.assert_array_equal(mesh["counts"], res["single"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 3 and lines[1].startswith("sharded mesh 2x2 (SPMD): ")


@pytest.mark.parametrize("n_data,n_blk", [(1, 2), (2, 2)])
def test_every_coordinate_sums_a_blk_mesh(n_data, n_blk):
    """The hand walk that the card's smoke runs on (data x blk) meshes:
    each block shard's partial counts, summed, equal the single engine."""
    from xspect2_tpu_torch.ops.query import DeviceQueryEngine
    from xspect2_tpu_torch.parallel import BlockShardedClassifier
    from xspect2_tpu_torch.parallel.mesh import BLK_AXIS

    index, reads = microbench_spmd.build(num_classes=40, genome_len=2000, num_reads=200)
    want = DeviceQueryEngine(index, device="cpu").count_hits_reads(reads, reads_per_chunk=64, wire="raw")
    clf = BlockShardedClassifier(index, microbench_spmd.coordinate_mesh(n_data, n_blk, "cpu", BLK_AXIS))
    got = microbench_spmd.every_coordinate(clf, reads, 64 // n_data)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(clf._fetch(got, len(reads)), want)
    assert int(got[len(reads):].sum()) == 0 and int(want.sum()) > 0


@pytest.mark.parametrize("tool", [microbench_body, microbench_spmd])
def test_the_tools_need_cuda_unless_asked_for_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
