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


@pytest.mark.cuda
@pytest.mark.parametrize("read_len", [150, 300])
def test_unpack_kernel_matches_plain(cuda_device, read_len):
    rng = np.random.default_rng(read_len)
    reads = rng.integers(0, 4, size=(1000, read_len), dtype=np.uint8)
    reads[rng.integers(0, 1000, 50), rng.integers(0, read_len, 50)] = 255
    wire = [torch.from_numpy(a).to(cuda_device) for a in query.pack_reads_wire(reads, 21, 1024)]
    assert int((wire[1] >= 1024).sum()) > 0  # sentinel entries are present
    before = query.unpack_2bit.launches
    got = query.unpack_2bit(*wire, read_len)
    assert query.unpack_2bit.launches == before + 1
    torch.testing.assert_close(got, query.unpack_2bit_plain(*wire, read_len), rtol=0, atol=0)


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
