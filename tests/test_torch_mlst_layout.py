"""The MLST model's piece layout equals the batch of the splitter's pieces.

``mlst_model.piece_layout`` cuts every length group's pieces from each
record's codes, encoded once; ``batch_from_flat`` of its layout must be,
field for field, ``prepare_batch`` over ``sequence_splitter``'s pieces,
each through ``dna.encode`` (the path it replaces), and so must the
packed wire made from it.  The splitter's full pieces start every
``length - k + 1`` bases, so what follows the last of them is k - 1
bases (the record ends exactly on a piece: appended to it) or more
(a piece of its own).
"""

from pathlib import Path

import numpy as np
import pytest

from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.models import mlst_model
from xspect2_tpu_torch.ops import query

K = 31


@pytest.fixture(scope="module")
def model():
    return mlst_model.ProbabilisticFilterMlstSchemeModel(
        K, "Oxford", Path("unused"), "https://example.org/schemes/1", "abaumannii", device="cpu")


def _genome(rng, n, allele_len):
    """A random sequence with N, IUPAC codes and lowercase bases at the
    splitter's piece boundaries, inside the k - 1 overlaps and near the end."""
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n)
    if allele_len is not None:
        length = allele_len * (1 if n < 1_000_000 else 10 if n < 10_000_000 else 100)
        stride = length - K + 1
        starts = np.arange(0, max(1, n - length + 1), stride)[:40]
        for s in starts:
            for at, base in ((s, b"N"), (s + length - 1, b"R"), (s + stride, b"y"), (s + stride + K // 2, b"n")):
                if at < n:
                    seq[at] = base[0]
    seq[-1] = ord("N")
    seq[n // 3 : n // 3 + 200] = np.char.lower(seq[n // 3 : n // 3 + 200].view("S1")).view(np.uint8)
    seq[n - K - 3] = ord("W")
    return seq.tobytes().decode("ascii")


def _reference(model, seqs, allele_len, step, chunk):
    records, seg = [], []
    for b, s in enumerate(seqs):
        pieces = model.sequence_splitter(s, allele_len) if allele_len is not None else [s]
        for i, p in enumerate(pieces):
            records.append((f"g{b}p{i}", dna.encode(p)))
            seg.append(b)
    return query.prepare_batch(records, K, step=step, chunk=chunk), np.asarray(seg, dtype=np.int32)


# genome lengths at allele length 450 (pieces 450, 4,500 or 45,000 bp, a stride of 420,
# 4,470 or 44,970): 10,110 = 23 x 420 + 450 ends on a piece; 10,112 and 10,115 leave a tail
# of 32 and 35 bp
CASES = {
    "just_over_10kb": ([10_007], 450),
    "ends_on_a_piece": ([10_110], 450),
    "tail_of_k_plus_4": ([10_115], 450),
    "tail_of_k_plus_1": ([10_112], 450),
    "one_mbp": ([1_000_000], 450),
    "one_mbp_ends_on_a_piece": ([1_000_000 + (4_470 - (1_000_000 - 4_500) % 4_470) % 4_470], 450),
    "ten_mbp": ([10_000_000], 450),
    "allele_longer_than_the_genome": ([12_000], 20_000),
    "genome_one_piece_long": ([15_000], 15_000),
    "group_of_genomes": ([10_110, 25_013, 1_203_337, 10_500], 372),
    "short_sequences_whole": ([9_999, 800, 32], None),
}


@pytest.mark.parametrize("step", [1, 4])
@pytest.mark.parametrize("chunk", [query.DEFAULT_CHUNK, 4096])
@pytest.mark.parametrize("case", list(CASES))
def test_piece_layout_equals_the_splitters_batch(model, case, chunk, step):
    lengths, allele_len = CASES[case]
    rng = np.random.default_rng(sum(lengths) + step)
    seqs = [_genome(rng, n, allele_len) for n in lengths]
    want, want_seg = _reference(model, seqs, allele_len, step, chunk)

    padded, offsets, names, seg = mlst_model.piece_layout([dna.encode(s) for s in seqs], allele_len, K, chunk)
    got = query.batch_from_flat(padded, offsets, names, K, step)

    assert got.codes.dtype == want.codes.dtype and np.array_equal(got.codes, want.codes)
    assert got.num_positions == want.num_positions
    assert got.offsets.dtype == want.offsets.dtype and np.array_equal(got.offsets, want.offsets)
    assert got.num_kmers == want.num_kmers
    assert got.record_names == want.record_names
    assert got.step == want.step
    assert np.array_equal(got.rec_ids, want.rec_ids) and np.array_equal(got.valid, want.valid)
    assert seg.dtype == want_seg.dtype and np.array_equal(seg, want_seg)
    max_records = query._next_pow2(max(8, want.num_records))
    for a, b in zip(query.packed_wire_for_batch(got, max_records),
                    query.packed_wire_for_batch(want, max_records)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_tail_of_exactly_k_fails_as_the_splitters_batch_does(model):
    """A tail of k bases is a piece of exactly k bases, which
    ``batch_from_flat`` refuses (a record must be longer than k) on both
    paths."""
    seq = _genome(np.random.default_rng(5), 10_111, 450)
    assert len(model.sequence_splitter(seq, 450)[-1]) == K
    with pytest.raises(ValueError, match="longer than k"):
        _reference(model, [seq], 450, 1, query.DEFAULT_CHUNK)
    with pytest.raises(ValueError, match="longer than k"):
        query.batch_from_flat(*mlst_model.piece_layout([dna.encode(seq)], 450, K)[:3], K)
