"""The xxh3 compat genus filter on the device: kernel K7, two entry points.

:func:`xxh3_records_count` (``csrc/xxh3_bloom.cu``) is the model's path:
from the records route's device tensors (codes, record ids, validity,
restored by K4 from the compact wire in one launch) it hashes every valid
window with XXH3-64 over its ASCII canonical k-mer, derives the probe
positions and tests the filter's bits, all on the card, and counts hits
per record: one launch per record batch.

:func:`bloom_count` (``csrc/bloom_count.cu``) tests bits at positions
the host hashed: the device step of
:meth:`~xspect2_tpu_torch.core.compat.XXH3BloomFilter.count_hits_device`,
which mirrors the JAX package's API.

Each has a plain PyTorch version beside it (:func:`xxh3_records_count_plain`,
:func:`bloom_count_plain`); a wrapper uses it only for tensors on the
CPU, and counts its kernel launches in its ``launches`` attribute.  The
plain XXH3 (:func:`xxh3_digests_plain`) and probe positions
(:func:`probe_positions_plain`) compute in int64 tensors holding uint64
bit patterns: products and sums wrap at 2^64, right shifts are masked to
be logical, the high half of a 128-bit product is built from 32-bit
halves, and the unsigned modulo runs over 16-bit limbs.
"""

import torch

from xspect2_tpu_torch.core.hashing import MASK32
from xspect2_tpu_torch.ops import _kernels
from xspect2_tpu_torch.ops.query import (
    _PLAIN_POSITIONS,
    _WINDOWS_PER_BLOCK,
    _canonical_windows_plain,
    _check_records_inputs,
)


def _i64(x: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_MX1 = _i64(0x165667919E3779F9)
_MX2 = _i64(0x9FB21C651E98DF25)
# the default secret's little-endian words at byte offsets 0, 8, ..., 48
_SECRET = [_i64(w) for w in (
    0xBE4BA423396CFEB8, 0x1CAD21F72C81017C, 0xDB979083E96DD4DE, 0x1F67B3B7A4A44072,
    0x78E5C0CC4EE679CB, 0x2172FFCC7DD05A82, 0x8E2443F7744608B8,
)]
_ASCII = (65, 67, 71, 84)  # "ACGT"


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by 1 <= s <= 63 of int64 holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mul_hi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the 128-bit product of two uint64 patterns."""
    a_lo, a_hi = a & MASK32, _srl(a, 32)
    b_lo, b_hi = b & MASK32, _srl(b, 32)
    lh, hl = a_lo * b_hi, a_hi * b_lo
    cross = _srl(a_lo * b_lo, 32) + (lh & MASK32) + (hl & MASK32)
    return a_hi * b_hi + _srl(lh, 32) + _srl(hl, 32) + _srl(cross, 32)


def _fold64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b) ^ _mul_hi(a, b)


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _srl(h, 37)
    h = h * _MX1
    return h ^ _srl(h, 32)


def _bswap(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for b in range(8):
        out |= ((x >> (8 * b)) & 0xFF) << (8 * (7 - b))
    return out


def xxh3_digests_plain(hi: torch.Tensor, lo: torch.Tensor, k: int) -> torch.Tensor:
    """XXH3-64 (seed 0) of the ASCII strings of packed canonical k-mers.

    ``hi``, ``lo`` are int64 tensors holding the uint32 words of
    :func:`xspect2_tpu_torch.core.dna.pack_kmers` (``lo`` the last
    ``min(k, 16)`` bases); returns int64 holding the uint64 digests of
    :func:`xspect2_tpu_torch.core.compat.kmer_digests`, for 4 <= k <= 32.
    """
    if not 4 <= k <= 32:
        raise ValueError("the xxh3 k-mer hash needs 4 <= k <= 32")
    can = (hi << (2 * min(k, 16))) | lo  # base 0 in the top bits
    ascii = torch.tensor(_ASCII, dtype=torch.int64, device=hi.device)

    def read(i: int, n: int) -> torch.Tensor:  # n bytes from byte i, little-endian
        word = torch.zeros_like(can)
        for t in range(n):
            shift = 2 * (k - 1 - i - t)
            code = (_srl(can, shift) if shift else can) & 3
            word |= ascii[code] << (8 * t)
        return word

    if k <= 8:
        keyed = (read(k - 4, 4) | (read(0, 4) << 32)) ^ (_SECRET[1] ^ _SECRET[2])
        h = keyed ^ ((keyed << 49) | _srl(keyed, 15)) ^ ((keyed << 24) | _srl(keyed, 40))
        h = h * _MX2
        h = h ^ (_srl(h, 35) + k)
        h = h * _MX2
        return h ^ _srl(h, 28)
    if k <= 16:
        in_lo = read(0, 8) ^ (_SECRET[3] ^ _SECRET[4])
        in_hi = read(k - 8, 8) ^ (_SECRET[5] ^ _SECRET[6])
        return _avalanche(k + _bswap(in_lo) + in_hi + _fold64(in_lo, in_hi))
    acc = torch.full_like(can, _i64((k * 0x9E3779B185EBCA87) % (1 << 64)))
    acc = acc + _fold64(read(0, 8) ^ _SECRET[0], read(8, 8) ^ _SECRET[1])
    acc = acc + _fold64(read(k - 16, 8) ^ _SECRET[2], read(k - 8, 8) ^ _SECRET[3])
    return _avalanche(acc)


def probe_positions_plain(digests: torch.Tensor, num_bits: int, num_hashes: int) -> torch.Tensor:
    """Bloom bit positions int64 [n, num_hashes] of int64-held uint64 digests:
    ``(d + i*h2) mod 2^64 mod num_bits``, ``h2 = ((d >> 33) ^ (d << 29)) | 1``,
    as :func:`xspect2_tpu_torch.core.compat.derive_probe_positions`
    computes them (num_bits < 2^32)."""
    if not 0 < num_bits <= MASK32:
        raise ValueError("num_bits must lie in [1, 2^32)")
    d = digests[:, None]
    h2 = (_srl(d, 33) ^ (d << 29)) | 1
    a = d + torch.arange(num_hashes, dtype=torch.int64, device=d.device) * h2
    r = torch.zeros_like(a)
    for s in (48, 32, 16, 0):  # 16-bit limbs, high first: r stays below 2^48
        limb = (_srl(a, s) if s else a) & 0xFFFF
        r = ((r << 16) | limb) % num_bits
    return r


def xxh3_records_count_plain(
    words: torch.Tensor,
    codes: torch.Tensor,
    rec_ids: torch.Tensor,
    valid: torch.Tensor,
    *,
    max_records: int,
    k: int,
    num_bits: int,
    num_hashes: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`xxh3_records_count`, a pass of at
    most ``_PLAIN_POSITIONS`` positions at a time."""
    n_pos = rec_ids.numel()
    bits = words.long() & MASK32
    out = torch.zeros(max_records, dtype=torch.int32, device=codes.device)
    for p0 in range(0, n_pos, _PLAIN_POSITIONS):
        p1 = min(n_pos, p0 + _PLAIN_POSITIONS)
        rec = rec_ids[p0:p1].long()
        hi, lo, bad = _canonical_windows_plain(codes[None, p0 : p1 + k - 1].long(), k, p1 - p0)
        keep = valid[p0:p1].bool() & (rec >= 0) & (rec < max_records) & ~bad[0]
        pick = keep.nonzero().squeeze(1)
        pos = probe_positions_plain(xxh3_digests_plain(hi[0, pick], lo[0, pick], k), num_bits, num_hashes)
        hit = ((bits[pos >> 5] >> (pos & 31)) & 1).bool().all(dim=1)
        out.index_add_(0, rec[pick], hit.int())
    return out


def xxh3_records_count(
    words: torch.Tensor,
    codes: torch.Tensor,
    rec_ids: torch.Tensor,
    valid: torch.Tensor,
    *,
    max_records: int,
    k: int,
    num_bits: int,
    num_hashes: int,
    min_record_len: int | None = None,
) -> torch.Tensor:
    """Per-record xxh3 Bloom hits of a flat batch: int32 [max_records].

    ``words`` is the filter as int32 [ceil(num_bits / 32)] holding uint32
    bit patterns; ``codes`` uint8 [n_pos + k - 1] (>3 = invalid base),
    ``rec_ids`` int32 [n_pos] and ``valid`` bool or uint8 [n_pos] are
    those of :func:`~xspect2_tpu_torch.ops.query.records_query`.  The
    window starting at each valid position counts for its record when it
    holds no invalid base and all ``num_hashes`` probe bits of its
    canonical k-mer's XXH3-64 are set; a record id outside
    ``[0, max_records)`` counts nothing.  ``min_record_len``, the batch's
    shortest record, sizes the kernel's thread blocks; the counts do not
    depend on it.  The result stays on the device.
    """
    _check_records_inputs(codes, rec_ids, valid, k, max_records)
    if not 4 <= k <= 32 or num_hashes < 1 or not 0 < num_bits <= MASK32:
        raise ValueError("need 4 <= k <= 32, num_hashes >= 1 and 0 < num_bits < 2^32")
    if words.dtype != torch.int32 or words.dim() != 1 or words.numel() != -(-num_bits // 32):
        raise ValueError("words must be a 1-D int32 tensor of ceil(num_bits / 32) entries")
    geom = dict(max_records=max_records, k=k, num_bits=num_bits, num_hashes=num_hashes)
    if codes.device.type == "cpu":
        return xxh3_records_count_plain(words, codes, rec_ids, valid, **geom)
    for t in (rec_ids, valid, words):
        if t.device != codes.device:
            raise ValueError("words, codes, rec_ids and valid must share one device")
    codes, rec_ids, words = codes.contiguous(), rec_ids.contiguous(), words.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    # a block's positions span at most (ppb-1)//shortest + 2 records, a
    # record being longer than k: one shared counter each
    ppb = _WINDOWS_PER_BLOCK
    rows = min(max_records, (ppb - 1) // max(k + 1, min_record_len or 0) + 2)
    out = torch.zeros(max_records, dtype=torch.int32, device=codes.device)
    fn = _kernels.entry("xxh3_bloom")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = fn(
        codes.data_ptr(), rec_ids.data_ptr(), valid.data_ptr(), words.data_ptr(), out.data_ptr(),
        rec_ids.numel(), k, num_bits, num_hashes, max_records, ppb, rows, stream,
    )
    _kernels.check("xxh3_bloom", rc)
    xxh3_records_count.launches += 1
    return out


xxh3_records_count.launches = 0


def bloom_count_plain(words: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_count`.

    Computes in int64 holding uint32 values (PyTorch has no uint32
    arithmetic on the CPU).
    """
    bits = pos.long() & MASK32
    word_idx = bits >> 5
    inside = word_idx < words.numel()
    word = (words.long() & MASK32)[torch.where(inside, word_idx, 0)]
    hit = (((word >> (bits & 31)) & 1).bool() & inside).all(dim=1) & valid.bool()
    return hit.sum().to(torch.int32).reshape(1)


def bloom_count(words: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Number of valid k-mers whose probe bits are all set: int32 [1].

    ``words`` is the filter as int32 [num_words] holding uint32 bit
    patterns (bit b of word w is filter bit ``32*w + b``), ``pos`` the
    probe bit positions as int32 [n, h], again uint32 bit patterns (so
    positions up to 2^32 - 1), ``valid`` bool or uint8 [n].  A position
    past the filter is a miss.  The result stays on the device.

    On the card one launch of ``csrc/bloom_count.cu`` counts all k-mers
    (none for n = 0); ``pos`` may be a view at any 4-byte offset, which
    the kernel reads in place.
    """
    if words.dtype != torch.int32 or words.dim() != 1 or not words.numel():
        raise ValueError("words must be a non-empty 1-D int32 tensor (uint32 bits)")
    if pos.dtype != torch.int32 or pos.dim() != 2 or pos.shape[1] < 1:
        raise ValueError("pos must be an int32 tensor [n, num_hashes] (uint32 bits)")
    if valid.dtype not in (torch.bool, torch.uint8) or tuple(valid.shape) != (pos.shape[0],):
        raise ValueError("valid must be a bool or uint8 tensor of one entry per k-mer")
    if words.device.type == "cpu":
        return bloom_count_plain(words, pos, valid)
    for t in (pos, valid):
        if t.device != words.device:
            raise ValueError("words, pos and valid must share one device")
    words, pos = words.contiguous(), pos.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    out = torch.zeros(1, dtype=torch.int32, device=words.device)
    if not pos.shape[0]:
        return out
    fn = _kernels.entry("bloom_count")
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = fn(
        words.data_ptr(), pos.data_ptr(), valid.data_ptr(), out.data_ptr(),
        pos.shape[0], pos.shape[1], words.numel(), stream,
    )
    _kernels.check("bloom_count", rc)
    bloom_count.launches += 1
    return out


bloom_count.launches = 0
