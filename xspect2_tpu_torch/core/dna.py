"""DNA sequence encoding: ASCII -> 2-bit codes, canonical k-mers (host/numpy side).

The device side packs the same windows inside the read-query kernel
(:mod:`xspect2_tpu_torch.ops.query`); this module is the host/numpy
reference used for index construction and differential tests.

Encoding: A=0, C=1, G=2, T=3 (case-insensitive).  Any other byte encodes
to ``INVALID`` (255).  Because A<C<G<T both as ASCII characters and as
2-bit codes, lexicographic string comparison of k-mers equals numeric
comparison of their big-endian 2-bit packings, which is the
canonicalization XspecT applies (string min of forward and reverse
complement).
"""

import numpy as np

INVALID = np.uint8(255)

# ASCII -> 2-bit code lookup table
ENCODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _base, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    ENCODE_LUT[ord(_base)] = _code
    ENCODE_LUT[ord(_base.lower())] = _code

DECODE_LUT = np.array([ord(c) for c in "ACGT"], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII DNA sequence to a uint8 code array (0..3, 255=invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return ENCODE_LUT[raw]


def decode(codes: np.ndarray) -> str:
    """Decode a 0..3 code array back to an ACGT string (invalid -> 'N')."""
    out = np.where(codes <= 3, DECODE_LUT[np.minimum(codes, 3)], ord("N"))
    return out.astype(np.uint8).tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array; invalid codes stay invalid."""
    comp = np.where(codes <= 3, 3 - codes, codes)
    return comp[::-1]


def pack_kmers(codes: np.ndarray, k: int, step: int = 1):
    """Extract k-mer windows and pack them into (hi, lo) uint32 word pairs.

    Returns ``(hi, lo, valid)`` arrays of length ``ceil((len-k+1)/step)``
    (empty if the sequence is shorter than k):

    - ``lo``: the last ``min(k, 16)`` bases, big-endian 2 bits per base.
    - ``hi``: the first ``k - min(k, 16)`` bases (0 for k <= 16).
    - ``valid``: True where the window contains no invalid base.

    Only k <= 32 is supported.  The (hi, lo) pair compares in
    lexicographic k-mer order: compare hi first, then lo.
    """
    if not 1 <= k <= 32:
        raise ValueError("k must be in [1, 32]")
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z.copy(), np.zeros(0, dtype=bool)

    starts = np.arange(0, n, step, dtype=np.int64)
    lo_bases = min(k, 16)
    hi_bases = k - lo_bases

    hi = np.zeros(len(starts), dtype=np.uint32)
    lo = np.zeros(len(starts), dtype=np.uint32)
    bad = np.zeros(len(starts), dtype=bool)
    c32 = codes.astype(np.uint32)
    for i in range(hi_bases):
        c = c32[starts + i]
        hi = (hi << np.uint32(2)) | np.where(c <= 3, c, 0).astype(np.uint32)
        bad |= c > 3
    for i in range(hi_bases, k):
        c = c32[starts + i]
        lo = (lo << np.uint32(2)) | np.where(c <= 3, c, 0).astype(np.uint32)
        bad |= c > 3
    return hi, lo, ~bad


def canonical_kmers(codes: np.ndarray, k: int, step: int = 1):
    """Packed canonical k-mers: element-wise min(forward, revcomp) in k-mer order.

    Returns ``(hi, lo, valid)`` like :func:`pack_kmers`.
    """
    f_hi, f_lo, f_valid = pack_kmers(codes, k, step=1)
    # revcomp of window starting at p (length k) is the reverse-complemented
    # codes window starting at len-k-p in the reversed array.
    rc = revcomp_codes(codes)
    r_hi, r_lo, _ = pack_kmers(rc, k, step=1)
    r_hi = r_hi[::-1]
    r_lo = r_lo[::-1]

    fwd_le = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    hi = np.where(fwd_le, f_hi, r_hi)
    lo = np.where(fwd_le, f_lo, r_lo)
    if step != 1:
        return hi[::step], lo[::step], f_valid[::step]
    return hi, lo, f_valid
