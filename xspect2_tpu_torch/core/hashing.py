"""k-mer hashing for the blocked bit-sliced index.

The same mixing pipeline exists three times and all three agree bit for
bit:

- numpy over uint32 arrays (index construction and host reference),
- PyTorch over int64 tensors holding uint32 values (the plain versions
  of the device kernels; PyTorch has no uint32 ``>>``, ``<<``, ``+`` or
  ``%`` on the CPU, so the torch form computes in int64 and masks every
  result with ``& 0xFFFFFFFF``),
- CUDA C++ over ``uint32_t`` (``csrc/reads_query.cu``).

From the packed canonical k-mer (hi, lo) we derive a *block id* in
``[0, num_blocks)``, which selects one contiguous block of the bit
matrix, and ``num_hashes`` *row ids* in ``[0, rows_per_block)`` by
Kirsch-Mitzenmacher double hashing (row_i = base + i*stride, stride
odd, rows_per_block a power of two).
"""

import numpy as np
import torch

_C1 = 0x9E3779B1
_C2 = 0x85EBCA77
_C3 = 0xC2B2AE3D
_C4 = 0x27D4EB2F
_C5 = 0x165667B1
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35

MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------- numpy


def _mix32(x):
    """murmur3 fmix32 finalizer (public-domain constant mixing)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_M1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_M2)
    x = x ^ (x >> np.uint32(16))
    return x


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def kmer_hash_words(hi: np.ndarray, lo: np.ndarray):
    """Mix packed k-mer words into three independent uint32 hash words.

    Returns ``(a, b, c)``: a — block selector, b — row base, c — odd row
    stride.  Inputs must be uint32 arrays.
    """
    u = _mix32(lo ^ np.uint32(_C1))
    v = _mix32(hi ^ np.uint32(_C2))
    a = _mix32(u ^ _rotl(v, 16) ^ np.uint32(_C3))
    b = _mix32(v ^ _rotl(u, 13) ^ np.uint32(_C4))
    c = _mix32((u + v) ^ np.uint32(_C5)) | np.uint32(1)
    return a, b, c


def block_and_rows(hi: np.ndarray, lo: np.ndarray, num_blocks: int, rows_per_block: int, num_hashes: int):
    """Block id and row ids for each packed k-mer.

    Returns ``(block, rows)`` with ``block`` shape ``[n]`` (uint32 in
    [0, num_blocks)) and ``rows`` shape ``[n, num_hashes]`` (uint32 in
    [0, rows_per_block)).  ``rows_per_block`` must be a power of two.
    """
    if rows_per_block & (rows_per_block - 1):
        raise ValueError("rows_per_block must be a power of two")
    a, b, c = kmer_hash_words(hi, lo)
    block = a % np.uint32(num_blocks)
    i = np.arange(num_hashes, dtype=np.uint32)
    rows = (b[..., None] + i * c[..., None]) & np.uint32(rows_per_block - 1)
    return block, rows


def block_words_fieldbase(
    hi,
    lo,
    num_blocks: int,
    rows_per_block: int,
    num_hashes: int,
    fields_per_word: int = 1,
):
    """Probe geometry for a (possibly field-packed) index.

    With ``fields_per_word`` = P > 1, each uint32 table word stores P
    signature rows of ``32 // P`` class bits each.  Probe ``i`` of a
    k-mer lives in word ``(b + i*c) & (rows_per_block - 1)`` at field
    ``(g + i) & (P - 1)``.

    Returns ``(block [n], words [n, num_hashes], g [n])`` (all uint32);
    with P == 1, ``g`` is all-zero.
    """
    if rows_per_block & (rows_per_block - 1):
        raise ValueError("rows_per_block must be a power of two")
    if fields_per_word & (fields_per_word - 1):
        raise ValueError("fields_per_word must be a power of two")
    a, b, c = kmer_hash_words(hi, lo)
    block = a % np.uint32(num_blocks)
    mask = np.uint32(rows_per_block - 1)
    i = np.arange(num_hashes, dtype=np.uint32)
    words = (b[..., None] + i * c[..., None]) & mask
    g = (b >> np.uint32(24)) & np.uint32(fields_per_word - 1)
    return block, words, g


# ---------------------------------------------------------------- torch (int64)


def _mul32_t(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for x < 2**32 without int64 overflow.

    A full 32x32-bit product overflows int64; splitting the constant
    into 16-bit halves keeps every partial product below 2**48.
    """
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32_t(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32_t(x, _M2)
    return x ^ (x >> 16)


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def kmer_hash_words_torch(hi: torch.Tensor, lo: torch.Tensor):
    """:func:`kmer_hash_words` over int64 tensors holding uint32 values.

    Every input must lie in ``[0, 2**32)``; every output does too.
    """
    u = _mix32_t(lo ^ _C1)
    v = _mix32_t(hi ^ _C2)
    a = _mix32_t(u ^ _rotl_t(v, 16) ^ _C3)
    b = _mix32_t(v ^ _rotl_t(u, 13) ^ _C4)
    c = _mix32_t(((u + v) & MASK32) ^ _C5) | 1
    return a, b, c


def block_words_fieldbase_torch(
    hi: torch.Tensor,
    lo: torch.Tensor,
    num_blocks: int,
    rows_per_block: int,
    num_hashes: int,
    fields_per_word: int = 1,
):
    """:func:`block_words_fieldbase` over int64 tensors (values < 2**32)."""
    if rows_per_block & (rows_per_block - 1):
        raise ValueError("rows_per_block must be a power of two")
    if fields_per_word & (fields_per_word - 1):
        raise ValueError("fields_per_word must be a power of two")
    a, b, c = kmer_hash_words_torch(hi, lo)
    block = a % num_blocks
    i = torch.arange(num_hashes, dtype=torch.int64, device=hi.device)
    words = ((b[..., None] + i * c[..., None]) & MASK32) & (rows_per_block - 1)
    g = (b >> 24) & (fields_per_word - 1)
    return block, words, g
