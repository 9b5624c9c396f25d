"""XXH3-64: scalar spec and vectorized numpy batch implementation.

XspecT's genus Bloom filter hashes the ASCII canonical k-mer string
with ``xxhash.xxh3_64_intdigest``, so score parity with filters built
that way needs this exact hash.  This module implements XXH3-64
(seeded, default secret) for inputs up to 240 bytes (k-mer strings are
21-31 bytes) twice:

- :func:`xxh3_64`: scalar, pure python; the readable spec, and the
  oracle the vectorized path is tested against.
- :func:`xxh3_64_batch`: vectorized numpy over an ``[n, L]`` uint8
  array; the production path for hashing millions of k-mers at once.

The port's own copy of ``xspect2_tpu/core/xxh3.py`` (numpy only);
``tests/test_torch_compat.py`` holds the two bit-identical.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_PRIME_MX1 = 0x165667919E3779F9  # XXH3 avalanche multiplier
_PRIME_MX2 = 0x9FB21C651E98DF25  # rrmxmx multiplier
_PRIME64_1 = 0x9E3779B185EBCA87

# the xxHash default secret (XXH3_kSecret, 192 bytes)
_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 4], "little")


def _swap32(x: int) -> int:
    return int.from_bytes((x & 0xFFFFFFFF).to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes((x & _M64).to_bytes(8, "little"), "big")


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _avalanche_xxh64(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    h ^= h >> 32
    return h


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PRIME_MX1) & _M64
    h ^= h >> 32
    return h


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _PRIME_MX2) & _M64
    h ^= (h >> 35) + length
    h &= _M64
    h = (h * _PRIME_MX2) & _M64
    h ^= h >> 28
    return h


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return ((p & _M64) ^ (p >> 64)) & _M64


def _mix16(data: bytes, i: int, si: int, seed: int) -> int:
    lo = _r64(data, i) ^ ((_r64(_SECRET, si) + seed) & _M64)
    hi = _r64(data, i + 8) ^ ((_r64(_SECRET, si + 8) - seed) & _M64)
    return _mul128_fold64(lo, hi)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` (≤240 bytes) with the default secret.

    Matches ``xxhash.xxh3_64_intdigest(data, seed)`` bit for bit.
    Inputs longer than 240 bytes use the long-input algorithm the
    k-mer paths never hit; they are delegated to the real C library.
    """
    n = len(data)
    if n > 240:
        import xxhash  # pragma: no cover - out of k-mer scope

        return xxhash.xxh3_64_intdigest(data, seed)  # pragma: no cover
    seed &= _M64

    if n == 0:
        return _avalanche_xxh64(
            seed ^ _r64(_SECRET, 56) ^ _r64(_SECRET, 64)
        )
    if n <= 3:
        c1, c2, c3 = data[0], data[n >> 1], data[n - 1]
        combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
        bitflip = ((_r32(_SECRET, 0) ^ _r32(_SECRET, 4)) + seed) & _M64
        return _avalanche_xxh64(combined ^ bitflip)
    if n <= 8:
        seed2 = seed ^ ((_swap32(seed) << 32) & _M64)
        in1 = _r32(data, 0)
        in2 = _r32(data, n - 4)
        bitflip = ((_r64(_SECRET, 8) ^ _r64(_SECRET, 16)) - seed2) & _M64
        keyed = (in2 | (in1 << 32)) ^ bitflip
        return _rrmxmx(keyed, n)
    if n <= 16:
        bitflip1 = ((_r64(_SECRET, 24) ^ _r64(_SECRET, 32)) + seed) & _M64
        bitflip2 = ((_r64(_SECRET, 40) ^ _r64(_SECRET, 48)) - seed) & _M64
        input_lo = _r64(data, 0) ^ bitflip1
        input_hi = _r64(data, n - 8) ^ bitflip2
        acc = (
            n
            + _swap64(input_lo)
            + input_hi
            + _mul128_fold64(input_lo, input_hi)
        ) & _M64
        return _avalanche(acc)
    if n <= 128:
        acc = (n * _PRIME64_1) & _M64
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96, seed)
                    acc += _mix16(data, n - 64, 112, seed)
                acc += _mix16(data, 32, 64, seed)
                acc += _mix16(data, n - 48, 80, seed)
            acc += _mix16(data, 16, 32, seed)
            acc += _mix16(data, n - 32, 48, seed)
        acc += _mix16(data, 0, 0, seed)
        acc += _mix16(data, n - 16, 16, seed)
        return _avalanche(acc & _M64)
    # 129..240
    acc = (n * _PRIME64_1) & _M64
    for i in range(8):
        acc = (acc + _mix16(data, 16 * i, 16 * i, seed)) & _M64
    acc = _avalanche(acc)
    for i in range(8, n // 16):
        acc = (acc + _mix16(data, 16 * i, 16 * (i - 8) + 3, seed)) & _M64
    acc = (acc + _mix16(data, n - 16, 136 - 17, seed)) & _M64
    return _avalanche(acc)


# ---------------------------------------------------------------- batch

_U64 = np.uint64


def _v_r64(arr: np.ndarray, i: int) -> np.ndarray:
    """LE u64 read at byte offset i of every row of [n, L] uint8."""
    chunk = arr[:, i : i + 8].astype(np.uint64)
    shifts = (np.arange(8, dtype=np.uint64) * _U64(8)).astype(np.uint64)
    return np.bitwise_or.reduce(chunk << shifts[None, :], axis=1)


def _v_r32(arr: np.ndarray, i: int) -> np.ndarray:
    chunk = arr[:, i : i + 4].astype(np.uint64)
    shifts = (np.arange(4, dtype=np.uint64) * _U64(8)).astype(np.uint64)
    return np.bitwise_or.reduce(chunk << shifts[None, :], axis=1)


def _v_bswap(x: np.ndarray) -> np.ndarray:
    y = np.zeros_like(x)
    for b in range(8):
        y |= ((x >> _U64(8 * b)) & _U64(0xFF)) << _U64(8 * (7 - b))
    return y


def _v_avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _U64(37))
    h = h * _U64(_PRIME_MX1)
    return h ^ (h >> _U64(32))


def _v_umul128(a: np.ndarray, b: np.ndarray):
    """Full 128-bit product of two u64 arrays → (hi, lo)."""
    mask = _U64(0xFFFFFFFF)
    a_lo, a_hi = a & mask, a >> _U64(32)
    b_lo, b_hi = b & mask, b >> _U64(32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    cross = (ll >> _U64(32)) + (lh & mask) + (hl & mask)
    lo = (cross << _U64(32)) | (ll & mask)
    hi = hh + (lh >> _U64(32)) + (hl >> _U64(32)) + (cross >> _U64(32))
    return hi, lo


def _v_mul128_fold64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    hi, lo = _v_umul128(a, b)
    return hi ^ lo


def _v_mix16(arr: np.ndarray, i: int, si: int, seed: int) -> np.ndarray:
    lo = _v_r64(arr, i) ^ _U64((_r64(_SECRET, si) + seed) & _M64)
    hi = _v_r64(arr, i + 8) ^ _U64((_r64(_SECRET, si + 8) - seed) & _M64)
    return _v_mul128_fold64(lo, hi)


def xxh3_64_batch(arr: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH3-64 of every row of an ``[n, L]`` uint8 array (4 ≤ L ≤ 240).

    Returns uint64 hashes bit-identical to :func:`xxh3_64` per row —
    the vectorized form for hashing a whole batch of same-length
    k-mer strings (e.g. all canonical k-mers of a genome).
    """
    if arr.ndim != 2 or arr.dtype != np.uint8:
        raise ValueError("expected an [n, L] uint8 array")
    n_rows, L = arr.shape
    if not 4 <= L <= 240:
        raise ValueError("batch path supports lengths 4..240")
    seed &= _M64
    old = np.seterr(over="ignore")
    try:
        if L <= 8:
            seed2 = seed ^ ((_swap32(seed) << 32) & _M64)
            in1 = _v_r32(arr, 0)
            in2 = _v_r32(arr, L - 4)
            bitflip = _U64(((_r64(_SECRET, 8) ^ _r64(_SECRET, 16)) - seed2) & _M64)
            keyed = (in2 | (in1 << _U64(32))) ^ bitflip
            h = keyed
            rotl = lambda x, r: (x << _U64(r)) | (x >> _U64(64 - r))
            h = h ^ (rotl(h, 49) ^ rotl(h, 24))
            h = h * _U64(_PRIME_MX2)
            h = h ^ ((h >> _U64(35)) + _U64(L))
            h = h * _U64(_PRIME_MX2)
            return h ^ (h >> _U64(28))
        if L <= 16:
            bitflip1 = _U64(((_r64(_SECRET, 24) ^ _r64(_SECRET, 32)) + seed) & _M64)
            bitflip2 = _U64(((_r64(_SECRET, 40) ^ _r64(_SECRET, 48)) - seed) & _M64)
            input_lo = _v_r64(arr, 0) ^ bitflip1
            input_hi = _v_r64(arr, L - 8) ^ bitflip2
            acc = (
                _U64(L)
                + _v_bswap(input_lo)
                + input_hi
                + _v_mul128_fold64(input_lo, input_hi)
            )
            return _v_avalanche(acc)
        if L <= 128:
            acc = np.full(n_rows, _U64((L * _PRIME64_1) & _M64), dtype=np.uint64)
            if L > 32:
                if L > 64:
                    if L > 96:
                        acc += _v_mix16(arr, 48, 96, seed)
                        acc += _v_mix16(arr, L - 64, 112, seed)
                    acc += _v_mix16(arr, 32, 64, seed)
                    acc += _v_mix16(arr, L - 48, 80, seed)
                acc += _v_mix16(arr, 16, 32, seed)
                acc += _v_mix16(arr, L - 32, 48, seed)
            acc += _v_mix16(arr, 0, 0, seed)
            acc += _v_mix16(arr, L - 16, 16, seed)
            return _v_avalanche(acc)
        # 129..240
        acc = np.full(n_rows, _U64((L * _PRIME64_1) & _M64), dtype=np.uint64)
        for i in range(8):
            acc += _v_mix16(arr, 16 * i, 16 * i, seed)
        acc = _v_avalanche(acc)
        for i in range(8, L // 16):
            acc += _v_mix16(arr, 16 * i, 16 * (i - 8) + 3, seed)
        acc += _v_mix16(arr, L - 16, 136 - 17, seed)
        return _v_avalanche(acc)
    finally:
        np.seterr(**old)
