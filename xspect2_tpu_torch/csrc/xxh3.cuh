// XXH3-64 (seed 0, the default secret) of the ASCII string of a
// canonical k-mer, 4 <= k <= 32 bases of one byte "ACGT"[code] each, and
// the Bloom probe positions derived from the digest: the device side of
// core/xxh3.py:xxh3_64_batch at input lengths 4-32 (all three of its
// short-input paths) over core/compat.py:ascii_from_packed, and of
// core/compat.py:derive_probe_positions.
//
// The ASCII bytes are never stored: each little-endian 64-bit word the
// hash reads is formed from the 2-bit codes in a few register
// operations (ascii_word).  All arithmetic is uint64_t, so shifts are
// logical and products wrap at 2^64 as numpy's uint64 does; the high
// half of a 64x64 product is __umul64hi.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xs {

constexpr uint64_t kPrime64_1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kPrimeMx1 = 0x165667919E3779F9ull;  // avalanche multiplier
constexpr uint64_t kPrimeMx2 = 0x9FB21C651E98DF25ull;  // rrmxmx multiplier
// little-endian words of the default secret at byte offsets 0, 8, 16 and
// 24: what an input of 17-32 bytes reads (mix16 at secret offsets 0, 16)
constexpr uint64_t kSecret0 = 0xBE4BA423396CFEB8ull;
constexpr uint64_t kSecret8 = 0x1CAD21F72C81017Cull;
constexpr uint64_t kSecret16 = 0xDB979083E96DD4DEull;
constexpr uint64_t kSecret24 = 0x1F67B3B7A4A44072ull;
// seed-0 bitflips: secret words 8 ^ 16 (4-8 bytes), 24 ^ 32 and 40 ^ 48
// (9-16 bytes)
constexpr uint64_t kFlip4 = 0xC73AB174C5ECD5A2ull;
constexpr uint64_t kFlip9Lo = 0x6782737BEA4239B9ull;
constexpr uint64_t kFlip9Hi = 0xAF56BC3B0996523Aull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return (uint64_t(__byte_perm(uint32_t(x), 0u, 0x0123u)) << 32) |
         __byte_perm(uint32_t(x >> 32), 0u, 0x0123u);
}

// low 64 bits xor high 64 bits of the 128-bit product
__device__ __forceinline__ uint64_t mul128_fold64(uint64_t a, uint64_t b) {
  return (a * b) ^ __umul64hi(a, b);
}

__device__ __forceinline__ uint64_t avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= kPrimeMx1;
  return h ^ (h >> 32);
}

// The k-mer's codes in reverse base order, base t's 2-bit code at bits
// 2t (low bit) and 2t+1, from its big-endian packing can (base 0 in the
// top bits, 2k bits).
__device__ __forceinline__ uint64_t reverse_bases(uint64_t can, int k) {
  // reverse all bits, then swap each pair back into code order
  const uint64_t x = __brevll(can << (64 - 2 * k));
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// The ASCII bytes of bases [i, i + 8) as one little-endian word; le is
// reverse_bases of the k-mer, so a base past the k-mer reads as 'A'.
__device__ __forceinline__ uint64_t ascii_word(uint64_t le, int i) {
  uint64_t x = (le >> (2 * i)) & 0xFFFFull;
  // spread the eight 2-bit codes to the low bits of eight bytes
  x = (x & 0xFFull) | ((x & 0xFF00ull) << 24);
  x = (x & 0x0000000F0000000Full) | ((x & 0x000000F0000000F0ull) << 12);
  x = (x & 0x0003000300030003ull) | ((x & 0x000C000C000C000Cull) << 6);
  // per byte "ACGT"[c] = 0x41 + 2*c0 + 6*c1 + 11*c0*c1 (c = 2*c1 + c0):
  // at most 0x54, so nothing carries into the next byte
  const uint64_t c0 = x & 0x0101010101010101ull;
  const uint64_t c1 = (x >> 1) & 0x0101010101010101ull;
  return 0x4141414141414141ull + 2 * c0 + 6 * c1 + 11 * (c0 & c1);
}

// XXH3-64 of the k ASCII bytes of the k-mer whose reverse_bases is le
__device__ __forceinline__ uint64_t xxh3_kmer(uint64_t le, int k) {
  const uint64_t len = uint64_t(k);
  if (k <= 8) {  // 4-8 bytes: two overlapping 32-bit reads, rrmxmx
    const uint64_t in1 = ascii_word(le, 0) & 0xFFFFFFFFull;
    const uint64_t in2 = ascii_word(le, k - 4) & 0xFFFFFFFFull;
    uint64_t h = (in2 | (in1 << 32)) ^ kFlip4;
    h ^= rotl64(h, 49) ^ rotl64(h, 24);
    h *= kPrimeMx2;
    h ^= (h >> 35) + len;
    h *= kPrimeMx2;
    return h ^ (h >> 28);
  }
  if (k <= 16) {  // 9-16 bytes: two overlapping 64-bit reads
    const uint64_t lo = ascii_word(le, 0) ^ kFlip9Lo;
    const uint64_t hi = ascii_word(le, k - 8) ^ kFlip9Hi;
    return avalanche(len + bswap64(lo) + hi + mul128_fold64(lo, hi));
  }
  // 17-32 bytes: the first and the last 16 bytes, one mix16 each
  uint64_t acc = len * kPrime64_1;
  acc += mul128_fold64(ascii_word(le, 0) ^ kSecret0, ascii_word(le, 8) ^ kSecret8);
  acc += mul128_fold64(ascii_word(le, k - 16) ^ kSecret16, ascii_word(le, k - 8) ^ kSecret24);
  return avalanche(acc);
}

// a mod m for m = num_bits < 2^32, inv = floor((2^64 - 1) / m): the
// quotient umul64hi(a, inv) is floor(a / m) or one less, since
// inv * m > 2^64 - 1 - m, so one conditional subtract makes it exact
__device__ __forceinline__ uint64_t mod_bits(uint64_t a, uint64_t m, uint64_t inv) {
  const uint64_t r = a - __umul64hi(a, inv) * m;
  return r >= m ? r - m : r;
}

// The digest's num_hashes probes (d + i*h2, wrapping at 2^64, then
// mod m; h2 = ((d >> 33) ^ (d << 29)) | 1) all set in the filter words?
// Stops at the first clear bit.
__device__ __forceinline__ bool bloom_hit(const uint32_t* __restrict__ words, uint64_t d,
                                          int num_hashes, uint64_t m, uint64_t inv) {
  const uint64_t h2 = ((d >> 33) ^ (d << 29)) | 1ull;
  for (int i = 0; i < num_hashes; ++i) {
    const uint32_t bit = uint32_t(mod_bits(d + uint64_t(i) * h2, m, inv));
    if (!((__ldg(words + (bit >> 5)) >> (bit & 31u)) & 1u)) return false;
  }
  return true;
}

}  // namespace xs
