// Per-window k-mer work shared by K2 (reads_query.cu) and K3
// (records_query.cu): pack a k-wide window forward and reverse
// complement, take the canonical min, hash it with fmix32 exactly as
// xspect2_tpu/core/hashing.py does, read only the probe words of its
// table block and count every set class bit.
//
// The table is the class-word-major device layout of
// BlockedBitSlicedIndex.device_table: uint32 [num_blocks,
// class_words * rows_per_block].  P = fields_per_word.  P=1 ANDs word
// (b+i*c)&(rpb-1) of each class word over i<h; P>1 ANDs the probes of
// each slot s<min(h,P), rotates the slot's word right by
// ((g+s)&(P-1))*fb and masks the result to fb = 32/P bits.
//
// Owned-block mode (local_blocks > 0): the table pointer addresses only
// the local_blocks blocks that start at block_offset of the whole block
// stack, one shard of xspect2_tpu/parallel/block_sharded.py.  The hash
// still takes a % num_blocks with the whole stack's block count; a k-mer
// whose block lies outside the window counts nothing and reads nothing,
// so the counts of all shards sum to the unsharded counts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xs {

struct ProbeGeom {
  uint32_t num_blocks;
  int k;
  int rows_per_block;
  int class_words;
  int num_hashes;
  int fields_per_word;
  int num_classes;
  uint32_t block_offset;  // first block of the table's window
  uint32_t local_blocks;  // blocks in the window; 0 = the whole stack
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Canonical (hi, lo) packing of the k codes at src, lo = the last
// min(k,16) bases.  Returns false when the window holds an invalid
// base (a code > 3); hi and lo are then meaningless.
__device__ __forceinline__ bool canonical_window(const uint8_t* __restrict__ src, int k,
                                                 uint32_t& hi, uint32_t& lo) {
  // forward = sum c_t 4^(k-1-t); reverse complement = sum (3-c_t) 4^t
  uint64_t fwd = 0, rc = 0;
  bool bad = false;
  for (int t = 0; t < k; ++t) {
    const uint32_t c = src[t];
    bad |= c > 3u;
    const uint32_t cm = c & 3u;
    fwd = (fwd << 2) | cm;
    rc |= uint64_t(3u - cm) << (2 * t);
  }
  if (bad) return false;
  const int lo_bases = min(k, 16);
  const uint64_t lo_mask = (1ull << (2 * lo_bases)) - 1ull;
  const uint32_t f_hi = uint32_t(fwd >> (2 * lo_bases)), f_lo = uint32_t(fwd & lo_mask);
  const uint32_t r_hi = uint32_t(rc >> (2 * lo_bases)), r_lo = uint32_t(rc & lo_mask);
  const bool fwd_le = (f_hi < r_hi) || (f_hi == r_hi && f_lo <= r_lo);
  hi = fwd_le ? f_hi : r_hi;
  lo = fwd_le ? f_lo : r_lo;
  return true;
}

// add one to counter [base + bit] for every set bit below num_classes;
// cnt may point to shared or global memory
__device__ __forceinline__ void add_bits(uint32_t word, int base, int num_classes,
                                         int32_t* cnt) {
  while (word) {
    const int cls = base + __ffs(word) - 1;
    if (cls >= num_classes) break;
    atomicAdd(cnt + cls, 1);
    word &= word - 1;
  }
}

// Probe the table for the canonical k-mer (hi, lo) and add its class
// hits to cnt[0 .. num_classes).
__device__ __forceinline__ void probe_and_count(const uint32_t* __restrict__ table,
                                                const ProbeGeom& g, uint32_t hi,
                                                uint32_t lo, int32_t* cnt) {
  const uint32_t u = fmix32(lo ^ 0x9E3779B1u);
  const uint32_t v = fmix32(hi ^ 0x85EBCA77u);
  const uint32_t a = fmix32(u ^ rotl32(v, 16) ^ 0xC2B2AE3Du);
  const uint32_t b = fmix32(v ^ rotl32(u, 13) ^ 0x27D4EB2Fu);
  const uint32_t c = fmix32((u + v) ^ 0x165667B1u) | 1u;

  uint32_t block = a % g.num_blocks;
  if (g.local_blocks) {
    // unsigned: a block below the window wraps far above local_blocks
    block -= g.block_offset;
    if (block >= g.local_blocks) return;
  }
  const uint32_t row_mask = uint32_t(g.rows_per_block - 1);
  const uint32_t* blk = table + int64_t(block) * (int64_t(g.class_words) * g.rows_per_block);
  const int P = g.fields_per_word;
  if (P == 1) {
    for (int wd = 0; wd < g.class_words; ++wd) {
      const uint32_t* rows = blk + int64_t(wd) * g.rows_per_block;
      uint32_t acc = 0xFFFFFFFFu;
      uint32_t row = b;
      for (int i = 0; i < g.num_hashes; ++i) {
        acc &= __ldg(rows + (row & row_mask));
        row += c;
      }
      add_bits(acc, 32 * wd, g.num_classes, cnt);
    }
    return;
  }
  // P > 1 means fb < 32, so every shift below is defined
  const int fb = 32 / P;
  const uint32_t gbase = (b >> 24) & uint32_t(P - 1);
  const int slots = min(g.num_hashes, P);
  uint32_t acc = 0xFFFFFFFFu;
  for (int s = 0; s < slots; ++s) {
    uint32_t slot = 0xFFFFFFFFu;
    for (int i = s; i < g.num_hashes; i += P)
      slot &= __ldg(blk + ((b + uint32_t(i) * c) & row_mask));
    const uint32_t rot = ((gbase + uint32_t(s)) & uint32_t(P - 1)) * uint32_t(fb);
    if (rot) slot = (slot >> rot) | (slot << (32u - rot));
    acc &= slot;
  }
  add_bits(acc & ((1u << fb) - 1u), 0, g.num_classes, cnt);
}

}  // namespace xs
