// Per-window k-mer work shared by K2 (reads_query.cu), K3
// (records_query.cu) and K5 (multi_records_query.cu): pack a k-wide
// window forward and reverse complement, take the canonical min, hash it
// with fmix32 exactly as xspect2_tpu/core/hashing.py does, read only the
// probe words of its table block and count every set class bit.
//
// The table is the index's own row-major layout (BlockedBitSlicedIndex
// .table): uint32 [num_blocks, rows_per_block * class_words], word
// (row, w) of a block at row * class_words + w, so one probe row is
// class_words contiguous words.  P = fields_per_word.  P=1 ANDs the
// rows (b+i*c)&(rpb-1) over i<h, all class words of a row at once; P>1
// (class_words == 1) ANDs the probes i<h, each rotated right by
// ((g+i)&(P-1))*fb (its slot's field offset), and masks the result to
// fb = 32/P bits.
//
// P=1 reads a probe row with the widest aligned vector load its width
// allows (uint4 when class_words % 4 == 0, uint2 when it is even, else
// one word; the caller passes a 16-byte aligned table), issues the loads
// of up to kInFlight vectors (all probes of a batch of class words)
// before it ANDs them, and walks the set bits only after the AND.  The
// probe path is a template argument of the kernels (ProbeKind), so a
// kernel launched for one geometry carries only that path's registers.
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

// vector loads a thread keeps in flight on the P=1 path
constexpr int kInFlight = 8;

// The probe path of a geometry: field-packed words (P > 1), or probe
// rows read as 1-, 2- or 4-word vectors.
enum ProbeKind : int { kFields = 0, kRows1 = 1, kRows2 = 2, kRows4 = 3 };

__host__ __device__ inline int probe_kind(int fields_per_word, int class_words) {
  if (fields_per_word > 1) return kFields;
  if ((class_words & 3) == 0) return kRows4;
  return (class_words & 1) == 0 ? kRows2 : kRows1;
}

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

// The hash words of the canonical k-mer (hi, lo): block a, row start b
// and odd row stride c (xspect2_tpu/core/hashing.py:kmer_hash_words).
__device__ __forceinline__ void kmer_hash(uint32_t hi, uint32_t lo, uint32_t& a, uint32_t& b,
                                          uint32_t& c) {
  const uint32_t u = fmix32(lo ^ 0x9E3779B1u);
  const uint32_t v = fmix32(hi ^ 0x85EBCA77u);
  a = fmix32(u ^ rotl32(v, 16) ^ 0xC2B2AE3Du);
  b = fmix32(v ^ rotl32(u, 13) ^ 0x27D4EB2Fu);
  c = fmix32((u + v) ^ 0x165667B1u) | 1u;
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

// V words of one aligned vector load from the read-only path
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t* w) {
  if constexpr (V == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = __ldg(p);
  }
}

// P=1: AND the h probe rows of the block at blk, class words in groups
// of G vectors of V words, and count the set bits.  A batch of
// kH = max(1, kInFlight/G) probes of a group is loaded before it is
// ANDed, so up to kInFlight vector loads are in flight per thread.
template <int V, int G>
__device__ __forceinline__ void probe_rows(const uint32_t* __restrict__ blk, const ProbeGeom& g,
                                           uint32_t b, uint32_t c, int32_t* cnt) {
  constexpr int kH = G >= kInFlight ? 1 : kInFlight / G;
  const int cw = g.class_words;
  const int h = g.num_hashes;
  const uint32_t row_mask = uint32_t(g.rows_per_block - 1);
  for (int w0 = 0; w0 < cw; w0 += G * V) {
    const int nv = min(G, (cw - w0) / V);
    uint32_t acc[G * V];
#pragma unroll
    for (int e = 0; e < G * V; ++e) acc[e] = 0xFFFFFFFFu;
    for (int i0 = 0; i0 < h; i0 += kH) {
      uint32_t x[kH][G * V];
#pragma unroll
      for (int j = 0; j < kH; ++j) {
        const uint32_t row = (b + uint32_t(i0 + j) * c) & row_mask;
        const uint32_t* src = blk + row * uint32_t(cw) + w0;
#pragma unroll
        for (int v = 0; v < G; ++v) {
          if (i0 + j < h && v < nv) {
            load_words<V>(src + v * V, x[j] + v * V);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[j][v * V + e] = 0xFFFFFFFFu;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kH; ++j)
#pragma unroll
        for (int e = 0; e < G * V; ++e) acc[e] &= x[j][e];
    }
#pragma unroll
    for (int e = 0; e < G * V; ++e)
      if (e < nv * V) add_bits(acc[e], 32 * (w0 + e), g.num_classes, cnt);
  }
}

template <int V>
__device__ __forceinline__ void probe_rows_v(const uint32_t* __restrict__ blk, const ProbeGeom& g,
                                             uint32_t b, uint32_t c, int32_t* cnt) {
  static_assert(kInFlight == 8 || kInFlight == 4, "groups of 8, 4, 2 or 1 vectors");
  const int vectors = g.class_words / V;
  if (vectors >= kInFlight) {
    probe_rows<V, kInFlight>(blk, g, b, c, cnt);
  } else if (vectors >= 4) {
    probe_rows<V, 4>(blk, g, b, c, cnt);
  } else if (vectors >= 2) {
    probe_rows<V, 2>(blk, g, b, c, cnt);
  } else {
    probe_rows<V, 1>(blk, g, b, c, cnt);
  }
}

// P > 1 (class_words == 1): AND the probes, each rotated by its slot's
// field offset (probe i lies in slot i % P, and a rotation distributes
// over the AND), and keep the field of the classes.  kFieldLoads probes
// are loaded before their AND: field-packed tables take few probes (h=2
// at the species and genus geometries), and a wider unrolled batch slowed
// the owned-block mode on the card.
constexpr int kFieldLoads = 2;
__device__ __forceinline__ void probe_fields(const uint32_t* __restrict__ blk, const ProbeGeom& g,
                                             uint32_t b, uint32_t c, int32_t* cnt) {
  // P > 1 means fb < 32, so every shift below is defined
  const int P = g.fields_per_word;
  const uint32_t row_mask = uint32_t(g.rows_per_block - 1);
  const int fb = 32 / P;
  const uint32_t gbase = (b >> 24) & uint32_t(P - 1);
  uint32_t acc = 0xFFFFFFFFu;
  for (int i0 = 0; i0 < g.num_hashes; i0 += kFieldLoads) {
    uint32_t x[kFieldLoads];
#pragma unroll
    for (int j = 0; j < kFieldLoads; ++j) {
      x[j] = i0 + j < g.num_hashes ? __ldg(blk + ((b + uint32_t(i0 + j) * c) & row_mask))
                                   : 0xFFFFFFFFu;
    }
#pragma unroll
    for (int j = 0; j < kFieldLoads; ++j) {
      const uint32_t rot = ((gbase + uint32_t(i0 + j)) & uint32_t(P - 1)) * uint32_t(fb);
      acc &= rot ? (x[j] >> rot) | (x[j] << (32u - rot)) : x[j];
    }
  }
  add_bits(acc & ((1u << fb) - 1u), 0, g.num_classes, cnt);
}

// Probe the table for the canonical k-mer (hi, lo) and add its class
// hits to cnt[0 .. num_classes).  Kind is probe_kind(P, cw) of the
// geometry.
template <int Kind>
__device__ __forceinline__ void probe_and_count(const uint32_t* __restrict__ table,
                                                const ProbeGeom& g, uint32_t hi,
                                                uint32_t lo, int32_t* cnt) {
  uint32_t a, b, c;
  kmer_hash(hi, lo, a, b, c);
  uint32_t block = a % g.num_blocks;
  if (g.local_blocks) {
    // unsigned: a block below the window wraps far above local_blocks
    block -= g.block_offset;
    if (block >= g.local_blocks) return;
  }
  const uint32_t* blk = table + int64_t(block) * (int64_t(g.class_words) * g.rows_per_block);
  if constexpr (Kind == kFields) {
    probe_fields(blk, g, b, c, cnt);
  } else if constexpr (Kind == kRows4) {
    probe_rows_v<4>(blk, g, b, c, cnt);
  } else if constexpr (Kind == kRows2) {
    probe_rows_v<2>(blk, g, b, c, cnt);
  } else {
    probe_rows_v<1>(blk, g, b, c, cnt);
  }
}

}  // namespace xs
