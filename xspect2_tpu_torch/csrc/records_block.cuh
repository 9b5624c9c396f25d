// One thread block's share of a records query, shared by K3
// (records_query.cu, one table), K5 (multi_records_query.cu, several
// tables over one position stream) and K7 (xxh3_bloom.cu, the xxh3
// compat genus filter); its code stage (stage_codes, staged_window) also
// serves K2 (reads_query.cu).
//
// The block owns positions [p0, p1) of a flat batch, at most
// kMaxBlockPositions.  For each position p with valid[p],
// 0 <= rec_ids[p] < max_records and no invalid base in
// codes[p .. p+k-1], the window is canonicalized and handed to the
// kernel's probe, which adds its hits to the counters of record
// rec_ids[p]: a blocked table's probe (TableProbe: hashed and probed as
// kmer_probe.cuh does, each set class bit adds one to
// out[rec_ids[p], class]) or the xxh3 Bloom test (one class).
//
// The block first finds the span of record ids of its VALID positions
// (the raw wire's padding carries record id 0 and is never valid, so
// record ids are not monotone over a block's range).  When the span fits
// the block's counter_rows rows of shared memory, hits are counted per
// (record, class) in shared memory and each non-zero counter is added to
// the output with one global atomic.  Otherwise the block adds every hit
// to the output with its own global atomic.  The counts do not depend on
// which of the two a block takes, so neither on the range length nor on
// counter_rows (0 rows: every block counts in global memory).
//
// The codes of [p0, p1 + k - 1) are staged once in shared memory, 2-bit
// packed 16 bases to a word with a 16-bit invalid-base mask beside it,
// from 16-byte loads; a window's forward packing is then two or three
// staged words shifted together, its reverse complement a bit reversal
// of the forward, and its validity one mask test: O(1) per window, not
// k byte loads.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_probe.cuh"

namespace xs {

constexpr int kThreads = 256;
// Thread blocks per SM that a records kernel of probe path Kind is
// compiled for: 4 caps the 4-word path (a 32-word group: 8 uint4 loads
// in flight beside their AND) at 64 registers, which gives it twice the
// resident warps it gets uncapped (~96 registers).  These kernels wait on
// random sector reads, so the warps count for more than the few spilled
// words; the 2-word path is faster uncapped and stays so.
constexpr int min_blocks(int kind) { return kind == kRows4 ? 4 : 1; }
// positions a thread block owns at most (ops/query.py:_WINDOWS_PER_BLOCK)
constexpr int kMaxBlockPositions = 2048;
// staged 16-base chunks: the positions, a k-1 <= 31 halo, the alignment
// of the first chunk and two chunks of padding that windows read past
constexpr int kStageChunks = (kMaxBlockPositions + 31 + 15) / 16 + 3;

struct StagedCodes {
  uint32_t bits[kStageChunks];  // 2-bit codes, a chunk's first base in bits 31..30
  uint32_t bad[kStageChunks];   // invalid-base flags, a chunk's first base at bit 15
  int64_t base;                 // the position of chunk 0's first base, a multiple of 16
};

// Stage codes [p0, end) (end <= the code tensor's length); every
// thread of the block must call this, and sync before reading s.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ codes, int64_t p0,
                                            int64_t end, StagedCodes& s) {
  const int64_t base = p0 & ~int64_t(15);
  const int chunks = int((end - base + 15) >> 4) + 2;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
    const int64_t q = base + 16 * int64_t(j);
    uint32_t wd[4];
    if (aligned && q + 16 <= end) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + q));
      wd[0] = v.x, wd[1] = v.y, wd[2] = v.z, wd[3] = v.w;
    } else {  // the ragged end: bases past it are invalid
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wd[i] = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int64_t at = q + 4 * i + t;
          wd[i] |= uint32_t(at < end ? codes[at] : 0xFFu) << (8 * t);
        }
      }
    }
    uint32_t bits = 0, bad = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const uint32_t c = (wd[t >> 2] >> (8 * (t & 3))) & 0xFFu;
      bits = (bits << 2) | (c & 3u);
      bad = (bad << 1) | uint32_t(c > 3u);
    }
    s.bits[j] = bits;
    s.bad[j] = bad;
  }
  if (threadIdx.x == 0) s.base = base;
}

// Canonical (hi, lo) of the k-wide window at position p from the staged
// codes, as canonical_window packs it; false when it holds an invalid base.
__device__ __forceinline__ bool staged_window(const StagedCodes& s, int64_t p, int k,
                                              uint32_t& hi, uint32_t& lo) {
  const int r = int(p - s.base);
  const int j = r >> 4, sh = r & 15;
  const uint64_t bad = (uint64_t(s.bad[j]) << 32) | (uint64_t(s.bad[j + 1]) << 16) | s.bad[j + 2];
  if ((bad << (16 + sh)) >> (64 - k)) return false;
  uint64_t w = (uint64_t(s.bits[j]) << 32) | s.bits[j + 1];
  if (sh) w = (w << (2 * sh)) | (s.bits[j + 2] >> (32 - 2 * sh));
  const uint64_t fwd = w >> (64 - 2 * k);  // sum c_t 4^(k-1-t)
  // reverse complement sum (3-c_t) 4^t: complement, reverse the bits,
  // swap each pair back into base order
  uint64_t x = __brevll(~fwd);
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  const uint64_t rc = x >> (64 - 2 * k);
  const uint64_t can = fwd <= rc ? fwd : rc;
  const int lo_bits = 2 * min(k, 16);
  hi = uint32_t(can >> lo_bits);
  lo = uint32_t(can & ((1ull << lo_bits) - 1ull));
  return true;
}

// The record span [first, last] of the valid positions of [p0, p1);
// last < 0 when there is none.  Every thread of the block must call it.
__device__ __forceinline__ void record_span(const int32_t* __restrict__ rec_ids,
                                            const uint8_t* __restrict__ valid, int64_t p0,
                                            int64_t p1, int max_records, int& r_first,
                                            int& r_last) {
  __shared__ int s_first, s_last;
  if (threadIdx.x == 0) {
    s_first = INT_MAX;
    s_last = -1;
  }
  __syncthreads();
  int first = INT_MAX, last = -1;
  for (int64_t p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (!valid[p]) continue;
    const int r = rec_ids[p];
    if (r < 0 || r >= max_records) continue;
    first = min(first, r);
    last = max(last, r);
  }
  first = __reduce_min_sync(0xFFFFFFFFu, first);
  last = __reduce_max_sync(0xFFFFFFFFu, last);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_first, first);
    atomicMax(&s_last, last);
  }
  __syncthreads();
  r_first = s_first;
  r_last = s_last;
}

// Add the block's shared counters of records [r_first, r_first + span)
// to out, one global atomic per non-zero counter.
__device__ __forceinline__ void flush_counts(const int32_t* s_counts, int32_t* __restrict__ out,
                                             int r_first, int span, int num_classes) {
  for (int i = threadIdx.x; i < span * num_classes; i += blockDim.x) {
    const int32_t val = s_counts[i];
    if (val) {
      atomicAdd(out + (int64_t(r_first) + i / num_classes) * num_classes + i % num_classes,
                val);
    }
  }
}

// The probe of a blocked table on probe path Kind (kmer_probe.cuh).  A
// probe has k() and num_classes(), and its call adds the class hits of
// the canonical k-mer (hi, lo) to cnt[0 .. num_classes).
template <int Kind>
struct TableProbe {
  const uint32_t* table;
  const ProbeGeom& g;
  __device__ __forceinline__ int k() const { return g.k; }
  __device__ __forceinline__ int num_classes() const { return g.num_classes; }
  __device__ __forceinline__ void operator()(uint32_t hi, uint32_t lo, int32_t* cnt) const {
    probe_and_count<Kind>(table, g, hi, lo, cnt);
  }
};

// s_counts: counter_rows * probe.num_classes() int32 of shared memory.
// Every thread of the block must call this (it synchronizes the block).
template <class Probe>
__device__ __forceinline__ void count_records_block(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ rec_ids,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ out, int64_t p0, int64_t p1,
    int max_records, int counter_rows, const Probe& probe, int32_t* s_counts) {
  __shared__ StagedCodes s_codes;
  const int num_classes = probe.num_classes();
  const int k = probe.k();
  int r_first, r_last;
  record_span(rec_ids, valid, p0, p1, max_records, r_first, r_last);
  if (r_last < 0) return;  // no valid position in this block
  const int span = r_last - r_first + 1;
  const bool shared = span <= counter_rows;
  stage_codes(codes, p0, p1 + k - 1, s_codes);
  if (shared) {
    for (int i = threadIdx.x; i < span * num_classes; i += blockDim.x) s_counts[i] = 0;
  }
  __syncthreads();

  for (int64_t p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (!valid[p]) continue;
    const int r = rec_ids[p];
    if (r < 0 || r >= max_records) continue;
    uint32_t hi, lo;
    if (!staged_window(s_codes, p, k, hi, lo)) continue;
    probe(hi, lo, shared ? s_counts + (r - r_first) * num_classes : out + int64_t(r) * num_classes);
  }
  if (!shared) return;
  __syncthreads();
  flush_counts(s_counts, out, r_first, span, num_classes);
}

}  // namespace xs
