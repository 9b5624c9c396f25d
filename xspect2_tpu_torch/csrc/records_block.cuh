// One thread block's share of a records query, shared by K3
// (records_query.cu, one table) and K5 (multi_records_query.cu, several
// tables over one position stream).
//
// The block owns positions [p0, p1) of a flat batch.  For each position
// p with valid[p], 0 <= rec_ids[p] < max_records and no invalid base in
// codes[p .. p+k-1], the window is packed, canonicalized, hashed and
// probed as kmer_probe.cuh does, and each set class bit adds one to
// out[rec_ids[p], class].
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

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_probe.cuh"

namespace xs {

// s_counts: counter_rows * probe.num_classes int32 of shared memory.
// Every thread of the block must call this (it synchronizes the block).
__device__ __forceinline__ void count_records_block(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ rec_ids,
    const uint8_t* __restrict__ valid, const uint32_t* __restrict__ table,
    int32_t* __restrict__ out, int64_t p0, int64_t p1, int max_records, int counter_rows,
    const ProbeGeom& probe, int32_t* s_counts) {
  __shared__ int s_first, s_last;
  const int num_classes = probe.num_classes;

  // record span of the block's valid positions
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
  const int r_first = s_first, r_last = s_last;
  if (r_last < 0) return;  // no valid position in this block
  const int span = r_last - r_first + 1;
  const bool shared = span <= counter_rows;
  if (shared) {
    for (int i = threadIdx.x; i < span * num_classes; i += blockDim.x) s_counts[i] = 0;
  }
  __syncthreads();

  for (int64_t p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (!valid[p]) continue;
    const int r = rec_ids[p];
    if (r < 0 || r >= max_records) continue;
    uint32_t hi, lo;
    if (!canonical_window(codes + p, probe.k, hi, lo)) continue;
    int32_t* cnt = shared ? s_counts + (r - r_first) * num_classes
                          : out + int64_t(r) * num_classes;
    probe_and_count(table, probe, hi, lo, cnt);
  }
  if (!shared) return;

  __syncthreads();
  for (int i = threadIdx.x; i < span * num_classes; i += blockDim.x) {
    const int32_t val = s_counts[i];
    if (val) {
      atomicAdd(out + (int64_t(r_first) + i / num_classes) * num_classes + i % num_classes,
                val);
    }
  }
}

}  // namespace xs
