// K3: fused records query, flat positions of ragged records ->
// per-record, per-class hits.
//
// Replaces xspect2_tpu/ops/query.py:make_query_body.query_body with
// _gather_and_probe and _accumulate_segments (the XLA window packing,
// canonical min, hash, 512 B block gather + masked AND-reduce, and the
// per-record sum, which the TPU computes as a bf16 one-hot matmul on its
// MXU); the body of both query_hits_device (raw wire) and
// query_hits_packed_batch_device (compact wire, after K1 and K4).
//
// In:  codes   uint8 [n_pos + k - 1]  0..3, >3 = invalid base
//      rec_ids int32 [n_pos]          record of each position
//      valid   uint8 [n_pos]          window start kept (record span and
//                                     sparse-sampling phase)
//      table   uint32 [num_blocks, class_words * rows_per_block]
// Out: out     int32 [max_records, num_classes]  zeroed by the caller;
//              this kernel only adds into it
//
// For each position p with valid[p], 0 <= rec_ids[p] < max_records and
// no invalid base in codes[p .. p+k-1], the window is packed,
// canonicalized, hashed and probed as kmer_probe.cuh does, and each set
// class bit adds one to out[rec_ids[p], class].  A record id outside
// [0, max_records) counts nothing, as the one-hot product drops it.
//
// Bound: random 32-byte sector reads of the table, one per probe word
// (h per counted window, cw*h when P=1); the codes, record ids and
// validity stream (6 bytes per position).  Design: a thread block owns a
// contiguous range of positions.  It first finds the span of record ids
// of its VALID positions (the raw wire's padding carries record id 0 and
// is never valid, so record ids are not monotone over a block's range);
// when the span fits the block's shared-memory counter rows, hits are
// counted per (record, class) in shared memory and each non-zero
// counter is added to the output with one global atomic.  Otherwise the
// block adds every hit to the output with its own global atomic.  The
// wrapper picks the range length from the batch's shortest record so
// that the shared path is the common one.  Any class count works: with
// no counter row at all every block counts in global memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_probe.cuh"

namespace {

constexpr int kThreads = 256;

struct Geom {
  int64_t n_pos;
  int64_t positions_per_block;
  int max_records;
  int counter_rows;  // records whose counters fit this block's shared memory
  xs::ProbeGeom probe;
};

__global__ void records_query_kernel(const uint8_t* __restrict__ codes,
                                     const int32_t* __restrict__ rec_ids,
                                     const uint8_t* __restrict__ valid,
                                     const uint32_t* __restrict__ table,
                                     int32_t* __restrict__ out, const Geom g) {
  extern __shared__ int32_t s_counts[];
  __shared__ int s_first, s_last;
  const int num_classes = g.probe.num_classes;
  const int64_t p0 = int64_t(blockIdx.x) * g.positions_per_block;
  const int64_t p1 = p0 + g.positions_per_block < g.n_pos ? p0 + g.positions_per_block : g.n_pos;

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
    if (r < 0 || r >= g.max_records) continue;
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
  const bool shared = span <= g.counter_rows;
  if (shared) {
    for (int i = threadIdx.x; i < span * num_classes; i += blockDim.x) s_counts[i] = 0;
  }
  __syncthreads();

  for (int64_t p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (!valid[p]) continue;
    const int r = rec_ids[p];
    if (r < 0 || r >= g.max_records) continue;
    uint32_t hi, lo;
    if (!xs::canonical_window(codes + p, g.probe.k, hi, lo)) continue;
    int32_t* cnt = shared ? s_counts + (r - r_first) * num_classes
                          : out + int64_t(r) * num_classes;
    xs::probe_and_count(table, g.probe, hi, lo, cnt);
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

}  // namespace

extern "C" int xs_records_query(const void* codes, const void* rec_ids, const void* valid,
                                const void* table, void* out, int64_t n_pos, int k,
                                int64_t num_blocks, int rows_per_block, int class_words,
                                int num_hashes, int fields_per_word, int num_classes,
                                int max_records, int64_t positions_per_block,
                                int counter_rows, void* stream) {
  if (n_pos <= 0) return 0;
  Geom g;
  g.n_pos = n_pos;
  g.positions_per_block = positions_per_block;
  g.max_records = max_records;
  g.counter_rows = counter_rows;
  g.probe = xs::ProbeGeom{uint32_t(num_blocks), k, rows_per_block, class_words,
                          num_hashes, fields_per_word, num_classes};
  const int64_t grid = (n_pos + positions_per_block - 1) / positions_per_block;
  const size_t shared = size_t(counter_rows) * size_t(num_classes) * sizeof(int32_t);
  records_query_kernel<<<unsigned(grid), kThreads, shared,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(rec_ids),
      static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(table),
      static_cast<int32_t*>(out), g);
  return int(cudaGetLastError());
}
