// K6: reduce per-record hit counts over the records, for several tables
// in one launch.
//
// Replaces the on-device reduction of xspect2_tpu/ops/query.py:
// make_multi_packed_query (lines 909-912 and 923-928): it keeps the
// fetch of MLST typing at [C] or [num_segments, C] per locus instead of
// [max_records, C].
//
// In:  counts  L pointers, counts l = int32 [max_records, C_l] (K5's
//              outputs)
//      seg_ids int32 [max_records]  segment (genome) of each record
//              slot; read in mode 2 only
//      mode    0: out[c]      = sum_r where(h[r,c] > threshold, h[r,c], 0)
//              1: out[c]      = h[0,c]
//              2: out[s,c]    = sum over r with seg_ids[r] == s of
//                               where(h[r,c] > threshold, h[r,c], 0);
//                 a seg_ids entry outside [0, num_segments) adds nothing
// Out: outs    L pointers, out l = int32 [C_l] (modes 0, 1) or
//              [num_segments, C_l] (mode 2), zeroed by the caller
//
// ">" is strict; threshold = -1 keeps every count.
//
// Bound: bytes; every count is read once (4 * max_records * sum C_l),
// the outputs are small.  Design: gridDim.z runs over the tables,
// gridDim.y over ranges of rows_per_block record slots, gridDim.x over
// the classes, one thread per class so that a warp reads 128 contiguous
// bytes of a row.  A thread sums its column over the block's rows in a
// register while the segment stays the same, and adds the sum to the
// output with one atomic when the segment changes and at the end, so
// sorted seg_ids (the MLST path's) cost one atomic per segment and
// range.  Mode 1 is a copy of row 0 by the first range's blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTables = 16;

struct ReduceTable {
  const int32_t* counts;
  int32_t* out;
  int num_classes;
};

struct ReduceArgs {
  int max_records;
  int rows_per_block;
  int mode;
  int threshold;
  int num_segments;
  ReduceTable t[kMaxTables];
};

__global__ void segment_reduce_kernel(const int32_t* __restrict__ seg_ids, const ReduceArgs a) {
  const ReduceTable& t = a.t[blockIdx.z];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= t.num_classes) return;
  if (a.mode == 1) {
    if (blockIdx.y == 0) t.out[c] = t.counts[c];
    return;
  }
  const int r0 = blockIdx.y * a.rows_per_block;
  const int r1 = min(r0 + a.rows_per_block, a.max_records);
  int32_t acc = 0;
  int cur = 0;  // segment that acc belongs to
  for (int r = r0; r < r1; ++r) {
    const int seg = a.mode == 2 ? __ldg(seg_ids + r) : 0;
    if (seg != cur) {
      if (acc) atomicAdd(t.out + int64_t(cur) * t.num_classes + c, acc);
      acc = 0;
      cur = seg;
    }
    if (seg < 0 || seg >= a.num_segments) continue;
    const int32_t h = t.counts[int64_t(r) * t.num_classes + c];
    if (h > a.threshold) acc += h;
  }
  if (acc) atomicAdd(t.out + int64_t(cur) * t.num_classes + c, acc);
}

}  // namespace

extern "C" int xs_segment_reduce(const void* const* counts, void* const* outs,
                                 const int* num_classes, int num_tables,
                                 const void* seg_ids, int max_records, int mode,
                                 int threshold, int num_segments, int rows_per_block,
                                 void* stream) {
  if (num_tables < 1 || num_tables > kMaxTables || mode < 0 || mode > 2 ||
      max_records < 1 || rows_per_block < 1 || num_segments < 1) {
    return int(cudaErrorInvalidValue);
  }
  ReduceArgs a;
  a.max_records = max_records;
  a.rows_per_block = rows_per_block;
  a.mode = mode;
  a.threshold = threshold;
  a.num_segments = num_segments;
  int widest = 1;
  for (int l = 0; l < kMaxTables; ++l) {
    const int s = l < num_tables ? l : 0;
    a.t[l] = ReduceTable{static_cast<const int32_t*>(counts[s]),
                         static_cast<int32_t*>(outs[s]), num_classes[s]};
    if (num_classes[s] > widest) widest = num_classes[s];
  }
  const int ranges = mode == 1 ? 1 : (max_records + rows_per_block - 1) / rows_per_block;
  const dim3 grid{unsigned((widest + kThreads - 1) / kThreads), unsigned(ranges),
                  unsigned(num_tables)};
  segment_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg_ids), a);
  return int(cudaGetLastError());
}
