// K4: per-position record ids and window validity of the compact
// records wire.
//
// Replaces the prologue of xspect2_tpu/ops/query.py:
// query_hits_packed_batch_device (the searchsorted over the record
// offsets and the validity mask it derives, lines 301-311).
//
// In:  offsets int32 [max_records + 1]  record r spans [offsets[r],
//                                       offsets[r+1]); the tail past the
//                                       real records repeats the total
//                                       base count (empty records)
// Out: rec_ids int32 [n_pos]   searchsorted(offsets[1:], pos, "right"),
//                              clamped to max_records - 1
//      valid   uint8 [n_pos]   rel < nk_r && rel % step == 0, with
//                              rel = pos - offsets[rec] and
//                              nk_r = offsets[rec+1] - offsets[rec] - (k-1)
// All arithmetic is signed int32, as in the JAX program: nk_r is
// negative for the empty padding records, so their positions are
// invalid.  The step is a mask, not a stride: each record's phase
// restarts at its own offset.
//
// Bound: bytes.  It writes 5 bytes per position; the offsets (at most
// 65,537 entries) are read by every thread's binary search but stay in
// L1/L2.  Design: one thread per position, a binary search of
// log2(max_records) steps, coalesced writes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void records_wire_kernel(const int32_t* __restrict__ offsets,
                                    int32_t* __restrict__ rec_ids,
                                    uint8_t* __restrict__ valid, int64_t n_pos,
                                    int max_records, int k, int step) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n_pos;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int32_t pos = int32_t(i);
    // upper bound of pos in offsets[1 .. max_records]
    int lo = 0, hi = max_records;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + 1 + mid) <= pos) lo = mid + 1;
      else hi = mid;
    }
    const int rec = lo < max_records - 1 ? lo : max_records - 1;
    const int32_t start = __ldg(offsets + rec);
    const int32_t rel = pos - start;
    const int32_t nk_r = __ldg(offsets + rec + 1) - start - int32_t(k - 1);
    rec_ids[i] = rec;
    valid[i] = uint8_t(rel < nk_r && rel % step == 0);
  }
}

}  // namespace

extern "C" int xs_records_wire(const void* offsets, void* rec_ids, void* valid,
                               int64_t n_pos, int max_records, int k, int step,
                               void* stream) {
  if (n_pos <= 0) return 0;
  const int64_t blocks = (n_pos + kThreads - 1) / kThreads;
  const unsigned grid = unsigned(blocks < (1LL << 20) ? blocks : (1LL << 20));
  records_wire_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), static_cast<int32_t*>(rec_ids),
      static_cast<uint8_t*>(valid), n_pos, max_records, k, step);
  return int(cudaGetLastError());
}
