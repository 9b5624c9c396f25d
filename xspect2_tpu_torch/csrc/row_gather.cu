// K9: fused random row gather.  The sum of the uint32 words of the rows
// of a table that an index list names, wrapping mod 2^32.
//
// Replaces the fused XLA program `jnp.sum(jnp.take(t, i, axis=0),
// dtype=jnp.uint32)` that the JAX package's measurement tools time:
// tools/recalibrate_constants.py:50, microbench_gather.py:46-48,
// microbench_sorted_gather.py:55-56 (and the per-row payload of its
// pipeline, :67-73), and the clamped, masked window of
// microbench_split.py:42-60.
//
// In:  table uint32 [rows, row_words]  16-byte aligned, row_words % 4 == 0
//      idx   int32  [n]
// Out: mode 0 (total):   out uint32 [1], zeroed by the caller; the sum of
//                        every word of every gathered row
//      mode 1 (per_row): out uint32 [n], the sum of each gathered row
//      mode 2 (window):  as mode 0, over the rows [offset, offset + bound)
//                        of the index space, which are rows 0 .. bound-1 of
//                        `table`: li = idx - offset, and a row with li
//                        outside [0, bound) adds 0 (the split tool clamps
//                        li and masks the row; this kernel skips its load,
//                        the same value)
// Indices outside [0, rows) are clamped to the nearest row in modes 0
// and 1, so the kernel never reads outside the table.
//
// It stays a gather: every index's row is loaded, in the order of the
// indices, and an index named again is loaded again.  No sort, histogram
// or deduplication may replace that, though each would compute the same
// sum: the port's tools measure the card with this kernel.
// microbench_sorted_gather times random against sorted indices (a kernel
// that reorders makes the two equal), and recalibrate_constants'
// gather_scan turns its rows/s into the picker's cost of one k-mer's
// gather and looks for a cliff across the L2 (find_cliff), which K2 meets
// only because it makes one row load per k-mer in its own order.
//
// Bounds: bytes, one add a word.  The distinct-row bound reads each
// distinct row once, and each index once: 0.0619 ms for 2^21 random 512 B
// rows of a 200 MB table on an H100, which only a kernel that stops
// gathering reaches.  The in-order floor holds for uniformly random,
// independent indices (the timed shape's): a kernel that loads every
// index's row in order through the 50 MB L2 finds a row there at most
// L2 / table of the time, so it moves at least
// max(distinct rows x row bytes, n x row bytes x (1 - L2 / table)) + 4n,
// 0.2429 ms at that shape (ops/row_gather.py:in_order_floor_bytes).
// Sorted or repeated indices hit the L2 more often, and for them only the
// distinct-row term is a floor.  XLA fuses the take into the sum, so the
// TPU program writes no [n, row_words] gather, and neither does this
// kernel.
//
// Design: a group of lanes of one warp per index, 32 lanes for rows of
// 512 B and more, else the largest power of two of 16 B vectors that a
// row holds, so every lane loads 16 B a step and the row's vectors are
// adjacent in the group; a grid of at most 8 blocks of 256 threads an SM
// walks the indices, coming back after a grid stride of indices (8,448
// at 512 B rows on 132 SMs, 270,336 at 16 B).  The per-row mode meets a group's lanes in xor
// shuffles and its first lane writes; the total modes keep a sum a
// thread, meet a warp's in shuffles and a block's in shared memory, and
// add it to `out` with one unsigned atomic a block (wrapping is the spec).
//
// What holds it at the timed shape is device memory, not latency:
// 0.2967-0.2976 ms on an H100 80GB HBM3 at 700 W, of which the in-order
// floor is 82%.  At 800 MB, where the L2 can keep at most 6% of the
// table, it draws >= 2.97 TB/s
// from HBM; at that rate 0.297 ms moves 0.88 GB at 200 MB, so the L2
// serves ~18% of the loads (~37 MB of the table kept), not the floor's
// 25%.  Two redesigns were timed against it in turns and neither won by
// 3% there: (a) indices staged a tile ahead by cp.async and 8 loads of
// 16 B a lane sent before any add, 0.2941-0.3040 ms (__ldg or
// ld.global.nc.L1::no_allocate), and (b) whole rows staged by TMA bulk
// copies into a ring a warp, 0.2948-0.2954.  Both were 9-19% faster on
// tables the L2 holds (8-40 MB), and (a) 14-27% faster on sorted
// indices; the tools' measure is the random gather at the timed shape,
// so this form stays (PERF.md, section 6, T1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

enum Mode { kTotal = 0, kPerRow = 1, kWindow = 2 };

template <int kMode>
__global__ void row_gather_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int64_t n, int64_t rows,
                                  int row_vecs, int group_log2, int64_t offset, int64_t bound) {
  const int lane = threadIdx.x & 31;
  const int group = 1 << group_log2;
  const int lane_in_group = lane & (group - 1);
  const int per_warp = 32 >> group_log2;
  const int64_t warp = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t stride = int64_t(gridDim.x) * kWarps * per_warp;

  uint32_t total = 0;
  // the loop bound depends on the warp only, so every shuffle below runs
  // with all 32 lanes
  for (int64_t base = warp * per_warp; base < n; base += stride) {
    const int64_t i = base + (lane >> group_log2);
    uint32_t acc = 0;
    if (i < n) {
      int64_t r = idx[i];
      bool inside = true;
      if (kMode == kWindow) {
        r -= offset;
        inside = r >= 0 && r < bound;
      } else {
        r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
      }
      if (inside) {
        const uint4* row = table + r * row_vecs;
#pragma unroll 4
        for (int j = lane_in_group; j < row_vecs; j += group) {
          const uint4 v = __ldg(row + j);
          acc += v.x + v.y + v.z + v.w;
        }
      }
    }
    if (kMode == kPerRow) {
      for (int d = group >> 1; d >= 1; d >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
      if (lane_in_group == 0 && i < n) out[i] = acc;
    } else {
      total += acc;
    }
  }
  if (kMode != kPerRow) {
    __shared__ uint32_t s_warp[kWarps];
    for (int d = 16; d >= 1; d >>= 1) total += __shfl_xor_sync(0xFFFFFFFFu, total, d);
    if (lane == 0) s_warp[threadIdx.x >> 5] = total;
    __syncthreads();
    if (threadIdx.x < 32) {
      uint32_t v = lane < kWarps ? s_warp[lane] : 0u;
      for (int d = kWarps >> 1; d >= 1; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
      if (lane == 0 && v) atomicAdd(out, v);
    }
  }
}

// the card's SMs, asked of the runtime once; a failed call's error is
// returned (and cleared, so that the next launch's cudaGetLastError does
// not report it again), and asked again on the next launch
cudaError_t sm_count(int& count) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    int sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    cached = sms;
  }
  count = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" int xs_row_gather(const void* table, const void* idx, void* out, int64_t n, int64_t rows,
                             int row_words, int mode, int64_t offset, int64_t bound, void* stream) {
  if (row_words < 4 || row_words % 4 || rows <= 0 || mode < kTotal || mode > kWindow ||
      (mode == kWindow && (bound <= 0 || bound > rows)))
    return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return int(err);
  const int row_vecs = row_words / 4;
  int group_log2 = 0;
  while (group_log2 < 5 && (2 << group_log2) <= row_vecs) ++group_log2;
  const int64_t per_warp = 32 >> group_log2;
  const int64_t warps = (n + per_warp - 1) / per_warp;
  int64_t grid = (warps + kWarps - 1) / kWarps;
  const int64_t max_grid = int64_t(sms) * kBlocksPerSm;
  if (grid > max_grid) grid = max_grid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  const int32_t* i = static_cast<const int32_t*>(idx);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (mode == kTotal)
    row_gather_kernel<kTotal><<<unsigned(grid), kThreads, 0, s>>>(t, i, o, n, rows, row_vecs, group_log2, 0, 0);
  else if (mode == kPerRow)
    row_gather_kernel<kPerRow><<<unsigned(grid), kThreads, 0, s>>>(t, i, o, n, rows, row_vecs, group_log2, 0, 0);
  else
    row_gather_kernel<kWindow><<<unsigned(grid), kThreads, 0, s>>>(t, i, o, n, rows, row_vecs, group_log2,
                                                                   offset, bound);
  return int(cudaGetLastError());
}
