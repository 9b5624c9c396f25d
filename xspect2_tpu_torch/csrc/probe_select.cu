// K8: probe select.  The AND of the selected rows of each k-mer's
// gathered table block, one word per class word.
//
// Replaces the Pallas kernel `sel_kernel` of tools/microbench_pallas.py
// (lines 74-95, its pl.pallas_call at line 98): the post-gather pass of
// the read query, prototyped there as a kernel of its own.
//
// In:  selbits uint32 [T, W]    W = max(1, rows_per_block / 32); bit
//                               (r % 32) of word r / 32 selects row r
//      blocks  uint32 [T, 128]  the k-mer's gathered block, class-word
//                               major: word l is row l % rows_per_block
//                               of class word l / rows_per_block
// Out: out     uint32 [T, class_words]  the AND over the selected rows
//                               of each class word's segment; a row that
//                               is not selected counts as all-ones
//
// rows_per_block * class_words == 128, rows_per_block is a power of two
// and at least 8 (so class_words <= 16).
//
// Bound: bytes.  Every block word is read once and used once (512 B per
// k-mer in, 4 * (W + class_words) B more), a handful of integer
// operations per word.  Design: one warp per k-mer.  Lane l loads words
// 4l .. 4l+3 as one 16-byte load, so a warp reads its 512 B block in one
// coalesced request.  The four words of a lane lie in one segment and in
// one selbits word (both are multiples of 8 words long), so the lane ANDs
// them in registers; the segment's rows_per_block / 4 lanes then meet in
// log2(rows_per_block / 4) butterfly shuffles, and the first lane of
// each segment writes its word.  There is no tile in shared memory and no
// roll tree: the TPU kernel's [T, 128] VMEM tile and lane rotations are
// that machine's shape.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void probe_select_kernel(const uint32_t* __restrict__ selbits,
                                    const uint4* __restrict__ blocks,
                                    uint32_t* __restrict__ out, int64_t num_kmers,
                                    int rows_per_block, int class_words, int sel_words) {
  const int lane = threadIdx.x & 31;
  const int64_t t = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= num_kmers) return;  // uniform over the warp

  const uint4 v = __ldg(blocks + t * 32 + lane);
  const int row = (4 * lane) & (rows_per_block - 1);  // row of the lane's first word
  const uint32_t sel = __ldg(selbits + t * sel_words + (row >> 5)) >> (row & 31);
  uint32_t acc = 0xFFFFFFFFu;
  if (sel & 1u) acc &= v.x;
  if (sel & 2u) acc &= v.y;
  if (sel & 4u) acc &= v.z;
  if (sel & 8u) acc &= v.w;

  const int lanes_per_segment = rows_per_block >> 2;
  for (int d = lanes_per_segment >> 1; d >= 1; d >>= 1)
    acc &= __shfl_xor_sync(0xFFFFFFFFu, acc, d);
  if ((lane & (lanes_per_segment - 1)) == 0)
    out[t * class_words + lane / lanes_per_segment] = acc;
}

}  // namespace

extern "C" int xs_probe_select(const void* selbits, const void* blocks, void* out,
                               int64_t num_kmers, int rows_per_block, int class_words,
                               void* stream) {
  if (rows_per_block < 8 || rows_per_block > 128 || (rows_per_block & (rows_per_block - 1)) ||
      rows_per_block * class_words != 128)
    return int(cudaErrorInvalidValue);
  if (num_kmers <= 0) return 0;
  const int sel_words = rows_per_block >= 32 ? rows_per_block / 32 : 1;
  const int64_t grid = (num_kmers + kWarpsPerBlock - 1) / kWarpsPerBlock;
  probe_select_kernel<<<unsigned(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(selbits), static_cast<const uint4*>(blocks),
      static_cast<uint32_t*>(out), num_kmers, rows_per_block, class_words, sel_words);
  return int(cudaGetLastError());
}
