// K7: membership count of hashed k-mers in a flat Bloom filter.
//
// Replaces xspect2_tpu/core/compat.py:XXH3BloomFilter.count_hits_device
// (the jitted gather, bit test, AND over the probes, mask and sum, lines
// 218-222): the device step of the xxh3 compat genus filter.  The
// XXH3-64 hashing of the ASCII k-mers stays on the host, as there.
//
// In:  words uint32 [num_words]  the filter's bits, bit b of word w is
//                                filter bit 32*w + b
//      pos   uint32 [n, h]       probe bit positions of each k-mer
//      valid uint8  [n]          k-mer counted at all
// Out: out   int32  [1]          zeroed by the caller; number of valid
//                                k-mers whose h probe bits are all set
//
// A position at or past 32 * num_words is a miss.  The k-mer axis is
// not padded: the power-of-two padding of the JAX program bounds XLA
// recompiles and has no use here.
//
// Bound: bytes: the positions and validity stream (4h + 1 bytes per
// k-mer) plus one random 32-byte sector of the filter per probe of a
// valid k-mer (a 307 Mbit genus filter is 38 MB, so most probes hit the
// 50 MB L2 once it is warm).  Design: one thread per k-mer in a
// grid-stride loop, the h probes in a loop that stops at the first clear
// bit; the block's hits are summed with warp reductions and one atomic
// per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bloom_count_kernel(const uint32_t* __restrict__ words,
                                   const uint32_t* __restrict__ pos,
                                   const uint8_t* __restrict__ valid, int64_t n,
                                   int num_hashes, int64_t num_words,
                                   int32_t* __restrict__ out) {
  __shared__ int s_hits;
  if (threadIdx.x == 0) s_hits = 0;
  __syncthreads();
  int hits = 0;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    if (!valid[i]) continue;
    const uint32_t* p = pos + i * num_hashes;
    bool hit = true;
    for (int j = 0; j < num_hashes && hit; ++j) {
      const uint32_t bit = p[j];
      const int64_t w = int64_t(bit >> 5);
      hit = w < num_words && ((__ldg(words + w) >> (bit & 31u)) & 1u);
    }
    hits += int(hit);
  }
  hits = __reduce_add_sync(0xFFFFFFFFu, hits);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(&s_hits, hits);
  __syncthreads();
  if (threadIdx.x == 0 && s_hits) atomicAdd(out, s_hits);
}

}  // namespace

extern "C" int xs_bloom_count(const void* words, const void* pos, const void* valid,
                              void* out, int64_t n, int num_hashes, int64_t num_words,
                              void* stream) {
  if (n <= 0) return 0;
  if (num_hashes < 1 || num_words < 1) return int(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = unsigned(blocks < 4096 ? blocks : 4096);
  bloom_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(pos),
      static_cast<const uint8_t*>(valid), n, num_hashes, num_words,
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
