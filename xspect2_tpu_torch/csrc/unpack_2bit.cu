// K1: 2-bit read-wire unpack with the invalid-base patch scatter.
//
// Replaces the unpack in xspect2_tpu/ops/query.py:query_packed_reads_device
// (the XLA shift/mask/reshape plus `codes.at[bad_rows, bad_cols].set(255,
// mode="drop")`).
//
// In:  packed   uint8 [n, l4]   base b of a read at bits 2*(b%4) of byte b/4
//      bad_rows int32 [m]       patch list: (row, col) of each invalid base;
//      bad_cols int32 [m]       entries outside [0,n) x [0,read_len) are
//                               sentinels and are dropped
// Out: codes    uint8 [n, read_len]   0..3, or 255 at every patch entry
//
// Bound: streaming bytes.  It reads n*l4 + 8*m bytes and writes
// n*read_len; there is no reuse to exploit.  Design: one thread per
// packed byte writes its (up to) four codes, so neighbouring threads
// touch neighbouring addresses on both sides; a second launch on the
// same stream scatters the patches after the unpack has finished.
// Nothing is allocated here; the caller owns every buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void unpack_kernel(const uint8_t* __restrict__ packed,
                              uint8_t* __restrict__ codes, int64_t n,
                              int l4, int read_len) {
  const int64_t total = n * int64_t(l4);
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < total;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t row = i / l4;
    const int byte = int(i - row * l4);
    const uint32_t v = packed[i];
    uint8_t* dst = codes + row * read_len + 4 * int64_t(byte);
    const int nb = min(4, read_len - 4 * byte);
    for (int s = 0; s < nb; ++s) dst[s] = uint8_t((v >> (2 * s)) & 3u);
  }
}

__global__ void patch_kernel(uint8_t* __restrict__ codes,
                             const int32_t* __restrict__ rows,
                             const int32_t* __restrict__ cols, int64_t m,
                             int64_t n, int read_len) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < m;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t r = rows[i];
    const int c = cols[i];
    if (r >= 0 && r < n && c >= 0 && c < read_len) codes[r * read_len + c] = 255;
  }
}

unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return unsigned(blocks < (1LL << 20) ? (blocks > 0 ? blocks : 1) : (1LL << 20));
}

}  // namespace

extern "C" int xs_unpack_2bit(const void* packed, void* codes, const void* bad_rows,
                              const void* bad_cols, int64_t n, int l4, int read_len,
                              int64_t num_patches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = n * int64_t(l4);
  if (total > 0) {
    unpack_kernel<<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(codes), n, l4,
        read_len);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (num_patches > 0) {
    patch_kernel<<<grid_for(num_patches), kThreads, 0, s>>>(
        static_cast<uint8_t*>(codes), static_cast<const int32_t*>(bad_rows),
        static_cast<const int32_t*>(bad_cols), num_patches, n, read_len);
  }
  return int(cudaGetLastError());
}
