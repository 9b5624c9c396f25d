// K1: 2-bit read-wire unpack with the invalid-base patches, in one launch.
//
// Replaces the unpack in xspect2_tpu/ops/query.py:query_packed_reads_device
// (:754-760: the XLA shift/mask/reshape plus `codes.at[bad_rows,
// bad_cols].set(255, mode="drop")`).
//
// In:  packed    uint8 [n, l4]   base b of a read at bits 2*(b%4) of byte b/4
//      bad_rows  int32 [m]       patch list: (row, col) of each invalid base;
//      bad_cols  int32 [m]       entries outside [0,n) x [0,read_len) are
//                                sentinels and are dropped
//      ascending                 the rows of the list never decrease (as in
//                                every list pack_reads_wire emits: the N
//                                bases row-major, the padding rows, the
//                                sentinels)
// Out: codes     uint8 [n, read_len]   0..3, or 255 at every patch entry
//
// Bound: bytes.  It reads n*l4 + 8m bytes and writes n*read_len, with no
// reuse.  Design: the codes are one flat span of n*read_len bytes, and a
// block owns a tile of kTile consecutive bytes of it, whatever rows they
// fall in, so any read length takes the same shared memory.  The packed
// bytes under a tile are one contiguous span of at most kTile bytes (rows
// are contiguous, and every byte of the span holds a code of the tile):
// the block stages it in shared memory with 16-byte loads.  Each thread
// builds 16 consecutive codes (row and column from one 32-bit divide; a
// 5-byte window of the span when the 16 lie in one row, one window of each
// row when they cross a row end, a running column counter for rows shorter
// than 16) and writes them with one 16-byte store, neighbouring lanes on
// neighbouring addresses.  With an ascending list two warps find the tile's entries by
// a 32-way search of its row range, and the block sets them in a
// shared-memory copy of its codes before the store.  Any other list is
// scattered by a second, patch-only launch after the unpack.  No 64-bit
// divide per element: one 32-bit divide a thread for the tile's first row
// (64-bit past 2^32 codes) and one per 16 codes.  Nothing is allocated here.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wire_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 2;                          // 16-byte chunks a thread
constexpr int kTile = 16 * kThreads * kChunks;      // codes a block
// staged packed bytes: at most kTile + 30 (16 B aligned), and slack for the
// 5-byte windows that read a few bytes past the span (masked off)
constexpr int kSpan = kTile + 48;

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ packed, uint8_t* __restrict__ codes,
              const int32_t* __restrict__ bad_rows, const int32_t* __restrict__ bad_cols,
              int64_t n, int l4, int read_len, int64_t num_patches) {
  __shared__ __align__(16) uint8_t span[kSpan];
  __shared__ __align__(16) uint8_t tile[kTile];
  __shared__ int64_t s_lo, s_hi;

  const int tid = threadIdx.x;
  const int64_t total = n * int64_t(read_len);
  const int64_t o0 = int64_t(blockIdx.x) * kTile;
  const int len = int(wire::min64(kTile, total - o0));  // codes of this tile
  const int warp = tid >> 5;

  // the tile's first row: one divide a thread, 32-bit where the codes allow
  const int64_t row0 = total <= UINT32_MAX ? int64_t(uint32_t(o0) / uint32_t(read_len)) : o0 / read_len;
  const int col0 = int(o0 - row0 * read_len);
  // the last code's row, and the packed span [a, b) under the tile
  const int64_t row_last = row0 + (col0 + len - 1) / read_len;
  const int col_last = (col0 + len - 1) % read_len;
  const int64_t p0 = row0 * l4 + (col0 >> 2);
  const int64_t a = p0 & ~int64_t(15);
  const int64_t b = wire::min64((row_last * l4 + (col_last >> 2)) | 15, n * int64_t(l4) - 1) + 1;

  if (num_patches > 0 && warp < 2) {
    const int64_t at = warp == 0 ? wire::warp_search<false>(bad_rows, 0, num_patches, row0)
                                 : wire::warp_search<true>(bad_rows, 0, num_patches, row_last);
    if ((tid & 31) == 0) (warp == 0 ? s_lo : s_hi) = at;
  }
  for (int64_t i = a + 16 * int64_t(tid); i < b; i += 16 * kThreads) {
    uint8_t* dst = span + (i - a);
    if (i + 16 <= b) {
      *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(packed + i));
    } else {
      for (int j = 0; i + j < b; ++j) dst[j] = __ldg(packed + i + j);
    }
  }
  __syncthreads();

  // span index of the packed byte of (row0 + dr, c) is base + dr * l4 + (c >> 2)
  const int base = int(p0 - a) - (col0 >> 2);
  uint4 v[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int q = 16 * (tid + kThreads * j);
    if (q >= len) continue;
    const int dr = (col0 + q) / read_len;
    int c = col0 + q - dr * read_len;
    int at = base + dr * l4;
    if (c + 16 <= read_len) {  // one row: a 5-byte window of the span
      const uint8_t* s = span + at + (c >> 2);
      uint64_t w = uint64_t(s[0]) | uint64_t(s[1]) << 8 | uint64_t(s[2]) << 16 | uint64_t(s[3]) << 24;
      const int r = 2 * (c & 3);
      if (r) w |= uint64_t(s[4]) << 32;
      v[j] = wire::spread16(uint32_t(w >> r));
    } else if (read_len >= 16) {  // across one row end: a window of each row
      const int m = read_len - c;  // codes left in this row, 1..15
      const uint8_t* s = span + at + (c >> 2);
      const uint64_t w = uint64_t(s[0]) | uint64_t(s[1]) << 8 | uint64_t(s[2]) << 16 |
                         uint64_t(s[3]) << 24 | uint64_t(s[4]) << 32;
      const uint8_t* t = span + at + l4;  // the next row from column 0
      const uint32_t next = uint32_t(t[0]) | uint32_t(t[1]) << 8 | uint32_t(t[2]) << 16 | uint32_t(t[3]) << 24;
      v[j] = wire::spread16((uint32_t(w >> (2 * (c & 3))) & ((1u << (2 * m)) - 1)) | (next << (2 * m)));
    } else {  // rows shorter than 16 codes: a running column counter
      uint32_t word[4] = {0, 0, 0, 0};
      for (int t = 0; t < 16 && q + t < len; ++t) {
        const uint32_t code = (span[at + (c >> 2)] >> (2 * (c & 3))) & 3u;
        word[t >> 2] |= code << (8 * (t & 3));
        if (++c == read_len) {
          c = 0;
          at += l4;
        }
      }
      v[j] = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }

  // the tile's patch entries, set in a shared-memory copy of its codes
  const bool patched = num_patches > 0 && s_hi > s_lo;
  if (patched) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int q = 16 * (tid + kThreads * j);
      if (q < len) *reinterpret_cast<uint4*>(tile + q) = v[j];
    }
    __syncthreads();
    for (int64_t e = s_lo + tid; e < s_hi; e += kThreads) {
      const int c = __ldg(bad_cols + e);
      const int64_t f = (int64_t(__ldg(bad_rows + e)) - row0) * read_len + c - col0;
      if (c >= 0 && c < read_len && f >= 0 && f < len) tile[f] = 255;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int q = 16 * (tid + kThreads * j);
    if (q >= len) continue;
    if (patched) v[j] = *reinterpret_cast<const uint4*>(tile + q);
    uint8_t* dst = codes + o0 + q;
    if (q + 16 <= len) {
      *reinterpret_cast<uint4*>(dst) = v[j];
    } else {
      wire::store_head(dst, v[j], len - q);
    }
  }
}

// the patch list in any order, after the unpack
__global__ void patch_kernel(uint8_t* __restrict__ codes, const int32_t* __restrict__ rows,
                             const int32_t* __restrict__ cols, int64_t m, int64_t n, int read_len) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < m;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t r = rows[i];
    const int c = cols[i];
    if (r >= 0 && r < n && c >= 0 && c < read_len) codes[r * read_len + c] = 255;
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a geometry the tiles
// cannot take (rows past int32, a read longer than INT_MAX - kTile, l4 not
// ceil(read_len / 4)); packed and codes must be 16-byte aligned.
extern "C" int xs_unpack_2bit(const void* packed, void* codes, const void* bad_rows,
                              const void* bad_cols, int64_t n, int l4, int read_len,
                              int64_t num_patches, int ascending, void* stream) {
  if (n < 0 || n > INT_MAX || read_len < 1 || read_len > INT_MAX - kTile ||
      l4 != (read_len + 3) / 4 || num_patches < 0 ||
      (reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(codes)) & 15) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n * int64_t(read_len) + kTile - 1) / kTile;
  if (tiles == 0) return 0;
  if (tiles > INT_MAX) return int(cudaErrorInvalidValue);
  unpack_kernel<<<unsigned(tiles), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(codes),
      static_cast<const int32_t*>(bad_rows), static_cast<const int32_t*>(bad_cols), n, l4, read_len,
      ascending ? num_patches : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ascending || num_patches == 0) return int(err);
  const int64_t blocks = (num_patches + kThreads - 1) / kThreads;
  patch_kernel<<<unsigned(wire::min64(blocks, int64_t(1) << 20)), kThreads, 0, s>>>(
      static_cast<uint8_t*>(codes), static_cast<const int32_t*>(bad_rows),
      static_cast<const int32_t*>(bad_cols), num_patches, n, read_len);
  return int(cudaGetLastError());
}
