// Helpers of the wire kernels K1 (unpack_2bit.cu) and K4 (records_wire.cu):
// a warp-wide search of a sorted int32 list, and the four codes of one
// packed byte spread into four bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wire {

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Byte t (0..15) of ``v``.
__device__ __forceinline__ uint8_t byte_of(const uint4& v, int t) {
  const uint32_t w = t < 8 ? (t < 4 ? v.x : v.y) : (t < 12 ? v.z : v.w);
  return uint8_t(w >> (8 * (t & 3)));
}

// Stores the first ``n`` (< 16) bytes of ``v`` at ``dst``, one at a time.
__device__ __forceinline__ void store_head(uint8_t* dst, const uint4& v, int n) {
  for (int t = 0; t < n; ++t) dst[t] = byte_of(v, t);
}

// The first index i in [lo, hi) of the non-decreasing list ``a`` with
// a[i] >= x (kUpper false: a lower bound) or a[i] > x (kUpper true: an
// upper bound); hi when there is none.  Every lane of the calling warp
// takes part and gets the result.  Each round probes 32 evenly spaced
// entries at once and keeps the gap between the last probe before the
// bound and the first at or after it, so a list of 2^16 entries takes
// four dependent loads instead of sixteen.
template <bool kUpper>
__device__ int64_t warp_search(const int32_t* __restrict__ a, int64_t lo, int64_t hi, int64_t x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t s = (hi - lo + 31) >> 5;  // 32 * s >= hi - lo
    const int64_t i = lo + lane * s;
    bool before = false;
    if (i < hi) {
      const int64_t v = __ldg(a + i);
      before = kUpper ? v <= x : v < x;
    }
    // the probes before the bound are a prefix of the lanes
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    if (c == 0) return lo;
    const int64_t next_lo = lo + (c - 1) * s + 1;
    hi = min64(hi, lo + c * s);
    lo = next_lo;
  }
  const int64_t i = lo + lane;
  bool before = false;
  if (i < hi) {
    const int64_t v = __ldg(a + i);
    before = kUpper ? v <= x : v < x;
  }
  return lo + __popc(__ballot_sync(0xffffffffu, before));
}

// The four 2-bit codes of packed byte ``b`` (code j at bits 2j), code j
// in byte j of the result.
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  b = (b | (b << 12)) & 0x000F000Fu;
  return (b | (b << 6)) & 0x03030303u;
}

// The 16 codes of four packed bytes (byte j of ``w`` holds codes 4j..4j+3).
__device__ __forceinline__ uint4 spread16(uint32_t w) {
  return make_uint4(spread4(w & 0xFFu), spread4((w >> 8) & 0xFFu), spread4((w >> 16) & 0xFFu),
                    spread4(w >> 24));
}

}  // namespace wire
