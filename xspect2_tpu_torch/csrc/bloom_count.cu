// K7: membership count of hashed k-mers in a flat Bloom filter.
//
// Replaces xspect2_tpu/core/compat.py:XXH3BloomFilter.count_hits_device
// (the jitted gather, bit test, AND over the probes, mask and sum, lines
// 218-222): the device step of the xxh3 compat genus filter's own count
// API.  The XXH3-64 hashing of the ASCII k-mers stays on the host, as there.
//
// In:  words uint32 [num_words]  the filter's bits, bit b of word w is
//                                filter bit 32*w + b
//      pos   uint32 [n, h]       probe bit positions of each k-mer; any
//                                4-byte aligned start (a view at an offset)
//      valid uint8  [n]          k-mer counted at all; any start
// Out: out   int32  [1]          zeroed by the caller; number of valid
//                                k-mers whose h probe bits are all set
//
// A position at or past 32 * num_words is a miss.  The k-mer axis is
// not padded: the power-of-two padding of the JAX program bounds XLA
// recompiles and has no use here.
//
// Bound: bytes: the positions and validity streams (4h + 1 bytes a
// k-mer) plus one random 32-byte sector of the filter per probe of a
// valid k-mer (a 307 Mbit genus filter is 38 MB: it fits the 50 MB L2,
// the position stream beside it does not).  Design:
// - the filter stays in L2: the streams are read once with evict-first
//   loads (__ldcs), the filter words with an evict-last L2 cache policy
//   set per load (no persisting-L2 window, which would change the L2 for
//   every other kernel of the process);
// - coalesced streams: a block stages a tile of kTile consecutive
//   k-mers' positions (kTile * h contiguous words) and validity bytes in
//   shared memory with 16-byte loads, a scalar head up to the first
//   16-byte boundary and a scalar tail, so any aligned start is taken
//   without a copy; offsets are int64 (n * h may pass 2^31);
// - a k-mer's probes in flight together: the kernel is a template on h
//   up to kGroup; each thread issues the first kFirstProbes loads of its
//   kPerThread k-mers before testing any, then the rest together only for
//   the k-mers those all hit: the time follows the probes loaded, and at
//   non-members (half the filter's bits set) 3 of 4 k-mers stop after
//   two probes, while members load all h either way.  h > kGroup takes
//   groups of kGroup probes, stopping at the first group with a clear
//   bit, its positions staged up to h = kMaxStaged, read in place beyond;
// - a persistent grid: as many blocks as fit on the SMs, each walking
//   tiles; warp reductions and one atomic per block.
// The count is not zeroed inside the launch: that needs a counter that
// starts at zero across launches (memory shared between streams and
// graph captures) or a second pass; the caller's zeroed `out` costs one
// memset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;  // k-mers a tile
constexpr int kGroup = 8;                     // probes a k-mer keeps in flight
constexpr int kMaxStaged = 112;               // h up to which a tile's positions are staged (224 KB)
constexpr int kFirstProbes = 2;               // h <= kGroup: probes loaded before the first test

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// one filter word, kept in L2 ahead of the streams, not allocated in L1
__device__ __forceinline__ uint32_t load_word(const uint32_t* at, uint64_t policy) {
  uint32_t v;
  asm("ld.global.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(at), "l"(policy));
  return v;
}

// Stages src[0, count) into dst at the returned offset `off`, so that a
// 16-byte aligned vector of src lands on one of dst (dst is 16-byte
// aligned and holds count + 16 / sizeof(E) elements): a scalar head up to
// the first 16-byte boundary, 16-byte vectors, a scalar tail.
template <typename E>
__device__ __forceinline__ int stage(const E* __restrict__ src, int count, E* __restrict__ dst) {
  constexpr int V = 16 / int(sizeof(E));
  const int off = int((reinterpret_cast<uintptr_t>(src) / sizeof(E)) & (V - 1));
  const int head = min(count, (V - off) & (V - 1));
  const int nvec = (count - head) / V;
  const int tail = head + nvec * V;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(dst + off + head);
  for (int v = threadIdx.x; v < nvec; v += kThreads) vdst[v] = __ldcs(vsrc + v);
  const int t = threadIdx.x;
  if (t < head) dst[off + t] = __ldcs(src + t);
  if (t < count - tail) dst[off + tail + t] = __ldcs(src + tail + t);
  return off;
}

// AND of the probe bits p[0, cnt) (cnt <= kGroup), all loads issued first
__device__ __forceinline__ bool probe_group(const uint32_t* p, int cnt, const uint32_t* __restrict__ words,
                                            int64_t num_words, uint64_t policy) {
  uint32_t b[kGroup], w[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    b[j] = j < cnt ? p[j] : 0u;
    w[j] = j < cnt ? 0u : 1u;
    if (j < cnt && int64_t(b[j] >> 5) < num_words) w[j] = load_word(words + (b[j] >> 5), policy);
  }
  uint32_t all = 1u;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) all &= w[j] >> (b[j] & 31u);
  return all & 1u;
}

// H: the probe count when it is at most kGroup; 0: h > kGroup, in groups
template <int H>
__global__ void __launch_bounds__(kThreads) bloom_count_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ pos, const uint8_t* __restrict__ valid,
    int64_t n, int h, int64_t num_words, bool staged, int32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ int s_hits;
  const int pos_words = staged ? ((kTile * h + 4 + 3) & ~3) : 0;  // 16-byte multiple
  uint32_t* s_pos = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_pos + pos_words);
  if (threadIdx.x == 0) s_hits = 0;
  const uint64_t policy = evict_last_policy();
  const int64_t tiles = (n + kTile - 1) / kTile;
  int hits = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t first = tile * kTile;
    const int count = int(n - first < kTile ? n - first : kTile);
    const int pos_off = staged ? stage(pos + first * h, count * h, s_pos) : 0;
    const int valid_off = stage(valid + first, count, s_valid);
    __syncthreads();
    if constexpr (H > 0) {
      constexpr int F = kFirstProbes > 0 && kFirstProbes < H ? kFirstProbes : H;
      uint32_t b[kPerThread][H], w[kPerThread][H];
      bool live[kPerThread];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int i = threadIdx.x + r * kThreads;
        live[r] = i < count && s_valid[valid_off + i];
#pragma unroll
        for (int j = 0; j < H; ++j) {
          b[r][j] = live[r] ? s_pos[pos_off + i * H + j] : 0u;
          w[r][j] = 0u;
        }
#pragma unroll
        for (int j = 0; j < F; ++j)
          if (live[r] && int64_t(b[r][j] >> 5) < num_words) w[r][j] = load_word(words + (b[r][j] >> 5), policy);
      }
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        uint32_t all = live[r];
#pragma unroll
        for (int j = 0; j < F; ++j) all &= w[r][j] >> (b[r][j] & 31u);
        live[r] = all & 1u;
      }
      if constexpr (F < H) {
#pragma unroll
        for (int r = 0; r < kPerThread; ++r)
#pragma unroll
          for (int j = F; j < H; ++j)
            if (live[r] && int64_t(b[r][j] >> 5) < num_words) w[r][j] = load_word(words + (b[r][j] >> 5), policy);
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          uint32_t all = live[r];
#pragma unroll
          for (int j = F; j < H; ++j) all &= w[r][j] >> (b[r][j] & 31u);
          live[r] = all & 1u;
        }
      }
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) hits += int(live[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int i = threadIdx.x + r * kThreads;
        if (i >= count || !s_valid[valid_off + i]) continue;
        const uint32_t* row = staged ? s_pos + pos_off + int64_t(i) * h : pos + (first + i) * h;
        bool hit = true;
        for (int g = 0; g < h && hit; g += kGroup)
          hit = probe_group(row + g, min(kGroup, h - g), words, num_words, policy);
        hits += int(hit);
      }
    }
    __syncthreads();  // the tile's stage is read before the next overwrites it
  }
  hits = __reduce_add_sync(0xFFFFFFFFu, hits);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(&s_hits, hits);
  __syncthreads();
  if (threadIdx.x == 0 && s_hits) atomicAdd(out, s_hits);
}

// dynamic shared memory of a block: the staged positions (16-byte
// multiple), then the validity bytes and their 16 bytes of slack
size_t smem_bytes(int h, bool staged) {
  const size_t pos_words = staged ? size_t((kTile * h + 4 + 3) & ~3) : 0;
  return pos_words * 4 + kTile + 16;
}

// a failed runtime call's error, cleared so that the next launch's
// cudaGetLastError does not report it again
int fail(cudaError_t err) {
  cudaGetLastError();
  return int(err);
}

template <int H>
int launch(const uint32_t* words, const uint32_t* pos, const uint8_t* valid, int32_t* out, int64_t n, int h,
           int64_t num_words, cudaStream_t stream) {
  const bool staged = h <= kMaxStaged;
  const size_t smem = smem_bytes(h, staged);
  auto kernel = bloom_count_kernel<H>;
  // the grid's size, asked of the runtime at every launch (host work of
  // microseconds): the current device's SMs times the blocks that fit one
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return fail(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t resident = int64_t(per_sm) * sms;
  const unsigned grid = unsigned(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, smem, stream>>>(words, pos, valid, n, h, num_words, staged, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int xs_bloom_count(const void* words, const void* pos, const void* valid,
                              void* out, int64_t n, int num_hashes, int64_t num_words,
                              void* stream) {
  if (n <= 0) return 0;
  if (num_hashes < 1 || num_words < 1 || (reinterpret_cast<uintptr_t>(pos) & 3)) return int(cudaErrorInvalidValue);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* p = static_cast<const uint32_t*>(pos);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (num_hashes) {
    case 1: return launch<1>(w, p, v, o, n, num_hashes, num_words, s);
    case 2: return launch<2>(w, p, v, o, n, num_hashes, num_words, s);
    case 3: return launch<3>(w, p, v, o, n, num_hashes, num_words, s);
    case 4: return launch<4>(w, p, v, o, n, num_hashes, num_words, s);
    case 5: return launch<5>(w, p, v, o, n, num_hashes, num_words, s);
    case 6: return launch<6>(w, p, v, o, n, num_hashes, num_words, s);
    case 7: return launch<7>(w, p, v, o, n, num_hashes, num_words, s);
    case 8: return launch<8>(w, p, v, o, n, num_hashes, num_words, s);
    default: return launch<0>(w, p, v, o, n, num_hashes, num_words, s);
  }
}
