// K10: the seven formulations of the read query's body that the JAX
// package's tools/microbench_body.py times, each a kernel of its own.
//
// Replaces the jitted XLA programs of tools/microbench_body.py: the shared
// prologue pack_and_hash (:67), body_current (:106), body_reduceand (:126),
// body_cwmajor (:180), body_cwmajor_p4 (:229, with accum_planes4 :210),
// body_noplanes (:191), body_cwmajor_noplanes (:240) and body_gatheronly
// (:153), each scanned over chunks of reads by make_scan (:252).
//
// In:  reads uint8 [n, read_len], codes 0-3 (a code above 3 packs as 0 in
//      both strands and the window still counts, as in the tool)
//      table uint32 [num_blocks, 128], 16-byte aligned: each k-mer's block
//      is 512 B (rows_per_block * class_words = 128, class_words 1, 2, 4,
//      8 or 16).  Row-major (word (row, w) at row * cw + w, the index's own
//      layout) for current, reduceand, noplanes and gatheronly;
//      class-word-major (word (w, row) at w * rpb + row, the tool's
//      table_cwm) for cwmajor, cwmajor_p4 and cwm_noplanes.
// Out: the counting variants (current, reduceand, cwmajor, cwmajor_p4):
//      int32 [n, num_classes], each read's count of k-mers whose AND of
//      the h probe rows has the class bit set (the tool's bit planes, or
//      for cwmajor_p4 four classes a pass in byte lanes, read_len - k < 255)
//      the checksum variants (noplanes, cwm_noplanes, gatheronly): uint32
//      [ceil(n / reads_per_chunk)], zeroed by the caller; each chunk's sum
//      of the AND-ed words (noplanes) or of every gathered block word and
//      every probe row id (gatheronly), wrapping mod 2^32.  The wrapper
//      broadcasts a chunk's sum to its rows, as make_scan returns it.
//
// Every variant brings each k-mer's whole 512 B block from device memory
// into shared memory, in its own layout, as the TPU program gathers it;
// this is what sets K10 apart from K2 (reads_query.cu), which reads only
// the probe words.  Bound: a k-mer's block is 16 sectors of 32 B, so the
// bytes are those of the distinct blocks touched, the reads and the
// output; the operations are counted from the function, the same for
// every selecting variant: ~90 a window for the pack and hash, h for the
// row mask, 3 a block word (bit test, select, AND) and the count (1 a
// block word and the h row ids for gatheronly), which exceed the bytes.
// What holds the kernel is the whole-block read itself, 512 B a k-mer
// from the L2 or HBM (every block from HBM alone is 20x the bound at the
// tool's 50 MB input), and, behind it, the serial work of a warp between
// two of its groups: with one block of a few warps an SM (below), every
// instruction on that path costs its latency.
//
// Design: persistent warps, each with its own ring of kStages groups in
// shared memory, no barrier shared across warps.  A group is 32 windows
// of one read, one a lane (a read of 150 bp at k = 21 has four full
// groups and one of 2).  Once a read, the warp stages the read's codes
// (the aligned 32-bit words that cover it, loaded into registers one
// read ahead) and packs them into two 2-bit streams, forward and reverse
// complement; a window is then three words and two funnel shifts a
// strand, not k byte loads.  Lane l hashes window 32g + l, then starts
// the TMA bulk copy of its own k-mer's 512 B block into slot l of a stage
// (cp.async.bulk ... mbarrier::complete_tx::bytes, one instruction a
// k-mer); lane 0 arms the stage's mbarrier with the group's bytes, 512
// times its active lanes, and the wait's parity flips on each reuse of a
// stage.  Group g + kStages is hashed before the wait for group g, and
// its copy starts once g is reduced, into g's stage (after a
// fence.proxy.async); the ring runs across the warp's reads without
// draining.  kStages = 2 groups of 16 KB a warp; warps a block (at most
// kMaxWarps) are as many as the card's opt-in shared memory takes: 7 at
// 150 bp on an H100 (227 KB), one block an SM, so 112-224 KB of blocks in
// flight an SM, above the ~40 KB that Little's law asks at ~6.4 TB/s
// and ~0.8 us.  A deeper ring costs warps (3 stages: 4 warps) and ran
// slower on the H100.  The launch is sized once an instantiation, device
// and read length and cached (configure); xs_body_variants_config
// reports that launch.
//
// The reduction is one k-mer a lane, with no shuffle a k-mer: lane l
// reads the h x cw selected words of its own staged block (at r * cw + w,
// or w * rpb + r class-word-major; as 16 B or 8 B vectors where a row
// allows) and ANDs them; current computes the same AND (the sum of a
// pass over one selected row is that row's word).  Inactive lanes of a
// partial group copy nothing and hold 0, the neutral value of every
// count and sum.  Counting then takes the group's 32 words at once: for
// each class, __popc(__ballot_sync) (bit planes), or __reduce_add_sync
// of the byte lanes (cwmajor_p4: four classes a pass, at most 32 a byte
// a group and 255 windows a read, so no carry), kept by the lane of that
// class.  noplanes and cwm_noplanes keep a sum a lane; gatheronly sums
// the staged group with 16 B loads, lane l reading vector l of each
// block (512 contiguous bytes a warp load, no bank conflict), and adds
// the row ids of its own k-mer.  A read's counts are written once, its
// checksum meets in __reduce_add_sync and one atomic adds it to its
// chunk.  Each variant and class-word count is an instantiation of one
// template, so no runtime branch on the variant sits in the loop.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "kmer_probe.cuh"  // xs::kmer_hash, the index's hash

namespace {

constexpr int kBlockWords = 128;
constexpr int kBlockBytes = 4 * kBlockWords;
constexpr int kGroup = 32;                          // windows a group, one a lane
constexpr int kStages = 2;                          // groups a warp keeps staged
constexpr int kStageBytes = kGroup * kBlockBytes;   // 16 KB
constexpr int kMaxWarps = 8;
constexpr int kMaxReadLen = 512;
// registers a lane holds of the next read's code words: ceil((512 + 3) / 4 / 32)
constexpr int kCodeRegs = 5;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Variant : int {
  kCurrent = 0,
  kReduceAnd = 1,
  kCwMajor = 2,
  kCwMajorP4 = 3,
  kNoPlanes = 4,
  kCwmNoPlanes = 5,
  kGatherOnly = 6,
};

__host__ __device__ constexpr bool class_word_major(int v) {
  return v == kCwMajor || v == kCwMajorP4 || v == kCwmNoPlanes;
}

// shared bytes a warp keeps for one read: the aligned words that cover
// its codes (it may start at any byte), rounded up to 16 B, then its two
// 2-bit streams (forward and reverse complement), 16 bases a word and two
// words past the end for the last window's three-word read
__host__ __device__ constexpr int stream_words(int read_len) { return (read_len + 15) / 16 + 2; }
__host__ __device__ constexpr int code_bytes(int read_len) {
  return ((read_len + 6) / 4 * 4 + 15) / 16 * 16 + 8 * stream_words(read_len);
}

__host__ __device__ constexpr int warp_bytes(int read_len) {
  return kStages * (kStageBytes + 8) + code_bytes(read_len);
}

struct Args {
  const uint8_t* reads;
  const uint32_t* table;
  int32_t* counts;
  uint32_t* sums;
  int64_t n;
  int64_t reads_per_chunk;
  uint32_t num_blocks;
  int read_len;
  int k;
  int num_hashes;
  int num_classes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete (acquire: the copied
// bytes are visible after it)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy of one 512 B block, completing on `bar`
__device__ __forceinline__ void copy_block(void* dst, const uint32_t* src, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(uint32_t(kBlockBytes)), "r"(smem_addr(bar))
               : "memory");
}

// the k bases from base t of a 2-bit stream (16 bases a word, the first
// in the top bits), the first base in the top bits of the result
__device__ __forceinline__ uint64_t window_bits(const uint32_t* stream, int t, int k) {
  const uint32_t* w = stream + (t >> 4);
  const int s = 2 * (t & 15);
  const uint32_t hi = __funnelshift_l(w[1], w[0], s);
  const uint32_t lo = __funnelshift_l(w[2], w[1], s);
  return ((uint64_t(hi) << 32) | lo) >> (64 - 2 * k);
}

// window t of the staged read: its forward and reverse-complement packings
// from the two streams, the canonical min, hashed (xs::kmer_hash) to its
// block and row start and stride
__device__ __forceinline__ void hash_window(const uint32_t* fwd_stream, const uint32_t* rc_stream, int t,
                                            int read_len, int k, uint32_t num_blocks, uint32_t& blk, uint32_t& b,
                                            uint32_t& c) {
  const uint64_t fwd = window_bits(fwd_stream, t, k);
  const uint64_t rc = window_bits(rc_stream, read_len - t - k, k);
  const uint64_t canon = fwd <= rc ? fwd : rc;
  const int lo_bits = 2 * (k < 16 ? k : 16);
  uint32_t a;
  xs::kmer_hash(uint32_t(canon >> lo_bits), uint32_t(canon & ((uint64_t(1) << lo_bits) - 1)), a, b, c);
  blk = a % num_blocks;
}

template <int V, int CW>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) body_kernel(const Args a) {
  constexpr bool kCwm = class_word_major(V);
  constexpr int kRpb = kBlockWords / CW;
  constexpr bool kCounting = V < kNoPlanes;
  extern __shared__ __align__(128) uint8_t smem[];

  const int warps = blockDim.x >> 5;
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int read_len = a.read_len;
  uint8_t* stages = smem + size_t(wib) * kStages * kStageBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + size_t(warps) * kStages * kStageBytes) + wib * kStages;
  uint32_t* code_words = reinterpret_cast<uint32_t*>(smem + size_t(warps) * kStages * (kStageBytes + 8) +
                                                     size_t(wib) * code_bytes(read_len));
  uint32_t* fwd_stream = code_words + (code_bytes(read_len) / 4 - 2 * stream_words(read_len));
  uint32_t* rc_stream = fwd_stream + stream_words(read_len);
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // this warp's reads: first, first + stride, ...; every barrier below is
  // the warp's own, so a warp without reads may leave
  const int64_t first = int64_t(blockIdx.x) * warps + wib;
  const int64_t stride = int64_t(gridDim.x) * warps;
  if (first >= a.n) return;
  const int64_t my_reads = (a.n - 1 - first) / stride + 1;
  const int nk = read_len - a.k + 1;
  const int groups = (nk + kGroup - 1) / kGroup;
  const int64_t total = my_reads * groups;
  const uint32_t row_mask = uint32_t(kRpb - 1);

  // the next read's code words, held in registers until its codes are staged
  uint32_t pre[kCodeRegs];
  int pre_off = 0, pre_words = 0;
  auto prefetch = [&](int64_t read) {
    const uintptr_t start = reinterpret_cast<uintptr_t>(a.reads + read * read_len);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(start & ~uintptr_t(3));
    pre_off = int(start & 3);
    pre_words = (pre_off + read_len + 3) >> 2;
#pragma unroll
    for (int m = 0; m < kCodeRegs; ++m) {
      const int w = lane + 32 * m;
      pre[m] = w < pre_words ? __ldg(src + w) : 0u;
    }
  };
  // stage the prefetched read: its code bytes, then lane j packs word j of
  // the forward stream (bases 16j .. 16j + 15) and of the reverse-complement
  // stream (its base p is the complement of base read_len - 1 - p); a code
  // above 3, and a base past the read, packs as 0 in both
  auto stage_read = [&]() {
    __syncwarp();  // every lane is done with the previous read's streams
#pragma unroll
    for (int m = 0; m < kCodeRegs; ++m)
      if (lane + 32 * m < pre_words) code_words[lane + 32 * m] = pre[m];
    __syncwarp();
    const uint8_t* codes = reinterpret_cast<const uint8_t*>(code_words) + pre_off;
    if (16 * lane < read_len) {
      uint32_t f = 0, r = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int p = 16 * lane + i;
        const uint32_t x = p < read_len ? codes[p] : 4u;
        const uint32_t y = p < read_len ? codes[read_len - 1 - p] : 4u;
        f = (f << 2) | (x > 3u ? 0u : x);
        r = (r << 2) | (y > 3u ? 0u : 3u - y);
      }
      fwd_stream[lane] = f;
      rc_stream[lane] = r;
    }
    __syncwarp();
  };

  // hash cursor: the read (as an index among this warp's) and group
  int64_t h_read = 0;
  int h_group = 0;
  // the window of this lane in the group at the hash cursor: its block and
  // hash words, and the group's active lanes; then advance the cursor
  auto hash_group = [&](uint32_t& blk, uint32_t& b, uint32_t& c) -> int {
    if (h_group == 0) {
      stage_read();
      if (h_read + 1 < my_reads) prefetch(first + (h_read + 1) * stride);
    }
    const int t0 = h_group * kGroup;
    const int active = nk - t0 < kGroup ? nk - t0 : kGroup;
    blk = b = c = 0;
    if (lane < active) hash_window(fwd_stream, rc_stream, t0 + lane, read_len, a.k, a.num_blocks, blk, b, c);
    if (++h_group == groups) h_group = 0, ++h_read;
    return active;
  };

  // arm stage s for `active` blocks and start this lane's copy; every
  // lane's reads of the stage's last group come first (generic-proxy
  // reads before the async-proxy writes)
  auto issue = [&](int s, int active, uint32_t blk) {
    if (lane == 0) mbar_expect_tx(bar + s, uint32_t(active) * kBlockBytes);
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (lane < active)
      copy_block(stages + s * kStageBytes + lane * kBlockBytes, a.table + int64_t(blk) * kBlockWords, bar + s);
  };

  int32_t cnt[CW];                          // bit planes: class 32w + lane
  uint32_t cnt4[V == kCwMajorP4 ? CW : 1];  // byte lanes (lanes 0-7): classes 32w + lane + 8 byte
#pragma unroll
  for (int w = 0; w < CW; ++w) cnt[w] = 0;
#pragma unroll
  for (int w = 0; w < (V == kCwMajorP4 ? CW : 1); ++w) cnt4[w] = 0;
  uint32_t checksum = 0;

  // reduce cursor
  int64_t r_read = 0;
  int r_group = 0;
  // wait for stage s and reduce its group: this lane's k-mer's AND of its
  // selected rows per class word (0 for an inactive lane), counted or
  // summed across the group, or for gatheronly the sum of the group's
  // blocks; after a read's last group, write its counts or add its
  // checksum to its chunk
  auto reduce = [&](int s, uint32_t parity, uint32_t b, uint32_t c) {
    mbar_wait(bar + s, parity);
    const uint8_t* stage = stages + s * kStageBytes;
    const int t0 = r_group * kGroup;
    const int active = nk - t0 < kGroup ? nk - t0 : kGroup;
    if constexpr (V == kGatherOnly) {
      const uint4* v = reinterpret_cast<const uint4*>(stage);
      for (int j = 0; j < active; ++j) {
        const uint4 y = v[j * (kBlockBytes / 16) + lane];
        checksum += y.x + y.y + y.z + y.w;
      }
      if (lane < active)
        for (int i = 0; i < a.num_hashes; ++i) checksum += (b + uint32_t(i) * c) & row_mask;
    } else {
      uint32_t x[CW];
#pragma unroll
      for (int w = 0; w < CW; ++w) x[w] = lane < active ? kFull : 0u;
      if (lane < active) {
        const uint32_t* blk = reinterpret_cast<const uint32_t*>(stage + lane * kBlockBytes);
        for (int i = 0; i < a.num_hashes; ++i) {
          const uint32_t r = (b + uint32_t(i) * c) & row_mask;
          if constexpr (kCwm) {
#pragma unroll
            for (int w = 0; w < CW; ++w) x[w] &= blk[w * kRpb + r];
          } else if constexpr (CW % 4 == 0) {
#pragma unroll
            for (int w = 0; w < CW; w += 4) {
              const uint4 y = *reinterpret_cast<const uint4*>(blk + r * CW + w);
              x[w] &= y.x, x[w + 1] &= y.y, x[w + 2] &= y.z, x[w + 3] &= y.w;
            }
          } else if constexpr (CW == 2) {
            const uint2 y = *reinterpret_cast<const uint2*>(blk + r * CW);
            x[0] &= y.x, x[1] &= y.y;
          } else {
            x[0] &= blk[r];
          }
        }
      }
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        const int bits = a.num_classes - 32 * w < 32 ? a.num_classes - 32 * w : 32;
        if constexpr (!kCounting) {
          checksum += x[w];
        } else if constexpr (V == kCwMajorP4) {
#pragma unroll
          for (int c0 = 0; c0 < 8; ++c0) {
            if (c0 < bits) {
              const uint32_t y = __reduce_add_sync(kFull, (x[w] >> c0) & 0x01010101u);
              cnt4[w] += lane == c0 ? y : 0u;
            }
          }
        } else {
#pragma unroll 8
          for (int c0 = 0; c0 < bits; ++c0) {
            const int y = __popc(__ballot_sync(kFull, (x[w] >> c0) & 1u));
            cnt[w] += lane == c0 ? y : 0;
          }
        }
      }
    }
    if (++r_group < groups) return;
    const int64_t read = first + r_read * stride;
    r_group = 0, ++r_read;
    if constexpr (!kCounting) {
      const uint32_t sum = __reduce_add_sync(kFull, checksum);
      if (lane == 0) atomicAdd(a.sums + read / a.reads_per_chunk, sum);
      checksum = 0;
    } else if constexpr (V == kCwMajorP4) {
      int32_t* out = a.counts + read * a.num_classes;
      if (lane < 8) {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
#pragma unroll
          for (int byte = 0; byte < 4; ++byte) {
            const int cls = 32 * w + lane + 8 * byte;
            if (cls < a.num_classes) out[cls] = int32_t((cnt4[w] >> (8 * byte)) & 0xFFu);
          }
          cnt4[w] = 0;
        }
      }
    } else {
      int32_t* out = a.counts + read * a.num_classes;
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        if (32 * w + lane < a.num_classes) out[32 * w + lane] = cnt[w];
        cnt[w] = 0;
      }
    }
  };

  // the ring: groups 0 .. kStages - 1 in flight, then for each group q,
  // hash group q + kStages, wait for and reduce q, refill q's stage
  uint32_t held_b[kStages], held_c[kStages];
  prefetch(first);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    held_b[s] = held_c[s] = 0;
    if (s < total) {
      uint32_t blk;
      const int active = hash_group(blk, held_b[s], held_c[s]);
      issue(s, active, blk);
    }
  }
  int s = 0;
  uint32_t parity = 0;
  for (int64_t q = 0; q < total; ++q) {
    const bool refill = q + kStages < total;
    uint32_t blk = 0, nb = 0, nc = 0;
    int active = 0;
    if (refill) active = hash_group(blk, nb, nc);
    reduce(s, parity, held_b[0], held_c[0]);
    if (refill) issue(s, active, blk);
#pragma unroll
    for (int j = 0; j + 1 < kStages; ++j) held_b[j] = held_b[j + 1], held_c[j] = held_c[j + 1];
    held_b[kStages - 1] = nb, held_c[kStages - 1] = nc;
    if (++s == kStages) s = 0, parity ^= 1u;
  }
}

// a failed runtime call's error, cleared so that the next launch's
// cudaGetLastError does not report it again
int fail(cudaError_t err) {
  cudaGetLastError();
  return int(err);
}

// the launch of one instantiation at one read length on one device
struct Launch {
  int warps;     // warps a block
  int smem;      // dynamic shared memory a block, bytes
  int per_sm;    // blocks an SM
  int sms;       // the card's SMs
  int optin;     // the card's opt-in shared memory a block, bytes
  int regs;      // registers a thread
  int stages;    // groups a warp keeps staged
};

constexpr int kMaxDevices = 16;

// the warps a block that the card's opt-in shared memory holds at
// read_len, one block an SM; asked of the runtime once an instantiation,
// device and read length (the last one asked is kept: a timed loop calls
// one read length over and over), then served from the cache
template <int V, int CW>
cudaError_t configure(int read_len, Launch& out) {
  static std::mutex mu;
  static Launch cache[kMaxDevices];
  static int cached_len[kMaxDevices];  // 0: nothing cached
  auto kernel = body_kernel<V, CW>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kMaxDevices && cached_len[dev] == read_len) {
    out = cache[dev];
    return cudaSuccess;
  }
  Launch c{};
  c.stages = kStages;
  err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int per_warp = warp_bytes(read_len);
  c.warps = c.optin / per_warp < kMaxWarps ? c.optin / per_warp : kMaxWarps;
  if (c.warps < 1) return cudaErrorInvalidConfiguration;
  c.smem = c.warps * per_warp;
  cudaFuncAttributes attr;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, c.warps * 32, c.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
  c.regs = attr.numRegs;
  if (dev < kMaxDevices) cache[dev] = c, cached_len[dev] = read_len;
  out = c;
  return cudaSuccess;
}

// configure instantiation (V, CW) at read_len into `cfg`, then launch it
// on `a` unless `a` is null
template <int V, int CW>
int launch(int read_len, const Args* a, Launch& cfg, cudaStream_t stream) {
  const cudaError_t err = configure<V, CW>(read_len, cfg);
  if (err != cudaSuccess) return fail(err);
  if (a == nullptr) return 0;
  const int64_t blocks = (a->n + cfg.warps - 1) / cfg.warps;
  const int64_t resident = int64_t(cfg.per_sm) * cfg.sms;
  body_kernel<V, CW><<<unsigned(blocks < resident ? blocks : resident), cfg.warps * 32, cfg.smem, stream>>>(*a);
  return int(cudaGetLastError());
}

template <int V>
int launch_cw(int cw, int read_len, const Args* a, Launch& cfg, cudaStream_t s) {
  switch (cw) {
    case 1: return launch<V, 1>(read_len, a, cfg, s);
    case 2: return launch<V, 2>(read_len, a, cfg, s);
    case 4: return launch<V, 4>(read_len, a, cfg, s);
    case 8: return launch<V, 8>(read_len, a, cfg, s);
    case 16: return launch<V, 16>(read_len, a, cfg, s);
    default: return int(cudaErrorInvalidValue);
  }
}

int dispatch(int variant, int cw, int read_len, const Args* a, Launch& cfg, cudaStream_t s) {
  switch (variant) {
    case kCurrent: return launch_cw<kCurrent>(cw, read_len, a, cfg, s);
    case kReduceAnd: return launch_cw<kReduceAnd>(cw, read_len, a, cfg, s);
    case kCwMajor: return launch_cw<kCwMajor>(cw, read_len, a, cfg, s);
    case kCwMajorP4: return launch_cw<kCwMajorP4>(cw, read_len, a, cfg, s);
    case kNoPlanes: return launch_cw<kNoPlanes>(cw, read_len, a, cfg, s);
    case kCwmNoPlanes: return launch_cw<kCwmNoPlanes>(cw, read_len, a, cfg, s);
    default: return launch_cw<kGatherOnly>(cw, read_len, a, cfg, s);
  }
}

}  // namespace

// out: int32 [n, num_classes] for variants 0-3; uint32 [ceil(n / reads_per_chunk)],
// zeroed, for variants 4-6
extern "C" int xs_body_variants(const void* reads, const void* table, void* out, int64_t n, int read_len,
                                int k, int64_t num_blocks, int rows_per_block, int class_words,
                                int num_hashes, int num_classes, int64_t reads_per_chunk, int variant,
                                void* stream) {
  if (variant < kCurrent || variant > kGatherOnly || k < 1 || k > 32 || read_len < k ||
      read_len > kMaxReadLen || num_blocks < 1 || num_blocks > int64_t(UINT32_MAX) ||
      rows_per_block * class_words != kBlockWords || num_hashes < 1 || reads_per_chunk < 1 ||
      num_classes <= 32 * (class_words - 1) || num_classes > 32 * class_words ||
      (variant == kCwMajorP4 && read_len - k + 1 > 255) || (reinterpret_cast<uintptr_t>(table) & 15))
    return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const bool counting = variant < kNoPlanes;
  const Args a{static_cast<const uint8_t*>(reads), static_cast<const uint32_t*>(table),
               counting ? static_cast<int32_t*>(out) : nullptr, counting ? nullptr : static_cast<uint32_t*>(out),
               n, reads_per_chunk, uint32_t(num_blocks), read_len, k, num_hashes, num_classes};
  Launch cfg;
  return dispatch(variant, class_words, read_len, &a, cfg, static_cast<cudaStream_t>(stream));
}

// the launch xs_body_variants makes for `variant` at `class_words` and
// `read_len` on the current device, as 7 ints: warps a block, dynamic
// shared memory a block (bytes), blocks an SM, SMs, the card's opt-in
// shared memory a block (bytes), registers a thread, groups a warp stages
extern "C" int xs_body_variants_config(int read_len, int variant, int class_words, int* out) {
  if (variant < kCurrent || variant > kGatherOnly || read_len < 1 || read_len > kMaxReadLen)
    return int(cudaErrorInvalidValue);
  Launch cfg;
  const int rc = dispatch(variant, class_words, read_len, nullptr, cfg, nullptr);
  if (rc != 0) return rc;
  const int vals[7] = {cfg.warps, cfg.smem, cfg.per_sm, cfg.sms, cfg.optin, cfg.regs, cfg.stages};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
