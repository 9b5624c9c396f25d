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
// Every variant reads each k-mer's whole 512 B block, as the TPU program
// does; this is what sets K10 apart from K2 (reads_query.cu), which reads
// only the probe words.  Bound: a k-mer's block is 16 sectors of 32 B, so
// the bytes are those of the distinct blocks touched, the reads and the
// output; the operations are counted from the function, the same for
// every selecting variant: ~90 a window for the pack and hash, h for the
// row mask, 3 a block word (bit test, select, AND) and the count (1 a
// block word and the h row ids for gatheronly), which exceed the bytes.
// The formulations' own extra work (current's h passes over every word)
// is not in the bound.  Design: one warp a read.
// The read's codes are staged in shared memory; lane l packs and hashes
// window t0 + l of each group of 32; then, for each k-mer of the group in
// turn, its block id is broadcast by a shuffle and every lane loads one
// 16 B vector of the block (the next k-mer's vector is loaded before the
// current one is reduced).  The selection compares each word's row with
// the k-mer's h rows; the AND (or, for current, each pass's sum) meets
// across the lanes that hold the same class word in xor shuffles: 5 steps
// row-major (fewer for 8 and 16 class words), log2(32 / cw) steps
// class-word-major, where a lane's four words share one class word.  Each
// variant and class-word count is an instantiation of one template, so no
// runtime branch on the variant sits in the loop.  The counts stay in
// registers (lane l counts class bit l of every class word; for the byte
// lanes, lane l counts bits l & 7 of the class words w = l >> 3 (mod 4))
// and each lane writes its classes once; a checksum meets in shuffles and
// one atomic a read adds it to its chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_probe.cuh"  // xs::kmer_hash, the index's hash

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockWords = 128;
constexpr int kMaxReadLen = 512;

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

template <int V, int CW>
__global__ void __launch_bounds__(kThreads)
body_kernel(const uint8_t* __restrict__ reads, const uint4* __restrict__ table,
            int32_t* __restrict__ counts, uint32_t* __restrict__ sums, int64_t n, int read_len, int k,
            uint32_t num_blocks, int num_hashes, int num_classes, int64_t reads_per_chunk) {
  constexpr bool kCwm = class_word_major(V);
  constexpr int kRpb = kBlockWords / CW;
  // row-major: the class-word slots a lane keeps (its four words' class
  // words, folded when cw < 4) and the first xor distance that crosses
  // lanes of the same slots
  constexpr int kSlots = CW < 4 ? CW : 4;
  constexpr int kLaneGroup = CW >= 4 ? CW / 4 : 1;
  // class-word-major: lanes that share one class word
  constexpr int kCwmLanes = 32 / CW;

  __shared__ uint8_t s_codes[kWarps][kMaxReadLen];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t read = int64_t(blockIdx.x) * kWarps + wib;
  if (read >= n) return;  // the whole warp
  uint8_t* codes = s_codes[wib];
  for (int p = lane; p < read_len; p += 32) codes[p] = reads[read * read_len + p];
  __syncwarp();

  const int nk = read_len - k + 1;
  const int lo_bases = k < 16 ? k : 16;
  const int hi_bases = k - lo_bases;
  const uint32_t row_mask = uint32_t(kRpb - 1);

  // the rows of this lane's four words
  int row_of[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) row_of[q] = kCwm ? (4 * lane + q) % kRpb : (4 * lane + q) / CW;

  int32_t cnt[CW];        // bit planes: class 32w + lane
  uint32_t cnt4[(CW + 3) / 4];  // byte lanes: classes 32w + (lane & 7) + 8b
#pragma unroll
  for (int w = 0; w < CW; ++w) cnt[w] = 0;
#pragma unroll
  for (int m = 0; m < (CW + 3) / 4; ++m) cnt4[m] = 0;
  uint32_t checksum = 0;

  for (int t0 = 0; t0 < nk; t0 += 32) {
    // this lane's window t0 + lane: pack, canonicalize and hash
    uint32_t my_blk = 0, my_b = 0, my_c = 0;
    const int t = t0 + lane;
    if (t < nk) {
      uint32_t f_hi = 0, f_lo = 0, r_hi = 0, r_lo = 0;
      for (int j = 0; j < k; ++j) {
        const uint32_t c = codes[t + j];
        const uint32_t cm = c > 3u ? 0u : c;
        if (j < hi_bases) f_hi = (f_hi << 2) | cm; else f_lo = (f_lo << 2) | cm;
      }
      for (int u = 0; u < k; ++u) {
        const uint32_t c = codes[t + k - 1 - u];
        const uint32_t cm = c > 3u ? 0u : 3u - c;
        if (u < hi_bases) r_hi = (r_hi << 2) | cm; else r_lo = (r_lo << 2) | cm;
      }
      const bool fwd_le = f_hi < r_hi || (f_hi == r_hi && f_lo <= r_lo);
      uint32_t a;
      xs::kmer_hash(fwd_le ? f_hi : r_hi, fwd_le ? f_lo : r_lo, a, my_b, my_c);
      my_blk = a % num_blocks;
      if (V == kGatherOnly)
        for (int i = 0; i < num_hashes; ++i) checksum += (my_b + uint32_t(i) * my_c) & row_mask;
    }
    const int group = nk - t0 < 32 ? nk - t0 : 32;
    uint4 next = __ldg(table + int64_t(__shfl_sync(0xFFFFFFFFu, my_blk, 0)) * (kBlockWords / 4) + lane);
    for (int j = 0; j < group; ++j) {
      const uint4 v = next;
      const uint32_t b = __shfl_sync(0xFFFFFFFFu, my_b, j);
      const uint32_t c = __shfl_sync(0xFFFFFFFFu, my_c, j);
      const uint32_t nb = __shfl_sync(0xFFFFFFFFu, my_blk, j + 1 < group ? j + 1 : j);
      if (j + 1 < group) next = __ldg(table + int64_t(nb) * (kBlockWords / 4) + lane);
      const uint32_t word[4] = {v.x, v.y, v.z, v.w};

      if constexpr (V == kGatherOnly) {
        checksum += v.x + v.y + v.z + v.w;
        continue;
      }

      // the AND of the k-mer's selected rows, per class word
      uint32_t acc[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) acc[s] = 0xFFFFFFFFu;
      if constexpr (V == kCurrent) {
        // h passes: keep the words of row r_i, sum each class word over
        // the rows, AND the passes' selections
        for (int i = 0; i < num_hashes; ++i) {
          const int r = int((b + uint32_t(i) * c) & row_mask);
          uint32_t sel[kSlots];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) sel[s] = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) sel[q % kSlots] += row_of[q] == r ? word[q] : 0u;
#pragma unroll
          for (int d = kLaneGroup; d < 32; d <<= 1)
#pragma unroll
            for (int s = 0; s < kSlots; ++s) sel[s] += __shfl_xor_sync(0xFFFFFFFFu, sel[s], d);
#pragma unroll
          for (int s = 0; s < kSlots; ++s) acc[s] &= sel[s];
        }
      } else {
        // one selected-row mask, unselected rows forced to all ones, one
        // AND-reduce
        bool selected[4] = {false, false, false, false};
        for (int i = 0; i < num_hashes; ++i) {
          const int r = int((b + uint32_t(i) * c) & row_mask);
#pragma unroll
          for (int q = 0; q < 4; ++q) selected[q] |= row_of[q] == r;
        }
        if constexpr (kCwm) {
          uint32_t x = 0xFFFFFFFFu;
#pragma unroll
          for (int q = 0; q < 4; ++q) x &= selected[q] ? word[q] : 0xFFFFFFFFu;
#pragma unroll
          for (int d = 1; d < kCwmLanes; d <<= 1) x &= __shfl_xor_sync(0xFFFFFFFFu, x, d);
          acc[0] = x;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q % kSlots] &= selected[q] ? word[q] : 0xFFFFFFFFu;
#pragma unroll
          for (int d = kLaneGroup; d < 32; d <<= 1)
#pragma unroll
            for (int s = 0; s < kSlots; ++s) acc[s] &= __shfl_xor_sync(0xFFFFFFFFu, acc[s], d);
        }
      }

      if constexpr (V == kNoPlanes) {
        if (lane < kLaneGroup)
#pragma unroll
          for (int s = 0; s < kSlots; ++s) checksum += acc[s];
      } else if constexpr (V == kCwmNoPlanes) {
        if (lane % kCwmLanes == 0) checksum += acc[0];
      } else {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          // the AND-ed word of class word w, from a lane that holds it
          uint32_t x;
          if constexpr (kCwm) {
            x = __shfl_sync(0xFFFFFFFFu, acc[0], w * kCwmLanes);
          } else if constexpr (CW >= 4) {
            x = __shfl_sync(0xFFFFFFFFu, acc[w & 3], w >> 2);
          } else {
            x = acc[w];
          }
          if constexpr (V == kCwMajorP4) {
            if ((w & 3) == (lane >> 3)) cnt4[w >> 2] += (x >> (lane & 7)) & 0x01010101u;
          } else {
            cnt[w] += int32_t((x >> lane) & 1u);
          }
        }
      }
    }
  }

  if constexpr (V >= kNoPlanes) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) checksum += __shfl_xor_sync(0xFFFFFFFFu, checksum, d);
    if (lane == 0) atomicAdd(sums + read / reads_per_chunk, checksum);
  } else if constexpr (V == kCwMajorP4) {
    int32_t* out = counts + read * num_classes;
#pragma unroll
    for (int m = 0; m < (CW + 3) / 4; ++m) {
      const int w = 4 * m + (lane >> 3);
      if (w < CW)
#pragma unroll
        for (int byte = 0; byte < 4; ++byte) {
          const int cls = 32 * w + (lane & 7) + 8 * byte;
          if (cls < num_classes) out[cls] = int32_t((cnt4[m] >> (8 * byte)) & 0xFFu);
        }
    }
  } else {
    int32_t* out = counts + read * num_classes;
#pragma unroll
    for (int w = 0; w < CW; ++w)
      if (32 * w + lane < num_classes) out[32 * w + lane] = cnt[w];
  }
}

template <int V, int CW>
void launch(unsigned grid, cudaStream_t s, const uint8_t* reads, const uint4* table, int32_t* counts,
            uint32_t* sums, int64_t n, int read_len, int k, uint32_t num_blocks, int num_hashes,
            int num_classes, int64_t reads_per_chunk) {
  body_kernel<V, CW><<<grid, kThreads, 0, s>>>(reads, table, counts, sums, n, read_len, k, num_blocks,
                                               num_hashes, num_classes, reads_per_chunk);
}

template <int V>
int launch_cw(int cw, unsigned grid, cudaStream_t s, const uint8_t* reads, const uint4* table,
              int32_t* counts, uint32_t* sums, int64_t n, int read_len, int k, uint32_t num_blocks,
              int num_hashes, int num_classes, int64_t reads_per_chunk) {
  switch (cw) {
    case 1: launch<V, 1>(grid, s, reads, table, counts, sums, n, read_len, k, num_blocks, num_hashes, num_classes, reads_per_chunk); break;
    case 2: launch<V, 2>(grid, s, reads, table, counts, sums, n, read_len, k, num_blocks, num_hashes, num_classes, reads_per_chunk); break;
    case 4: launch<V, 4>(grid, s, reads, table, counts, sums, n, read_len, k, num_blocks, num_hashes, num_classes, reads_per_chunk); break;
    case 8: launch<V, 8>(grid, s, reads, table, counts, sums, n, read_len, k, num_blocks, num_hashes, num_classes, reads_per_chunk); break;
    case 16: launch<V, 16>(grid, s, reads, table, counts, sums, n, read_len, k, num_blocks, num_hashes, num_classes, reads_per_chunk); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
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
      (variant == kCwMajorP4 && read_len - k + 1 > 255))
    return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const unsigned grid = unsigned((n + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(reads);
  const uint4* t = static_cast<const uint4*>(table);
  int32_t* counts = variant < kNoPlanes ? static_cast<int32_t*>(out) : nullptr;
  uint32_t* sums = variant < kNoPlanes ? nullptr : static_cast<uint32_t*>(out);
  const uint32_t nb = uint32_t(num_blocks);
#define XS_BODY_LAUNCH(V) \
  launch_cw<V>(class_words, grid, s, r, t, counts, sums, n, read_len, k, nb, num_hashes, num_classes, reads_per_chunk)
  switch (variant) {
    case kCurrent: return XS_BODY_LAUNCH(kCurrent);
    case kReduceAnd: return XS_BODY_LAUNCH(kReduceAnd);
    case kCwMajor: return XS_BODY_LAUNCH(kCwMajor);
    case kCwMajorP4: return XS_BODY_LAUNCH(kCwMajorP4);
    case kNoPlanes: return XS_BODY_LAUNCH(kNoPlanes);
    case kCwmNoPlanes: return XS_BODY_LAUNCH(kCwmNoPlanes);
    default: return XS_BODY_LAUNCH(kGatherOnly);
  }
#undef XS_BODY_LAUNCH
}
