// K2: fused read query, uniform-length reads -> per-read, per-class hits.
//
// Replaces xspect2_tpu/ops/query.py:make_reads_query_body.chunk_fn with
// _gather_and_probe and _accumulate_reads (the XLA window packing,
// canonical min, hash, 512 B block gather + masked AND-reduce and the
// lane-packed popcount), and computes what the Pallas `sel_kernel` of
// tools/microbench_pallas.py computes (the AND of the selected rows).
//
// In:  codes uint8  [n_reads, read_len]   0..3, >3 = invalid base
//      table uint32 [num_blocks, class_words * rows_per_block]
//            (class-word-major device layout, BlockedBitSlicedIndex.device_table)
// Out: out   int32  [n_reads, num_classes]  zeroed by the caller; this
//            kernel only adds into it
//
// For each kept window j = 0, step, 2*step, ... < nk (nk = read_len-k+1):
//   pack forward and reverse-complement windows into (hi, lo) with
//   lo = the last min(k,16) bases, take the lexicographic min, hash with
//   fmix32 (xspect2_tpu/core/hashing.py), block = a % num_blocks, then read
//   ONLY the probe words: P=1 ANDs word (b+i*c)&(rpb-1) of each class word
//   over i<h; P>1 ANDs the probes of each slot s<min(h,P), rotates the
//   slot's word right by ((g+s)&(P-1))*fb and masks the result to fb bits.
//   A window holding an invalid base counts nothing (this also zeroes the
//   padding rows, which are poisoned at every k-th base).
//
// Bound: random 32-byte sector reads of the table, one per probe word
// (h words per valid window, cw*h when P=1); the code bytes stream
// and the hash is a few dozen integer operations.  The bench geometries'
// species and genus tables (~99 MB each) are twice the 50 MB L2, so most
// probes go to HBM; smaller tables sit in L2.  Design: read 4-byte probe words,
// never the whole 512 B block the TPU gathered (its gather-then-mask is
// a TPU shape; the AND of the selected rows is the same value), skip the
// table entirely for invalid windows, and count into shared-memory
// counters per (read, class) so global memory sees one atomic per
// non-zero counter per thread block.  A block owns a contiguous range of
// windows, so a long read spans several blocks and a short one shares a
// block with its neighbours; edge reads meet in the global atomics.
// Set bits are walked with __ffs, so 512 classes (cw=16) cost one
// atomic per hit, not one test per class.  The counters of at least three
// reads must fit the shared-memory budget; the wrapper refuses more
// classes than that (2,730 at 32 KB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Geom {
  int64_t n_reads;
  int64_t windows_per_block;
  uint32_t num_blocks;
  int read_len;
  int k;
  int step;
  int nkk;  // kept windows per read, ceil((read_len-k+1)/step)
  int rows_per_block;
  int class_words;
  int num_hashes;
  int fields_per_word;
  int num_classes;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// add one to counter [base + bit] for every set bit below num_classes
__device__ __forceinline__ void add_bits(uint32_t word, int base, int num_classes,
                                         int32_t* cnt) {
  while (word) {
    const int cls = base + __ffs(word) - 1;
    if (cls >= num_classes) break;
    atomicAdd(cnt + cls, 1);
    word &= word - 1;
  }
}

__global__ void reads_query_kernel(const uint8_t* __restrict__ codes,
                                   const uint32_t* __restrict__ table,
                                   int32_t* __restrict__ out, const Geom g) {
  extern __shared__ int32_t s_counts[];
  const int64_t total = g.n_reads * g.nkk;
  const int64_t w0 = int64_t(blockIdx.x) * g.windows_per_block;
  const int64_t w1 = w0 + g.windows_per_block < total ? w0 + g.windows_per_block : total;
  const int64_t r0 = w0 / g.nkk;
  const int nr = int((w1 - 1) / g.nkk - r0 + 1);
  for (int i = threadIdx.x; i < nr * g.num_classes; i += blockDim.x) s_counts[i] = 0;
  __syncthreads();

  const int lo_bases = min(g.k, 16);
  const uint64_t lo_mask = (1ull << (2 * lo_bases)) - 1ull;
  const uint32_t row_mask = uint32_t(g.rows_per_block - 1);
  const int64_t block_words = int64_t(g.class_words) * g.rows_per_block;
  const int P = g.fields_per_word;

  for (int64_t w = w0 + threadIdx.x; w < w1; w += blockDim.x) {
    const int64_t r = w / g.nkk;
    const int64_t j = (w - r * g.nkk) * g.step;
    const uint8_t* src = codes + r * g.read_len + j;

    // forward = sum c_t 4^(k-1-t); reverse complement = sum (3-c_t) 4^t
    uint64_t fwd = 0, rc = 0;
    bool bad = false;
    for (int t = 0; t < g.k; ++t) {
      const uint32_t c = src[t];
      bad |= c > 3u;
      const uint32_t cm = c & 3u;  // an invalid window is dropped below
      fwd = (fwd << 2) | cm;
      rc |= uint64_t(3u - cm) << (2 * t);
    }
    if (bad) continue;
    const uint32_t f_hi = uint32_t(fwd >> (2 * lo_bases)), f_lo = uint32_t(fwd & lo_mask);
    const uint32_t r_hi = uint32_t(rc >> (2 * lo_bases)), r_lo = uint32_t(rc & lo_mask);
    const bool fwd_le = (f_hi < r_hi) || (f_hi == r_hi && f_lo <= r_lo);
    const uint32_t hi = fwd_le ? f_hi : r_hi;
    const uint32_t lo = fwd_le ? f_lo : r_lo;

    const uint32_t u = fmix32(lo ^ 0x9E3779B1u);
    const uint32_t v = fmix32(hi ^ 0x85EBCA77u);
    const uint32_t a = fmix32(u ^ rotl32(v, 16) ^ 0xC2B2AE3Du);
    const uint32_t b = fmix32(v ^ rotl32(u, 13) ^ 0x27D4EB2Fu);
    const uint32_t c = fmix32((u + v) ^ 0x165667B1u) | 1u;

    const uint32_t* blk = table + int64_t(a % g.num_blocks) * block_words;
    int32_t* cnt = s_counts + (r - r0) * g.num_classes;
    if (P == 1) {
      for (int wd = 0; wd < g.class_words; ++wd) {
        const uint32_t* rows = blk + int64_t(wd) * g.rows_per_block;
        uint32_t acc = 0xFFFFFFFFu;
        uint32_t row = b;
        for (int i = 0; i < g.num_hashes; ++i) {
          acc &= __ldg(rows + (row & row_mask));
          row += c;
        }
        add_bits(acc, 32 * wd, g.num_classes, cnt);
      }
    } else {
      // P > 1 means fb < 32, so every shift below is defined
      const int fb = 32 / P;
      const uint32_t gbase = (b >> 24) & uint32_t(P - 1);
      const int slots = min(g.num_hashes, P);
      uint32_t acc = 0xFFFFFFFFu;
      for (int s = 0; s < slots; ++s) {
        uint32_t slot = 0xFFFFFFFFu;
        for (int i = s; i < g.num_hashes; i += P)
          slot &= __ldg(blk + ((b + uint32_t(i) * c) & row_mask));
        const uint32_t rot = ((gbase + uint32_t(s)) & uint32_t(P - 1)) * uint32_t(fb);
        if (rot) slot = (slot >> rot) | (slot << (32u - rot));
        acc &= slot;
      }
      add_bits(acc & ((1u << fb) - 1u), 0, g.num_classes, cnt);
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < nr * g.num_classes; i += blockDim.x) {
    const int32_t val = s_counts[i];
    if (val) atomicAdd(out + (r0 + i / g.num_classes) * g.num_classes + i % g.num_classes, val);
  }
}

}  // namespace

extern "C" int xs_reads_query(const void* codes, const void* table, void* out,
                              int64_t n_reads, int read_len, int k, int step,
                              int64_t num_blocks, int rows_per_block, int class_words,
                              int num_hashes, int fields_per_word, int num_classes,
                              int64_t windows_per_block, int max_reads, void* stream) {
  Geom g;
  g.n_reads = n_reads;
  g.windows_per_block = windows_per_block;
  g.num_blocks = uint32_t(num_blocks);
  g.read_len = read_len;
  g.k = k;
  g.step = step;
  g.nkk = (read_len - k + 1 + step - 1) / step;
  g.rows_per_block = rows_per_block;
  g.class_words = class_words;
  g.num_hashes = num_hashes;
  g.fields_per_word = fields_per_word;
  g.num_classes = num_classes;
  const int64_t total = n_reads * g.nkk;
  if (total <= 0) return 0;
  const int64_t grid = (total + windows_per_block - 1) / windows_per_block;
  const size_t shared = size_t(max_reads) * size_t(num_classes) * sizeof(int32_t);
  reads_query_kernel<<<unsigned(grid), kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint32_t*>(table),
      static_cast<int32_t*>(out), g);
  return int(cudaGetLastError());
}
