// K2: fused read query, uniform-length reads -> per-read, per-class hits.
//
// Replaces xspect2_tpu/ops/query.py:make_reads_query_body.chunk_fn with
// _gather_and_probe and _accumulate_reads (the XLA window packing,
// canonical min, hash, 512 B block gather + masked AND-reduce and the
// lane-packed popcount), and computes what the Pallas `sel_kernel` of
// tools/microbench_pallas.py computes (the AND of the selected rows).
//
// In:  codes uint8  [n_reads, read_len]   0..3, >3 = invalid base
//      table uint32 [num_blocks, rows_per_block * class_words]
//            (the index's row-major layout, BlockedBitSlicedIndex.table,
//            16-byte aligned); in owned-block mode (local_blocks > 0) only the local_blocks
//            blocks from block_offset on, and out is this shard's share
// Out: out   int32  [n_reads, num_classes]  zeroed by the caller; this
//            kernel only adds into it
//
// For each kept window j = 0, step, 2*step, ... < nk (nk = read_len-k+1):
//   canonicalize, hash and probe as kmer_probe.cuh does (shared with K3
//   and K5), reading ONLY the probe words of the window's block.  A
//   window holding an invalid base counts nothing (this also zeroes the
//   padding rows, which are poisoned at every k-th base).
//
// Bound: random 32-byte sector reads of the table, one per probe word
// (h words per valid window when P>1; h rows of cw contiguous words when
// P=1, read as vectors, kmer_probe.cuh); the code bytes stream once.  The
// bench geometries' species and genus tables (~99 MB each) are twice the
// 50 MB L2, so most probes go to HBM; smaller tables sit in L2.  Design:
// a thread block owns a contiguous range of kept windows (in read-major
// order) and stages the codes they cover once in shared memory, 2-bit
// packed with an invalid-base mask beside them (records_block.cuh), so a
// window is O(1) register work, not k byte loads: window (r, j) is the
// staged window at flat position r*read_len + j of the [n_reads,
// read_len] codes, the stride kept.  The wrapper sizes the range
// (ops/query.py:_reads_block) so that the flat positions its windows
// start at span at most kMaxBlockPositions, whatever read_len, k and
// step; a read longer than that spans several blocks, a short one shares
// a block with its neighbours.  Read the probe words, never the whole
// 512 B block the TPU gathered (its gather-then-mask is a TPU shape; the
// AND of the selected rows is the same value), skip the table entirely
// for invalid windows, and count into shared-memory counters per (read,
// class) so global memory sees one atomic per non-zero counter per
// thread block; edge reads meet in the global atomics.  Set bits are
// walked with __ffs, so 512 classes (cw=16) cost one atomic per hit, not
// one test per class.  The counters of at least three reads must fit the
// shared-memory budget; the wrapper refuses more classes than that
// (2,730 at 32 KB).

#include <cstdint>
#include <cuda_runtime.h>

#include "records_block.cuh"

namespace {

struct Geom {
  int64_t n_reads;
  int64_t windows_per_block;
  int read_len;
  int step;
  int nkk;  // kept windows per read, ceil((read_len-k+1)/step)
  xs::ProbeGeom probe;
};

// the flat position of kept window w (read-major)
__device__ __forceinline__ int64_t window_position(int64_t w, const Geom& g) {
  const int64_t r = w / g.nkk;
  return r * g.read_len + (w - r * g.nkk) * g.step;
}

// The most flat positions from the first to the last of m + 1 consecutive
// kept windows, wherever they start: q whole reads and s more windows,
// and a read boundary crossed when s > 0 costs read_len - nkk*step more
// than the stride when that is positive (ops/query.py:_window_span).
int64_t window_span(int64_t m, int read_len, int step, int64_t nkk) {
  const int64_t q = m / nkk, s = m % nkk;
  const int64_t cross = read_len - nkk * step;
  return q * read_len + s * step + (s > 0 && cross > 0 ? cross : 0);
}

template <int Kind>
__global__ void __launch_bounds__(xs::kThreads, xs::min_blocks(Kind))
    reads_query_kernel(const uint8_t* __restrict__ codes, const uint32_t* __restrict__ table,
                       int32_t* __restrict__ out, const Geom g) {
  extern __shared__ int32_t s_counts[];
  __shared__ xs::StagedCodes s_codes;
  const int num_classes = g.probe.num_classes;
  const int64_t total = g.n_reads * g.nkk;
  const int64_t w0 = int64_t(blockIdx.x) * g.windows_per_block;
  const int64_t w1 = w0 + g.windows_per_block < total ? w0 + g.windows_per_block : total;
  const int64_t r0 = w0 / g.nkk;
  const int nr = int((w1 - 1) / g.nkk - r0 + 1);
  // the block's windows read codes [first window, last window + k)
  xs::stage_codes(codes, window_position(w0, g), window_position(w1 - 1, g) + g.probe.k, s_codes);
  for (int i = threadIdx.x; i < nr * num_classes; i += blockDim.x) s_counts[i] = 0;
  __syncthreads();

  for (int64_t w = w0 + threadIdx.x; w < w1; w += blockDim.x) {
    const int64_t r = w / g.nkk;
    uint32_t hi, lo;
    if (!xs::staged_window(s_codes, r * g.read_len + (w - r * g.nkk) * g.step, g.probe.k, hi, lo))
      continue;
    xs::probe_and_count<Kind>(table, g.probe, hi, lo, s_counts + (r - r0) * num_classes);
  }

  __syncthreads();
  xs::flush_counts(s_counts, out, int(r0), nr, num_classes);
}

}  // namespace

extern "C" int xs_reads_query(const void* codes, const void* table, void* out,
                              int64_t n_reads, int read_len, int k, int step,
                              int64_t num_blocks, int rows_per_block, int class_words,
                              int num_hashes, int fields_per_word, int num_classes,
                              int64_t windows_per_block, int max_reads,
                              int64_t block_offset, int64_t local_blocks, void* stream) {
  Geom g;
  g.n_reads = n_reads;
  g.windows_per_block = windows_per_block;
  g.read_len = read_len;
  g.step = step;
  g.nkk = (read_len - k + 1 + step - 1) / step;
  g.probe = xs::ProbeGeom{uint32_t(num_blocks), k, rows_per_block, class_words,
                          num_hashes, fields_per_word, num_classes,
                          uint32_t(block_offset), uint32_t(local_blocks)};
  const int64_t total = n_reads * g.nkk;
  if (total <= 0) return 0;
  if (windows_per_block < 1 ||
      window_span(windows_per_block - 1, read_len, step, g.nkk) >= xs::kMaxBlockPositions)
    return int(cudaErrorInvalidValue);
  const int64_t grid = (total + windows_per_block - 1) / windows_per_block;
  const size_t shared = size_t(max_reads) * size_t(num_classes) * sizeof(int32_t);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* t = static_cast<const uint32_t*>(table);
  auto* o = static_cast<int32_t*>(out);
  // one instantiation per probe path, so each carries only its registers
  switch (xs::probe_kind(fields_per_word, class_words)) {
    case xs::kFields:
      reads_query_kernel<xs::kFields><<<unsigned(grid), xs::kThreads, shared, s>>>(c, t, o, g);
      break;
    case xs::kRows4:
      reads_query_kernel<xs::kRows4><<<unsigned(grid), xs::kThreads, shared, s>>>(c, t, o, g);
      break;
    case xs::kRows2:
      reads_query_kernel<xs::kRows2><<<unsigned(grid), xs::kThreads, shared, s>>>(c, t, o, g);
      break;
    default:
      reads_query_kernel<xs::kRows1><<<unsigned(grid), xs::kThreads, shared, s>>>(c, t, o, g);
  }
  return int(cudaGetLastError());
}
