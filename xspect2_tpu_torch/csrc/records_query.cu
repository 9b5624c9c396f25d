// K3: fused records query, flat positions of ragged records ->
// per-record, per-class hits.
//
// Replaces xspect2_tpu/ops/query.py:make_query_body.query_body with
// _gather_and_probe and _accumulate_segments (the XLA window packing,
// canonical min, hash, 512 B block gather + masked AND-reduce, and the
// per-record sum, which the TPU computes as a bf16 one-hot matmul on its
// MXU); the body of both query_hits_device (raw wire) and
// query_hits_packed_batch_device (compact wire, after K1 and K4).
//
// In:  codes   uint8 [n_pos + k - 1]  0..3, >3 = invalid base
//      rec_ids int32 [n_pos]          record of each position
//      valid   uint8 [n_pos]          window start kept (record span and
//                                     sparse-sampling phase)
//      table   uint32 [num_blocks, rows_per_block * class_words], the
//              index's row-major layout, 16-byte aligned; in owned-block
//              mode (local_blocks > 0) only the local_blocks blocks from
//              block_offset on, and out is this shard's share
// Out: out     int32 [max_records, num_classes]  zeroed by the caller;
//              this kernel only adds into it
//
// For each position p with valid[p], 0 <= rec_ids[p] < max_records and
// no invalid base in codes[p .. p+k-1], the window is packed,
// canonicalized, hashed and probed as kmer_probe.cuh does, and each set
// class bit adds one to out[rec_ids[p], class].  A record id outside
// [0, max_records) counts nothing, as the one-hot product drops it.
//
// Bound: random 32-byte sector reads of the table: the h probe rows of a
// counted window, each class_words contiguous words (P=1; one word when
// P>1), so at the 40-class geometry (cw=2, h=7, 512-byte blocks) ~5.8
// distinct sectors a window; the codes, record ids and validity stream
// (6 bytes per position).  Not bandwidth-bound: the table is 8x the L2,
// so the time is the latency of random sector reads.  Design: a thread
// block owns a contiguous range of at most kMaxBlockPositions positions
// and counts it as records_block.cuh says: codes staged 2-bit packed in
// shared memory (O(1) per window), a window's probe rows loaded as
// vectors all before the AND, counts per (record, class) in shared
// memory when the block's record span fits, with global atomics
// otherwise.  The wrapper picks the range length from the batch's
// shortest record so that the shared path is the common one.  Any class
// count works: with no counter row at all every block counts in global
// memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "records_block.cuh"

namespace {

struct Geom {
  int64_t n_pos;
  int64_t positions_per_block;
  int max_records;
  int counter_rows;  // records whose counters fit this block's shared memory
  xs::ProbeGeom probe;
};

template <int Kind>
__global__ void __launch_bounds__(xs::kThreads, xs::min_blocks(Kind))
    records_query_kernel(const uint8_t* __restrict__ codes,
                         const int32_t* __restrict__ rec_ids,
                         const uint8_t* __restrict__ valid,
                         const uint32_t* __restrict__ table,
                         int32_t* __restrict__ out, const Geom g) {
  extern __shared__ int32_t s_counts[];
  const int64_t p0 = int64_t(blockIdx.x) * g.positions_per_block;
  const int64_t p1 = p0 + g.positions_per_block < g.n_pos ? p0 + g.positions_per_block : g.n_pos;
  xs::count_records_block(codes, rec_ids, valid, out, p0, p1, g.max_records, g.counter_rows,
                          xs::TableProbe<Kind>{table, g.probe}, s_counts);
}

}  // namespace

extern "C" int xs_records_query(const void* codes, const void* rec_ids, const void* valid,
                                const void* table, void* out, int64_t n_pos, int k,
                                int64_t num_blocks, int rows_per_block, int class_words,
                                int num_hashes, int fields_per_word, int num_classes,
                                int max_records, int64_t positions_per_block,
                                int counter_rows, int64_t block_offset,
                                int64_t local_blocks, void* stream) {
  if (positions_per_block < 1 || positions_per_block > xs::kMaxBlockPositions)
    return int(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  Geom g;
  g.n_pos = n_pos;
  g.positions_per_block = positions_per_block;
  g.max_records = max_records;
  g.counter_rows = counter_rows;
  g.probe = xs::ProbeGeom{uint32_t(num_blocks), k, rows_per_block, class_words,
                          num_hashes, fields_per_word, num_classes,
                          uint32_t(block_offset), uint32_t(local_blocks)};
  const int64_t grid = (n_pos + positions_per_block - 1) / positions_per_block;
  const size_t shared = size_t(counter_rows) * size_t(num_classes) * sizeof(int32_t);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* r = static_cast<const int32_t*>(rec_ids);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* t = static_cast<const uint32_t*>(table);
  auto* o = static_cast<int32_t*>(out);
  switch (xs::probe_kind(fields_per_word, class_words)) {
    case xs::kFields:
      records_query_kernel<xs::kFields><<<unsigned(grid), xs::kThreads, shared, s>>>(c, r, v, t, o, g);
      break;
    case xs::kRows4:
      records_query_kernel<xs::kRows4><<<unsigned(grid), xs::kThreads, shared, s>>>(c, r, v, t, o, g);
      break;
    case xs::kRows2:
      records_query_kernel<xs::kRows2><<<unsigned(grid), xs::kThreads, shared, s>>>(c, r, v, t, o, g);
      break;
    default:
      records_query_kernel<xs::kRows1><<<unsigned(grid), xs::kThreads, shared, s>>>(c, r, v, t, o, g);
  }
  return int(cudaGetLastError());
}
