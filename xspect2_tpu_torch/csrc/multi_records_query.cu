// K5: records query against several index tables over one position
// stream: flat positions of ragged records -> per-record, per-class hits
// of every table, in one launch per probe path.
//
// Replaces the per-table loop of xspect2_tpu/ops/query.py:
// make_multi_packed_query (query_hits_packed_batch_device once per
// table inside one XLA program, lines 905-908 and 919-922): the device
// program of MLST strain typing, one table per locus, one class per
// allele.  K1 and K4 restore codes, record ids and validity from the
// packed wire once; this kernel reads them for every table.
//
// In:  codes   uint8 [n_pos + k - 1]  0..3, >3 = invalid base
//      rec_ids int32 [n_pos]          record of each position
//      valid   uint8 [n_pos]          window start kept
//      tables  L pointers, table l = uint32 [num_blocks_l,
//              rows_per_block_l * class_words_l], the index's row-major
//              layout, 16-byte aligned
//      geom    int64 [L, 8]: num_blocks, rows_per_block, class_words,
//              num_hashes, fields_per_word, num_classes,
//              positions_per_block, counter_rows of each table
// Out: outs    L pointers, out l = int32 [max_records, num_classes_l],
//              zeroed by the caller; this kernel only adds into them
//
// All tables share k, max_records, the positions and their probe path
// (probe_kind of kmer_probe.cuh: the wrapper launches once per path
// among a group's tables); every other geometry number is the table's
// own.  Table l's counts are those of K3 (records_query.cu) on the same
// inputs: padding positions carry record id 0 and are never valid, a
// record id outside [0, max_records) counts nothing.
//
// Bound: random 32-byte sector reads of the tables: one probe row of
// class_words contiguous words per counted window and table at the MLST
// geometry (1,000 alleles: cw=32, h=1, a 128-byte row in 1-KB blocks,
// 4 sectors); the codes, record ids and validity stream (6 bytes per
// position).  Design: gridDim.y runs over the tables (table-major), so
// the blocks in flight probe one table (53.7 MB at MLST, about the L2)
// while each window is packed and hashed once per table.  A thread
// block owns a range of at most kMaxBlockPositions positions of one
// table and counts it as records_block.cuh says (codes staged 2-bit
// packed in shared memory, a probe row read as uint4 loads all issued
// before the AND, counts per (record, class) in shared memory when the
// block's record span fits).  Each table cuts the positions into its
// own ranges (positions_per_block_l, sized by the wrapper from its
// class count); blocks past the end of a table's ranges exit.  Hashing
// each window once for all tables (window-major) was timed and dropped:
// slower at the MLST group shape like for like, and it needs a block
// body of its own (PERF.md).
// The table descriptors travel by value in the kernel's parameters: at
// most kMaxTables tables.

#include <cstdint>
#include <cuda_runtime.h>

#include "records_block.cuh"

namespace {

constexpr int kMaxTables = 16;

struct TableArgs {
  const uint32_t* table;
  int32_t* out;
  int64_t positions_per_block;
  int counter_rows;  // records whose counters fit a block's shared memory
  xs::ProbeGeom probe;
};

struct MultiArgs {
  int64_t n_pos;
  int max_records;
  TableArgs t[kMaxTables];
};

template <int Kind>
__global__ void __launch_bounds__(xs::kThreads, xs::min_blocks(Kind))
    multi_records_query_kernel(const uint8_t* __restrict__ codes,
                               const int32_t* __restrict__ rec_ids,
                               const uint8_t* __restrict__ valid,
                               const __grid_constant__ MultiArgs a) {
  extern __shared__ int32_t s_counts[];
  const TableArgs& t = a.t[blockIdx.y];
  const int64_t p0 = int64_t(blockIdx.x) * t.positions_per_block;
  if (p0 >= a.n_pos) return;  // uniform over the block
  const int64_t p1 = p0 + t.positions_per_block < a.n_pos ? p0 + t.positions_per_block : a.n_pos;
  xs::count_records_block(codes, rec_ids, valid, t.out, p0, p1, a.max_records, t.counter_rows,
                          xs::TableProbe<Kind>{t.table, t.probe}, s_counts);
}

template <int Kind>
void launch(int64_t grid_x, int num_tables, size_t shared, cudaStream_t s, const uint8_t* c,
            const int32_t* r, const uint8_t* v, const MultiArgs& a) {
  const dim3 grid{unsigned(grid_x), unsigned(num_tables), 1u};
  multi_records_query_kernel<Kind><<<grid, xs::kThreads, shared, s>>>(c, r, v, a);
}

}  // namespace

extern "C" int xs_multi_records_query(const void* codes, const void* rec_ids,
                                      const void* valid, int64_t n_pos, int k,
                                      int max_records, int num_tables,
                                      const void* const* tables, void* const* outs,
                                      const int64_t* geom, void* stream) {
  if (num_tables < 1 || num_tables > kMaxTables) return int(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  MultiArgs a;
  a.n_pos = n_pos;
  a.max_records = max_records;
  int64_t grid_x = 1;
  size_t shared = 0;
  const int kind = xs::probe_kind(int(geom[4]), int(geom[2]));
  for (int l = 0; l < num_tables; ++l) {
    const int64_t* g = geom + 8 * l;
    if (g[6] < 1 || g[6] > xs::kMaxBlockPositions || xs::probe_kind(int(g[4]), int(g[2])) != kind)
      return int(cudaErrorInvalidValue);
    TableArgs& t = a.t[l];
    t.table = static_cast<const uint32_t*>(tables[l]);
    t.out = static_cast<int32_t*>(outs[l]);
    t.positions_per_block = g[6];
    t.counter_rows = int(g[7]);
    // whole tables: no owned-block window
    t.probe = xs::ProbeGeom{uint32_t(g[0]), k, int(g[1]), int(g[2]), int(g[3]), int(g[4]),
                            int(g[5]), 0u, 0u};
    const int64_t blocks = (n_pos + g[6] - 1) / g[6];
    if (blocks > grid_x) grid_x = blocks;
    const size_t bytes = size_t(g[7]) * size_t(g[5]) * sizeof(int32_t);
    if (bytes > shared) shared = bytes;
  }
  for (int l = num_tables; l < kMaxTables; ++l) a.t[l] = a.t[0];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* r = static_cast<const int32_t*>(rec_ids);
  const auto* v = static_cast<const uint8_t*>(valid);
  switch (kind) {
    case xs::kFields: launch<xs::kFields>(grid_x, num_tables, shared, s, c, r, v, a); break;
    case xs::kRows4: launch<xs::kRows4>(grid_x, num_tables, shared, s, c, r, v, a); break;
    case xs::kRows2: launch<xs::kRows2>(grid_x, num_tables, shared, s, c, r, v, a); break;
    default: launch<xs::kRows1>(grid_x, num_tables, shared, s, c, r, v, a);
  }
  return int(cudaGetLastError());
}
