// K7 (records route): the xxh3 compat genus filter counted on the card,
// per record, from the records route's codes: one launch per record batch.
//
// Replaces xspect2_tpu/core/compat.py:XXH3BloomFilter.count_hits_device
// (lines 205-236: the jitted gather, bit test, AND over the probes, mask
// and sum) together with the host hashing before it (compat.py:208,
// ascii_from_packed + xxh3_64_batch + derive_probe_positions), which the
// JAX package runs once per record from
// models/single_filter_model.py:138-177.  The hash moves onto the card;
// the counts stay those of the host (and of the position-based K7,
// bloom_count.cu, which keeps the filter's count_hits_device API).
//
// In:  codes   uint8  [n_pos + k - 1]  0..3, >3 = invalid base
//      rec_ids int32  [n_pos]          record of each position
//      valid   uint8  [n_pos]          window start kept (record span and
//                                      sparse-sampling phase)
//      words   uint32 [ceil(num_bits / 32)]  the filter: bit b of word w
//                                      is filter bit 32*w + b
// Out: out     int32  [max_records]    zeroed by the caller; this kernel
//                                      only adds into it
//
// For each position p with valid[p], 0 <= rec_ids[p] < max_records and
// no invalid base in codes[p .. p+k-1]: the canonical k-mer of the
// window (from the codes staged 2-bit packed, records_block.cuh), the
// XXH3-64 of its ASCII string (xxh3.cuh: the little-endian words the
// hash reads are formed from the codes, no byte string is stored), its
// h probe positions (d + i*h2) mod 2^64 mod num_bits, each an exact
// Barrett reduction, and the bit tests, stopping at the first clear bit;
// a window whose bits are all set adds one to out[rec_ids[p]].  Counted
// per record in shared memory when the block's record span fits, with
// one global atomic per hit otherwise (count_records_block).
//
// Bound: a 307 Mbit genus filter is 38 MB and sits in the 50 MB L2 once
// warm, so the bytes are the codes, record ids and validity (6 bytes a
// position) and each touched filter sector once; the operations (~110 to
// pack and hash a window, ~20 a probe for its 64-bit multiply-add,
// reduction and bit test) weigh about as much.  Design: one launch for a
// whole batch of records (a 4 Mbp assembly, or 65,536 reads), where the
// host-hashing design launched once per contig with the positions of
// every k-mer (28 bytes each at h=7) copied in.

#include <cstdint>
#include <cuda_runtime.h>

#include "records_block.cuh"
#include "xxh3.cuh"

namespace {

struct Geom {
  int64_t n_pos;
  int64_t positions_per_block;
  int max_records;
  int counter_rows;  // records whose counters fit a block's shared memory
};

// the xxh3 Bloom test as a records-block probe: one class
struct Xxh3BloomProbe {
  const uint32_t* words;
  uint64_t num_bits;
  uint64_t inv;  // floor((2^64 - 1) / num_bits), for xs::mod_bits
  int kmer;
  int num_hashes;
  __device__ __forceinline__ int k() const { return kmer; }
  __device__ __forceinline__ int num_classes() const { return 1; }
  __device__ __forceinline__ void operator()(uint32_t hi, uint32_t lo, int32_t* cnt) const {
    const uint64_t can = (uint64_t(hi) << (2 * min(kmer, 16))) | lo;
    const uint64_t d = xs::xxh3_kmer(xs::reverse_bases(can, kmer), kmer);
    if (xs::bloom_hit(words, d, num_hashes, num_bits, inv)) atomicAdd(cnt, 1);
  }
};

__global__ void __launch_bounds__(xs::kThreads)
    xxh3_records_count_kernel(const uint8_t* __restrict__ codes,
                              const int32_t* __restrict__ rec_ids,
                              const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
                              const Geom g, const Xxh3BloomProbe probe) {
  extern __shared__ int32_t s_counts[];
  const int64_t p0 = int64_t(blockIdx.x) * g.positions_per_block;
  const int64_t p1 = p0 + g.positions_per_block < g.n_pos ? p0 + g.positions_per_block : g.n_pos;
  xs::count_records_block(codes, rec_ids, valid, out, p0, p1, g.max_records, g.counter_rows,
                          probe, s_counts);
}

}  // namespace

extern "C" int xs_xxh3_records_count(const void* codes, const void* rec_ids, const void* valid,
                                     const void* words, void* out, int64_t n_pos, int k,
                                     int64_t num_bits, int num_hashes, int max_records,
                                     int64_t positions_per_block, int counter_rows,
                                     void* stream) {
  if (k < 4 || k > 32 || num_bits < 1 || num_bits > 0xFFFFFFFFll || num_hashes < 1 ||
      max_records < 1 || positions_per_block < 1 ||
      positions_per_block > xs::kMaxBlockPositions)
    return int(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const Geom g{n_pos, positions_per_block, max_records, counter_rows};
  const Xxh3BloomProbe probe{static_cast<const uint32_t*>(words), uint64_t(num_bits),
                             ~0ull / uint64_t(num_bits), k, num_hashes};
  const int64_t grid = (n_pos + positions_per_block - 1) / positions_per_block;
  const size_t shared = size_t(counter_rows) * sizeof(int32_t);
  xxh3_records_count_kernel<<<unsigned(grid), xs::kThreads, shared,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(rec_ids),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(out), g, probe);
  return int(cudaGetLastError());
}
