// K4: the compact records wire restored in one launch: codes, record ids
// and window validity of every position of a flat batch.
//
// Replaces the prologue of xspect2_tpu/ops/query.py:
// query_hits_packed_batch_device (:293-311): the flat unpack and its
// `codes.at[bad_pos].set(255, mode="drop")`, the searchsorted over the
// record offsets clamped to max_records - 1, and the validity mask.
//
// In:  packed  uint8 [>= ceil(n_tot/4)]  the flat 2-bit codes, base p at
//                                        bits 2*(p%4) of byte p/4; null:
//                                        record ids and validity only
//      bad_pos int32 [m]                 positions set to 255; entries
//                                        outside [0, n_tot) are dropped
//      ascending                         bad_pos never decreases (as in
//                                        the list packed_wire_for_batch
//                                        emits: the N bases, then the
//                                        sentinels n_tot)
//      offsets int32 [max_records + 1]   record r spans [offsets[r],
//                                        offsets[r+1]); the tail past the
//                                        real records repeats the total
//                                        base count (empty records)
// Out: codes   uint8 [n_tot = n_pos + k - 1]  0..3, or 255
//      rec_ids int32 [n_pos]   searchsorted(offsets[1:], pos, "right"),
//                              clamped to max_records - 1
//      valid   uint8 [n_pos]   rel < nk_r && rel % step == 0, with
//                              rel = pos - offsets[rec] and
//                              nk_r = offsets[rec+1] - offsets[rec] - (k-1)
// All arithmetic is signed int32, as in the JAX program: nk_r is negative
// for the empty padding records, so their positions are invalid.  The
// step is a mask, not a stride: each record's phase restarts at its own
// offset.  Padding positions are not patched; no valid window reads them.
//
// Bound: bytes.  It reads n_tot/4 + 4m + 4(max_records + 1) bytes and
// writes 6 bytes a position.  Design: a block owns a tile of kTile
// positions.  One warp finds the tile's first record and one its last by
// a 32-way search of the offsets; two more warps find the tile's patch
// entries in the ascending list.  Each thread then takes 16 consecutive
// positions: one 4-byte load of packed bytes gives their 16 codes, stored
// as one 16-byte store; it finds its first record by a binary search
// between the tile's first and last, then moves forward one record when
// a position crosses a record end (neighbouring positions almost always
// share one) and, when the next end still lies at or before the position
// (a run of short or empty records, such as the empty records that pad a
// batch to max_records), binary-searches the rest up to the tile's last
// record, so no thread walks the padding one record at a time; the phase
// rel % step is kept by a running counter; its 16 validity bytes go out as
// one 16-byte store, and its 16 record ids through shared memory, so that
// the block writes them with 16-byte stores of consecutive lanes on
// consecutive addresses: whole 32-byte sectors, where a thread's own 64
// bytes stored as four 16-byte vectors would leave every warp store half
// of each sector.  A tile with patch entries sets them in a shared-memory
// copy of its codes before the store.  A list in any other order is
// scattered by a second, patch-only launch.  Nothing is allocated here.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wire_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // positions a block

__global__ void __launch_bounds__(kThreads)
records_wire_kernel(const uint8_t* __restrict__ packed, int64_t packed_len,
                    const int32_t* __restrict__ bad_pos, int64_t num_patches,
                    const int32_t* __restrict__ offsets, uint8_t* __restrict__ codes,
                    int32_t* __restrict__ rec_ids, uint8_t* __restrict__ valid, int n_pos,
                    int n_tot, int max_records, int k, int step) {
  __shared__ __align__(16) uint8_t tile[kTile];
  __shared__ int4 ids_s[kTile / 4];
  __shared__ int64_t s_found[4];  // first record, last record, first and end patch

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int p0 = int(blockIdx.x) * kTile;
  const int p = p0 + kPerThread * tid;
  const bool patches = packed != nullptr && num_patches > 0;

  if (warp < 2) {
    // upper bounds of the tile's first and last position in offsets[1..]
    const int64_t x = warp == 0 ? p0 : int64_t(p0) + kTile - 1;
    const int64_t r = wire::warp_search<true>(offsets + 1, 0, max_records, x);
    if ((tid & 31) == 0) s_found[warp] = r;
  } else if (warp < 4 && patches) {
    const int64_t r = wire::warp_search<false>(bad_pos, 0, num_patches,
                                               warp == 2 ? p0 : int64_t(p0) + kTile);
    if ((tid & 31) == 0) s_found[warp] = r;
  }

  uint4 v = make_uint4(0, 0, 0, 0);
  if (packed != nullptr && p < n_tot) {
    const int64_t at = p >> 2;
    uint32_t w;
    if (at + 4 <= packed_len) {
      w = __ldg(reinterpret_cast<const uint32_t*>(packed + at));
    } else {
      w = 0;
      for (int j = 0; at + j < packed_len; ++j) w |= uint32_t(__ldg(packed + at + j)) << (8 * j);
    }
    v = wire::spread16(w);
  }
  __syncthreads();

  if (packed != nullptr) {
    const bool patched = patches && s_found[3] > s_found[2];
    if (patched) {
      if (p < n_tot) *reinterpret_cast<uint4*>(tile + kPerThread * tid) = v;
      __syncthreads();
      for (int64_t e = s_found[2] + tid; e < s_found[3]; e += kThreads) {
        const int pos = __ldg(bad_pos + e);
        if (pos < n_tot) tile[pos - p0] = 255;  // lower bounds keep pos in [p0, p0 + kTile)
      }
      __syncthreads();
      if (p < n_tot) v = *reinterpret_cast<const uint4*>(tile + kPerThread * tid);
    }
    if (p + kPerThread <= n_tot) {
      *reinterpret_cast<uint4*>(codes + p) = v;
    } else if (p < n_tot) {
      wire::store_head(codes + p, v, n_tot - p);
    }
  }
  // the record of p: upper bound of p in offsets[1..], between the tile's
  // first and last record (max_records when p lies past every offset)
  if (p < n_pos) {
    int lo = int(s_found[0]), hi = int(s_found[1]);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + 1 + mid) <= p) lo = mid + 1;
      else hi = mid;
    }
    const int last = int(s_found[1]);
    int rec = lo;
    int64_t next = rec < max_records ? __ldg(offsets + 1 + rec) : INT64_MAX;
    int rc = 0, rel = 0, nk = 0, phase = 0;
    int32_t ids[kPerThread];
    uint32_t ok[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int pos = p + t;
      if (t == 0 || pos >= next) {
        if (pos >= next) {
          // one step: neighbouring positions cross one record end at a time
          ++rec;
          next = rec < max_records ? __ldg(offsets + 1 + rec) : INT64_MAX;
          if (pos >= next) {
            // a run of records that end at or before pos (short or empty
            // records): the upper bound of pos in offsets[1..], after rec
            // and at most the tile's last record
            int a = rec + 1, b = last;
            while (a < b) {
              const int mid = (a + b) >> 1;
              if (__ldg(offsets + 1 + mid) <= pos) a = mid + 1;
              else b = mid;
            }
            rec = a;
            next = rec < max_records ? __ldg(offsets + 1 + rec) : INT64_MAX;
          }
        }
        rc = min(rec, max_records - 1);
        const int start = __ldg(offsets + rc);
        nk = __ldg(offsets + rc + 1) - start - (k - 1);
        rel = pos - start;
        phase = rel % step;
        if (phase < 0) phase += step;
      }
      ids[t] = rc;
      ok[t >> 2] |= uint32_t(rel < nk && phase == 0) << (8 * (t & 3));
      ++rel;
      if (++phase == step) phase = 0;
    }
    // the record ids to shared memory, each 16-byte quarter of the thread's
    // 64 bytes rotated by (tid >> 1) & 3 so that a quarter-warp's stores hit
    // eight different bank groups
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ids_s[4 * tid + ((j + (tid >> 1)) & 3)] = make_int4(ids[4 * j], ids[4 * j + 1], ids[4 * j + 2], ids[4 * j + 3]);
    }
    const uint4 vb = make_uint4(ok[0], ok[1], ok[2], ok[3]);
    if (p + kPerThread <= n_pos) {
      *reinterpret_cast<uint4*>(valid + p) = vb;
    } else {
      for (int t = 0; p + t < n_pos; ++t) valid[p + t] = wire::byte_of(vb, t);
    }
  }
  __syncthreads();
  // ... and out with 16-byte stores, consecutive lanes on consecutive
  // addresses: slot s holds quarter j of thread s / 4's record ids
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int slot = tid + kThreads * r;
    const int owner = slot >> 2;
    const int j = ((slot & 3) - (owner >> 1)) & 3;
    const int pos = p0 + kPerThread * owner + 4 * j;
    if (pos + 4 <= n_pos) {
      reinterpret_cast<int4*>(rec_ids + pos)[0] = ids_s[slot];
    } else if (pos < n_pos) {
      const int4 q = ids_s[slot];
      const int32_t four[4] = {q.x, q.y, q.z, q.w};
      for (int e = 0; pos + e < n_pos; ++e) rec_ids[pos + e] = four[e];
    }
  }
}

// the patch list in any order, after the restore
__global__ void patch_kernel(uint8_t* __restrict__ codes, const int32_t* __restrict__ bad_pos,
                             int64_t m, int n_tot) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < m;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int pos = bad_pos[i];
    if (pos >= 0 && pos < n_tot) codes[pos] = 255;
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for what the kernel cannot
// take (positions past int32, a packed wire shorter than the codes,
// max_records < 1, step < 1); every buffer must be 16-byte aligned.
extern "C" int xs_records_wire(const void* packed, int64_t packed_len, const void* bad_pos,
                               int64_t num_patches, int ascending, const void* offsets, void* codes,
                               void* rec_ids, void* valid, int64_t n_pos, int max_records, int k,
                               int step, void* stream) {
  const int64_t n_tot = n_pos + k - 1;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(codes) |
                         reinterpret_cast<uintptr_t>(rec_ids) | reinterpret_cast<uintptr_t>(valid);
  if (n_pos < 0 || k < 1 || n_tot + kTile > INT_MAX || max_records < 1 || step < 1 ||
      num_patches < 0 || (packed != nullptr && packed_len < (n_tot + 3) / 4) || (ptrs & 15)) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t span = packed != nullptr ? n_tot : n_pos;
  if (span == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  records_wire_kernel<<<unsigned((span + kTile - 1) / kTile), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(packed), packed_len, static_cast<const int32_t*>(bad_pos),
      ascending ? num_patches : 0, static_cast<const int32_t*>(offsets),
      static_cast<uint8_t*>(codes), static_cast<int32_t*>(rec_ids), static_cast<uint8_t*>(valid),
      int(n_pos), int(n_tot), max_records, k, step);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || packed == nullptr || ascending || num_patches == 0) return int(err);
  const int64_t blocks = (num_patches + kThreads - 1) / kThreads;
  patch_kernel<<<unsigned(wire::min64(blocks, int64_t(1) << 20)), kThreads, 0, s>>>(
      static_cast<uint8_t*>(codes), static_cast<const int32_t*>(bad_pos), num_patches, int(n_tot));
  return int(cudaGetLastError());
}
