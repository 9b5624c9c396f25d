// K11: the one-vs-one SVC species head, whole, in one launch: kernel row,
// pair decisions, votes and the first class with the most votes.
//
// Replaces the XLA program of `JaxSVMHead` (xspect2_tpu/models/svm_head.py:
// kernel matrix :64-79, per-pair decisions :81-102, votes and argmax
// :104-121).  It is not a Pallas kernel: XLA ran the head as plain dots.
//
// In:  plan   the head's launch plan (Plan below; ops/svm_head.py:LaunchPlan),
//             made once per head and device: the head's arrays packed into
//             one 16 B aligned device buffer, each array at a 16 B aligned
//             offset and padded to a multiple of 16 B (ops/svm_head.py:
//             head_layout, pack_head):
//               sv      float64 [n_sv, F | 1]  support vectors, class by class,
//                       each row padded to an odd stride with a zero
//               sv_sq   float64 [n_sv]     their squared norms (rbf only)
//               coef    float64 [(n_classes - 1) * n_sv]  the pair-major
//                       coefficients: pair p's class-i segment against
//                       dual_coef[j - 1], then its class-j segment against
//                       dual_coef[i], pair after pair
//               icpt    float64 [n_pairs]  -rho of each pair
//               pairs   uint32 [n_pairs, 4] the pair table: the first of the
//                       pair's coefficients in coef; start_i | n_i << 16;
//                       start_j | n_j << 16; i | j << 16
//      x      float32 or float64 [n, F], rows x_stride elements apart
// Out: pred   int64 [n]             first class with the most votes
//                                   (skipped when null)
//      dec    float64 [n, n_pairs]  the decisions (skipped when null)
//
// The function is libsvm's svm_predict_values: pair p = (i, j), i < j in
// row-major order, sums class i's segment against dual_coef[j - 1], then
// class j's against dual_coef[i], then adds intercept[p]; a decision > 0
// votes for i, otherwise for j.  poly is libsvm's powi (repeated
// squaring); nvcc contracts a * b + c into FMAs, so decisions agree with
// the CPU's within rounding, not bit for bit.
//
// Bound: latency.  At the smoke's head (40 classes, 780 pairs, 80 support
// vectors, 40 features, one row) the parameters are ~57 KB and the work
// ~17,000 operations: 0.000017 ms of bytes, far under one launch.  The
// first form of this kernel (one thread a support vector walking its row
// feature by feature from device memory, one thread a pair walking (i, j)
// forward and loading `starts` before its coefficients) spent its ~9 us in
// chains of dependent L2 round trips: ~3 us in phase 1, ~5 us in phases
// 2-3, of which the walk and the `starts` loads ~1 us (timed variants on
// an H100, PERF.md).  This design has about one round trip:
//
// - The staged form (kStaged) copies the packed head into shared memory in
//   one asynchronous round: thread 0 arms one mbarrier with the head's
//   bytes and issues one TMA bulk copy an array, while the block loads the
//   score row and sums its squared norm; everything after reads shared
//   memory.  The global form (kGlobal) is the same code reading the packed
//   head from device memory, for heads whose arrays do not fit the card's
//   opt-in shared memory (the wrapper picks the form by bytes); it keeps
//   only the kernel row, the scores and the counters in shared memory.
// - Phase 1 (kernel row) runs on groups of q adjacent lanes, one support
//   vector a group, all groups of the block at once: q is the largest power
//   of two up to 32 with n_sv * q <= kThreads / 2 (2 at the smoke's head:
//   160 threads, each a chain of 20 features; more lanes a support vector
//   add shuffles and were slower on the card, one lane lengthens the
//   chain).  Lane l of a group sums features l, l + q, ... in order, then
//   an xor butterfly of q / 2, ..., 1 lanes adds the group's partial sums;
//   the row's squared norm (rbf) is summed by every warp, lanes over
//   features, with the butterfly of 32.  The packed rows lie an odd number
//   of doubles apart, so lanes reading the same feature of different rows
//   hit different banks.
// - Phase 2 (decisions) strides the threads over the pairs; each reads its
//   16 B pair-table entry (the next one already in flight) and sums its
//   two segments from one contiguous run of coefficients, kTerms loads at
//   once: no walk, no dependent load of `starts`.  The pair-major
//   coefficients hold as many values as dual_coef, so the head gains only
//   the pair table, 16 B a pair (12,480 B at the smoke's head), and the
//   odd row stride (8 B a support vector where F is even).  Each pair's sum
//   keeps libsvm's order: segment i, segment j, intercept.  One vote a pair
//   with a shared-memory atomic (integers: exact in any order).
// - Phase 3: warp 0 picks the largest count, equal counts going to the
//   lower class, so the answer does not depend on the order in which the
//   votes landed.
//
// One block of 512 threads a row (fewer pairs a thread than 256; 1,024
// was slower).  The wrapper raises before any launch when even the kernel
// row, the scores and the counters do not fit the card's opt-in shared
// memory (~29,000 support vectors).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBarBytes = 16;  // the staged form's mbarrier, before the head
constexpr int kTerms = 4;      // a pair's terms loaded at once
enum Kernel { kLinear = 0, kRbf = 1, kPoly = 2, kSigmoid = 3 };
enum Form { kStaged = 0, kGlobal = 1 };

// ops/svm_head.py:_Plan mirrors this layout field for field
struct Plan {
  const uint8_t* head;  // the packed head, 16 B aligned
  uint32_t sv, sv_sq, coef, icpt, pairs;  // byte offsets of its arrays
  uint32_t head_bytes;                    // the packed head's bytes, a multiple of 16
  int32_t n_features, n_sv, n_classes, n_pairs;
  int32_t kernel, degree;
  double gamma, coef0;
  int32_t staged_smem, global_smem;  // dynamic shared bytes of each form (0: does not fit)
};
static_assert(sizeof(Plan) == 80, "ops/svm_head.py:_Plan");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// the one arrival, expecting `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait for phase 0 to complete (acquire: the copied bytes are visible after it)
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16 B aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  if (bytes == 0) return;
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// a head value: shared memory in the staged form, read-only device memory
// in the global form
template <int kForm, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (kForm == kGlobal) return __ldg(p);
  else return *p;
}

__device__ double powi(double base, int times) {
  double tmp = base, ret = 1.0;
  for (int t = times; t > 0; t /= 2) {
    if (t % 2 == 1) ret *= tmp;
    tmp = tmp * tmp;
  }
  return ret;
}

// the xor butterfly over groups of `lanes` adjacent lanes (a power of two):
// every lane of a group ends with the group's sum
__device__ __forceinline__ double butterfly(double v, int lanes) {
  for (int d = lanes >> 1; d >= 1; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
svm_head_kernel(const __grid_constant__ Plan plan, const T* __restrict__ x, int64_t x_stride,
                int64_t* __restrict__ pred, double* __restrict__ dec) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_features = plan.n_features, n_sv = plan.n_sv, n_classes = plan.n_classes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const uint8_t* head;
  double* km;
  if constexpr (kForm == kStaged) {
    uint8_t* staged = smem + kBarBytes;
    if (tid == 0) {
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(bar, plan.head_bytes);
      const uint32_t ends[5] = {plan.sv_sq, plan.coef, plan.icpt, plan.pairs, plan.head_bytes};
      uint32_t from = plan.sv;
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        bulk_copy(staged + from, plan.head + from, ends[a] - from, bar);
        from = ends[a];
      }
    }
    head = staged;
    km = reinterpret_cast<double*>(staged + plan.head_bytes);
  } else {
    head = plan.head;
    km = reinterpret_cast<double*>(smem);
  }
  double* row = km + n_sv;                                  // [n_features]
  int* votes = reinterpret_cast<int*>(row + n_features);    // [n_classes]
  const int64_t r = blockIdx.x;
  const T* xr = x + r * x_stride;
  for (int f = tid; f < n_features; f += kThreads) row[f] = double(xr[f]);
  for (int c = tid; c < n_classes; c += kThreads) votes[c] = 0;
  __syncthreads();

  // the row's squared norm (rbf): every warp, lanes over features, the xor
  // butterfly; in the staged form while the copies are in flight
  double xx = 0.0;
  if (plan.kernel == kRbf) {
    for (int f = lane; f < n_features; f += 32) xx += row[f] * row[f];
    xx = butterfly(xx, 32);
  }
  if constexpr (kForm == kStaged) mbar_wait(bar);

  const double* sv = reinterpret_cast<const double*>(head + plan.sv);
  const double* sv_sq = reinterpret_cast<const double*>(head + plan.sv_sq);
  const int stride = n_features | 1;  // the packed rows' odd stride, in doubles
  int q = 32;                         // lanes a support vector
  while (q > 1 && int64_t(n_sv) * q > kThreads / 2) q >>= 1;
  const int part = lane & (q - 1), per_warp = 32 / q;
  for (int base = warp * per_warp; base < n_sv; base += kWarps * per_warp) {  // uniform over the warp
    const int s = base + lane / q;
    const bool live = s < n_sv;
    const double* v = sv + int64_t(live ? s : base) * stride;
    double dot = 0.0;
    for (int f = part; f < n_features; f += q) dot += row[f] * load<kForm>(v + f);
    dot = butterfly(dot, q);
    if (live && part == 0) {
      double k;
      if (plan.kernel == kLinear) k = dot;
      else if (plan.kernel == kRbf) k = exp(-plan.gamma * (xx + load<kForm>(sv_sq + s) - 2.0 * dot));
      else if (plan.kernel == kPoly) k = powi(plan.gamma * dot + plan.coef0, plan.degree);
      else k = tanh(plan.gamma * dot + plan.coef0);
      km[s] = k;
    }
  }
  __syncthreads();

  const double* coef = reinterpret_cast<const double*>(head + plan.coef);
  const double* icpt = reinterpret_cast<const double*>(head + plan.icpt);
  const uint4* pairs = reinterpret_cast<const uint4*>(head + plan.pairs);
  const int n_pairs = plan.n_pairs;
  uint4 next = tid < n_pairs ? load<kForm>(pairs + tid) : uint4{};
  for (int p = tid; p < n_pairs; p += kThreads) {
    const uint4 e = next;
    if (p + kThreads < n_pairs) next = load<kForm>(pairs + p + kThreads);  // in flight meanwhile
    const double* c = coef + e.x;
    const int start_i = e.y & 0xFFFF, n_i = e.y >> 16, start_j = e.z & 0xFFFF, n = n_i + (e.z >> 16);
    const double b = load<kForm>(icpt + p);
    double sum = 0.0;
    // the pair's run of coefficients against segment i, then segment j, in
    // order; kTerms of them loaded at once
    for (int t0 = 0; t0 < n; t0 += kTerms) {
      double cv[kTerms], kv[kTerms];
#pragma unroll
      for (int u = 0; u < kTerms; ++u) {
        const int t = t0 + u;
        cv[u] = t < n ? load<kForm>(c + t) : 0.0;
        kv[u] = t < n ? km[t < n_i ? start_i + t : start_j + t - n_i] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kTerms; ++u)
        if (t0 + u < n) sum += cv[u] * kv[u];
    }
    sum += b;
    if (dec != nullptr) dec[r * n_pairs + p] = sum;
    atomicAdd(&votes[sum > 0 ? int(e.w & 0xFFFF) : int(e.w >> 16)], 1);
  }
  if (pred == nullptr) return;  // uniform over the block
  __syncthreads();

  if (tid < 32) {
    int best = -1, best_class = n_classes;
    for (int c = tid; c < n_classes; c += 32) {
      const int v = votes[c];
      if (v > best) {  // a lane's classes ascend: the first of equal counts stays
        best = v;
        best_class = c;
      }
    }
    for (int d = 16; d >= 1; d >>= 1) {
      const int v = __shfl_xor_sync(0xFFFFFFFFu, best, d);
      const int c = __shfl_xor_sync(0xFFFFFFFFu, best_class, d);
      if (v > best || (v == best && c < best_class)) {
        best = v;
        best_class = c;
      }
    }
    if (tid == 0) pred[r] = best_class;
  }
}

__global__ void empty_kernel() {}

template <typename T, int kForm>
int launch(const Plan& plan, const void* x, int64_t x_stride, int64_t n, int smem, void* pred, void* dec,
           cudaStream_t stream) {
  svm_head_kernel<T, kForm><<<unsigned(n), kThreads, smem, stream>>>(
      plan, static_cast<const T*>(x), x_stride, static_cast<int64_t*>(pred), static_cast<double*>(dec));
  return int(cudaGetLastError());
}

}  // namespace

// one launch of the plan's `form` on the rows x
extern "C" int xs_svm_head(const void* plan_ptr, int form, const void* x, int64_t x_stride, int x_is_f64,
                           int64_t n, void* pred, void* dec, void* stream) {
  const Plan& plan = *static_cast<const Plan*>(plan_ptr);
  const int smem = form == kStaged ? plan.staged_smem : plan.global_smem;
  const int64_t need = 8 * (int64_t(plan.n_sv) + plan.n_features) + 4 * int64_t(plan.n_classes);
  if (plan.kernel < kLinear || plan.kernel > kSigmoid || plan.n_classes < 1 || plan.n_sv < 0 ||
      plan.n_features < 0 || (form != kStaged && form != kGlobal) || smem < need ||
      (form == kStaged && smem < kBarBytes + int64_t(plan.head_bytes) + need) || n > 0x7FFFFFFF)
    return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (form == kStaged)
    return x_is_f64 ? launch<double, kStaged>(plan, x, x_stride, n, smem, pred, dec, s)
                    : launch<float, kStaged>(plan, x, x_stride, n, smem, pred, dec, s);
  return x_is_f64 ? launch<double, kGlobal>(plan, x, x_stride, n, smem, pred, dec, s)
                  : launch<float, kGlobal>(plan, x, x_stride, n, smem, pred, dec, s);
}

// the most dynamic shared memory a block of the current device may opt in
// to; every instantiation of the kernel is allowed that much on this device
// (once, so that a launch sets no attribute)
extern "C" int xs_svm_head_optin(void* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const auto allow = [&](auto kernel) {
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  };
  allow(svm_head_kernel<float, kStaged>);
  allow(svm_head_kernel<double, kStaged>);
  allow(svm_head_kernel<float, kGlobal>);
  allow(svm_head_kernel<double, kGlobal>);
  *static_cast<int*>(out) = optin;
  return int(err);
}

// an empty kernel on K11's block of one row: the floor a single call can
// reach, which chip_smoke.py times beside K11
extern "C" int xs_svm_head_empty(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}
