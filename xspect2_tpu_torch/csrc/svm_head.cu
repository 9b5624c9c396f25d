// K11: the one-vs-one SVC species head, whole, in one launch: kernel row,
// pair decisions, votes and the first class with the most votes.
//
// Replaces the XLA program of `JaxSVMHead` (xspect2_tpu/models/svm_head.py:
// kernel matrix :64-79, per-pair decisions :81-102, votes and argmax
// :104-121).  It is not a Pallas kernel: XLA ran the head as plain dots.
//
// In:  x          float32 or float64 [n, F], rows x_stride elements apart
//      sv         float64 [n_sv, F]    support vectors, class by class
//      sv_sq      float64 [n_sv]       their squared norms (rbf only)
//      dual_coef  float64 [n_classes - 1, n_sv]  libsvm's sv_coef
//      intercept  float64 [n_pairs]    -rho of each pair
//      starts     int32 [n_classes + 1]  each class's first support vector
// Out: pred       int64 [n]            first class with the most votes
//                                      (skipped when null)
//      dec        float64 [n, n_pairs] the decisions (skipped when null)
//
// The function is libsvm's svm_predict_values: pair p = (i, j), i < j in
// row-major order, sums class i's segment against dual_coef[j - 1], then
// class j's against dual_coef[i], then adds intercept[p]; a decision > 0
// votes for i, otherwise for j.  poly is libsvm's powi (repeated
// squaring); nvcc contracts a * b + c into FMAs, so decisions agree with
// the CPU's within rounding, not bit for bit.
//
// Bound: latency.  At the smoke's head (40 classes, 780 pairs, 80 support
// vectors, 40 features, one row) the parameters are ~52 KB and the work
// ~17,000 operations: 0.000017 ms of bytes, far under one launch.  So the
// design is one launch and nothing else: one block of 256 threads a row.
// Phase 1 writes the kernel row to shared memory, one support vector a
// thread, its dot product summed in feature order.  Phase 2 strides the
// threads over the pairs, each walking its (i, j) forward without a
// division, summing its two segments from shared memory and adding one
// vote with a shared-memory atomic (integers: exact in any order).  Phase 3:
// warp 0 picks the largest count, equal counts going to the lower class,
// so the answer does not depend on the order in which the votes landed.
// The wrapper checks that the kernel row, the scores and the counters fit
// the card's opt-in shared memory (~29,000 support vectors) before it
// launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSharedBytes = 48 * 1024;
enum Kernel { kLinear = 0, kRbf = 1, kPoly = 2, kSigmoid = 3 };

__device__ double powi(double base, int times) {
  double tmp = base, ret = 1.0;
  for (int t = times; t > 0; t /= 2) {
    if (t % 2 == 1) ret *= tmp;
    tmp = tmp * tmp;
  }
  return ret;
}

// moves pair (i, j) `step` pairs on in row-major order over i < j; past
// the last pair it stops with i == n_classes
__device__ void advance(int& i, int& j, int step, int n_classes) {
  j += step;
  while (j >= n_classes && i < n_classes) {
    ++i;
    j += i + 1 - n_classes;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
svm_head_kernel(const T* __restrict__ x, int64_t x_stride, const double* __restrict__ sv,
                const double* __restrict__ sv_sq, const double* __restrict__ dual_coef,
                const double* __restrict__ intercept, const int* __restrict__ starts, int n_features,
                int n_sv, int n_classes, int kernel, double gamma, int degree, double coef0,
                int64_t* __restrict__ pred, double* __restrict__ dec) {
  extern __shared__ double smem[];
  double* km = smem;                                        // [n_sv]
  double* row = smem + n_sv;                                // [n_features]
  int* votes = reinterpret_cast<int*>(row + n_features);    // [n_classes]
  const int64_t r = blockIdx.x;
  const T* xr = x + r * x_stride;
  for (int f = threadIdx.x; f < n_features; f += kThreads) row[f] = double(xr[f]);
  for (int c = threadIdx.x; c < n_classes; c += kThreads) votes[c] = 0;
  __syncthreads();

  double xx = 0.0;
  if (kernel == kRbf)
    for (int f = 0; f < n_features; ++f) xx += row[f] * row[f];
  for (int s = threadIdx.x; s < n_sv; s += kThreads) {
    const double* v = sv + int64_t(s) * n_features;
    double dot = 0.0;
    for (int f = 0; f < n_features; ++f) dot += row[f] * v[f];
    double k;
    if (kernel == kLinear) k = dot;
    else if (kernel == kRbf) k = exp(-gamma * (xx + sv_sq[s] - 2.0 * dot));
    else if (kernel == kPoly) k = powi(gamma * dot + coef0, degree);
    else k = tanh(gamma * dot + coef0);
    km[s] = k;
  }
  __syncthreads();

  const int n_pairs = n_classes * (n_classes - 1) / 2;
  int i = 0, j = 1;
  advance(i, j, threadIdx.x, n_classes);
  for (int p = threadIdx.x; p < n_pairs; p += kThreads) {
    const double* coef_i = dual_coef + int64_t(j - 1) * n_sv;
    const double* coef_j = dual_coef + int64_t(i) * n_sv;
    double sum = 0.0;
    for (int s = starts[i], e = starts[i + 1]; s < e; ++s) sum += coef_i[s] * km[s];
    for (int s = starts[j], e = starts[j + 1]; s < e; ++s) sum += coef_j[s] * km[s];
    sum += intercept[p];
    if (dec != nullptr) dec[r * n_pairs + p] = sum;
    atomicAdd(&votes[sum > 0 ? i : j], 1);
    advance(i, j, kThreads, n_classes);
  }
  if (pred == nullptr) return;  // uniform over the block
  __syncthreads();

  if (threadIdx.x < 32) {
    int best = -1, best_class = n_classes;
    for (int c = threadIdx.x; c < n_classes; c += 32) {
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
    if (threadIdx.x == 0) pred[r] = best_class;
  }
}

__global__ void empty_kernel() {}

template <typename T>
int launch(const void* x, int64_t x_stride, const void* sv, const void* sv_sq,
           const void* dual_coef, const void* intercept, const void* starts, int64_t n,
           int n_features, int n_sv, int n_classes, int kernel, double gamma, int degree,
           double coef0, int smem, void* pred, void* dec, cudaStream_t stream) {
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        svm_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  svm_head_kernel<T><<<unsigned(n), kThreads, smem, stream>>>(
      static_cast<const T*>(x), x_stride, static_cast<const double*>(sv),
      static_cast<const double*>(sv_sq), static_cast<const double*>(dual_coef),
      static_cast<const double*>(intercept), static_cast<const int*>(starts), n_features, n_sv,
      n_classes, kernel, gamma, degree, coef0, static_cast<int64_t*>(pred),
      static_cast<double*>(dec));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int xs_svm_head(const void* x, int64_t x_stride, int x_is_f64, const void* sv,
                           const void* sv_sq, const void* dual_coef, const void* intercept,
                           const void* starts, int64_t n, int n_features, int n_sv,
                           int n_classes, int kernel, double gamma, int degree, double coef0,
                           int smem, void* pred, void* dec, void* stream) {
  const int64_t need = 8 * (int64_t(n_sv) + n_features) + 4 * int64_t(n_classes);
  if (kernel < kLinear || kernel > kSigmoid || n_classes < 1 || n_sv < 0 || n_features < 0 ||
      smem < need || n > 0x7FFFFFFF)
    return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_f64)
    return launch<double>(x, x_stride, sv, sv_sq, dual_coef, intercept, starts, n, n_features,
                          n_sv, n_classes, kernel, gamma, degree, coef0, smem, pred, dec, s);
  return launch<float>(x, x_stride, sv, sv_sq, dual_coef, intercept, starts, n, n_features, n_sv,
                       n_classes, kernel, gamma, degree, coef0, smem, pred, dec, s);
}

// the most dynamic shared memory a block of the current device may opt in to
extern "C" int xs_svm_head_optin(void* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(static_cast<int*>(out), cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return int(err);
}

// an empty kernel on K11's block of one row: the floor a single call can
// reach, which chip_smoke.py times beside K11
extern "C" int xs_svm_head_empty(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}
