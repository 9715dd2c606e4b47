// Batched isothermal CRNN right-hand side and its dense Jacobian for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel crnn_tpu/ops/crnn_kernels.py:_rhs_jac_kernel
// (launched through _rhs_jac_pallas). For y (B, ns), with
// rates_r = exp(min(w_in[:, r] . log(clip(y, lb, ub)) + w_b_r, exp_cap)) and
// dlog_j = [lb < y_j < ub] / clip(y_j, lb, ub):
//
//   du[b, i]   = sum_r w_out[i, r] rates_r
//   J[b, i, j] = (sum_r rates_r w_out[i, r] w_in[j, r]) dlog_j
//
// It is kernel 2 (arrhenius_rhs_jac.cu) without the temperature feature.
// ub may be +inf (robertson): the clip is then the identity above lb, and
// the strict y < ub holds for every finite y.
//
// What bounds it: at robertson's shapes (B = 20 or 25, ns = 3, nr = 6, f64,
// once per Rosenbrock23 step) one call reads ~0.7 KB and writes ~2.4 KB and
// does ~150 flops a lane, so neither bytes (3.35 TB/s) nor flops bound it:
// the launch latency does. The design is kernel 2's: one thread per lane
// with the lane in registers, the weights staged once per block in shared
// memory, ceil(B/128) blocks, no atomics, no scratch, one barrier. Each lane
// writes its own ns^2 block of J, so a warp's stores are strided by ns^2
// values; at large B a shared-memory transpose would coalesce them (not
// needed at the callers' B).
//
// NaN handling as in kernel 4: clip, the exp cap and the in-range mask are
// compare-and-select, and dlog is in_range / clip(y), so a NaN species gives
// 0 / NaN = NaN exactly as the plain version does. Built without
// --use_fast_math.
//
// Plain C interface, loaded with ctypes (crnn_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSpecies = 32;
constexpr int kMaxReactions = 32;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
crnn_rhs_jac_kernel(const T* __restrict__ y, const T* __restrict__ w_in,
                    const T* __restrict__ w_b, const T* __restrict__ w_out,
                    T* __restrict__ du, T* __restrict__ jac, long long batch,
                    int ns, int nr, T lb, T ub, T exp_cap) {
  // shared layout: w_in (ns*nr) | w_out (ns*nr) | w_b (nr)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);
  T* s_wout = s_win + ns * nr;
  T* s_wb = s_wout + ns * nr;
  for (int i = threadIdx.x; i < ns * nr; i += blockDim.x) {
    s_win[i] = w_in[i];
    s_wout[i] = w_out[i];
  }
  for (int i = threadIdx.x; i < nr; i += blockDim.x) s_wb[i] = w_b[i];
  __syncthreads();

  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const T* yb = y + lane * ns;
  T* db = du + lane * ns;
  T* jb = jac + lane * ns * ns;

  T logx[kMaxSpecies];
  T dlog[kMaxSpecies];
  for (int i = 0; i < ns; ++i) {
    const T x = yb[i];
    const T xc = x < lb ? lb : (x > ub ? ub : x);
    logx[i] = log_t(xc);
    const T in_range = (x > lb && x < ub) ? T(1) : T(0);
    dlog[i] = in_range / xc;
  }
  T rates[kMaxReactions];
  for (int r = 0; r < nr; ++r) {
    T z = T(0);
    for (int i = 0; i < ns; ++i) z += logx[i] * s_win[i * nr + r];
    z = z + s_wb[r];
    rates[r] = exp_t(z > exp_cap ? exp_cap : z);
  }
  for (int i = 0; i < ns; ++i) {
    T acc = T(0);
    T rw[kMaxReactions];
    for (int r = 0; r < nr; ++r) {
      rw[r] = rates[r] * s_wout[i * nr + r];
      acc += rw[r];
    }
    db[i] = acc;
    T* row = jb + i * ns;
    for (int j = 0; j < ns; ++j) {
      T s = T(0);
      for (int r = 0; r < nr; ++r) s += rw[r] * s_win[j * nr + r];
      row[j] = s * dlog[j];
    }
  }
}

template <typename T>
int launch(const void* y, const void* w_in, const void* w_b, const void* w_out,
           void* du, void* jac, long long batch, int ns, int nr, double lb,
           double ub, double exp_cap, void* stream) {
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long blocks = (batch + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(2 * ns * nr + nr) * sizeof(T);
  crnn_rhs_jac_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_in),
      static_cast<const T*>(w_b), static_cast<const T*>(w_out),
      static_cast<T*>(du), static_cast<T*>(jac), batch, ns, nr,
      static_cast<T>(lb), static_cast<T>(ub), static_cast<T>(exp_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crnn_rhs_jac_f32(const void* y, const void* w_in, const void* w_b,
                     const void* w_out, void* du, void* jac, long long batch,
                     int ns, int nr, double lb, double ub, double exp_cap,
                     void* stream) {
  return launch<float>(y, w_in, w_b, w_out, du, jac, batch, ns, nr, lb, ub,
                       exp_cap, stream);
}

int crnn_rhs_jac_f64(const void* y, const void* w_in, const void* w_b,
                     const void* w_out, void* du, void* jac, long long batch,
                     int ns, int nr, double lb, double ub, double exp_cap,
                     void* stream) {
  return launch<double>(y, w_in, w_b, w_out, du, jac, batch, ns, nr, lb, ub,
                        exp_cap, stream);
}

}  // extern "C"
