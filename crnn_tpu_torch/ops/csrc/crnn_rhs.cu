// Batched isothermal CRNN right-hand side for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crnn_tpu/ops/crnn_kernels.py:_rhs_kernel
// (launched through _rhs_pallas). For y (B, ns):
//
//   du[b, :] = w_out . exp(min(w_in^T log(clip(y_b, lb, ub)) + w_b, exp_cap))
//
// It is kernel 1 (arrhenius_rhs.cu) without the temperature feature. ub may
// be +inf (robertson clips only from below): clip is then the identity above
// lb.
//
// What bounds it: at the shapes of its callers (case1: B = 20 or 30, ns = 5,
// nr = 4, f32, every Tsit5 stage; robertson: B = 20 or 25, ns = 3, nr = 6,
// f64, every Rosenbrock23 f evaluation) one call reads and writes well under
// 2 KB and does a few hundred flops a lane, so neither bytes (3.35 TB/s) nor
// flops bound it: the launch latency does. The design keeps the launch as
// cheap as possible: one thread per lane with the whole lane in registers,
// the weights staged once per block in shared memory, a grid of
// ceil(B/128) blocks, no atomics, no scratch in device memory and one
// barrier after the weights are staged.
//
// NaN handling: clip and min are compare-and-select, so a NaN input gives a
// NaN output, as XLA and torch.minimum/torch.maximum do (fminf/fmaxf would
// drop it). The solvers reject a step through isfinite(y1), so the kernel
// must propagate NaN exactly as the plain version does. Built without
// --use_fast_math: expf/logf keep their full accuracy.
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
crnn_rhs_kernel(const T* __restrict__ y, const T* __restrict__ w_in,
                const T* __restrict__ w_b, const T* __restrict__ w_out,
                T* __restrict__ du, long long batch, int ns, int nr, T lb,
                T ub, T exp_cap) {
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

  T logx[kMaxSpecies];
  for (int i = 0; i < ns; ++i) {
    const T x = yb[i];
    const T xc = x < lb ? lb : (x > ub ? ub : x);
    logx[i] = log_t(xc);
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
    for (int r = 0; r < nr; ++r) acc += rates[r] * s_wout[i * nr + r];
    db[i] = acc;
  }
}

template <typename T>
int launch(const void* y, const void* w_in, const void* w_b, const void* w_out,
           void* du, long long batch, int ns, int nr, double lb, double ub,
           double exp_cap, void* stream) {
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long blocks = (batch + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(2 * ns * nr + nr) * sizeof(T);
  crnn_rhs_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_in),
      static_cast<const T*>(w_b), static_cast<const T*>(w_out),
      static_cast<T*>(du), batch, ns, nr, static_cast<T>(lb),
      static_cast<T>(ub), static_cast<T>(exp_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crnn_rhs_f32(const void* y, const void* w_in, const void* w_b,
                 const void* w_out, void* du, long long batch, int ns, int nr,
                 double lb, double ub, double exp_cap, void* stream) {
  return launch<float>(y, w_in, w_b, w_out, du, batch, ns, nr, lb, ub, exp_cap,
                       stream);
}

int crnn_rhs_f64(const void* y, const void* w_in, const void* w_b,
                 const void* w_out, void* du, long long batch, int ns, int nr,
                 double lb, double ub, double exp_cap, void* stream) {
  return launch<double>(y, w_in, w_b, w_out, du, batch, ns, nr, lb, ub, exp_cap,
                        stream);
}

}  // extern "C"
