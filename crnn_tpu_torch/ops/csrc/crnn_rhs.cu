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
// 2 KB, so neither bytes (3.35 TB/s) nor flops bound it: the launch latency
// and the longest serial chain of one thread do. One thread per lane would
// run ns logs, nr exps (software routines in f64) and ns + nr dots in a row,
// and at large B its stores would be strided by ns values.
//
// The design is a flat lane tile. A block owns `lanes` consecutive lanes, so
// its slices of y (B, ns) and du (B, ns) are contiguous spans. It works in
// three phases, each a loop over a flat item index in which consecutive
// threads touch consecutive addresses, separated by barriers:
//   1. (lane, species): load y coalesced, clip, log into shared logx;
//   2. (lane, reaction): z = sum_i logx[i] w_in[i, r] (i ascending), + w_b,
//      the cap, one exp into shared rates;
//   3. (lane, species): du = sum_r rates[r] w_out[i, r] (r ascending),
//      stored at its flat index.
// Each thread's chain is at most one log, one exp and one dot per pass. The
// weights are staged once per block in shared memory. The wrapper chooses
// the lanes and threads (crnn_tpu_torch/ops/crnn_kernels.py:tile_geometry);
// the launcher derives the shared bytes from the layout below and the grid
// ceil(B / lanes), and refuses through the return code threads that are not
// whole warps within 256 or a layout above 48 KB. No thread returns early:
// a ragged last tile masks its items, so every thread reaches every barrier.
// No atomics, no scratch in device memory. Each dot runs in ascending index
// order with fused multiply-adds.
//
// NaN handling: clip and min are compare-and-select, so a NaN input gives a
// NaN output, as XLA and torch.minimum/torch.maximum do (fminf/fmaxf would
// drop it). The solvers reject a step through isfinite(y1), so the kernel
// must propagate NaN exactly as the plain version does. Built without
// --use_fast_math: expf/logf keep their full accuracy.
//
// Plain C interface, loaded with ctypes (crnn_tpu_torch/ops/_build.py).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSpecies = 32;
constexpr int kMaxReactions = 32;
constexpr long long kMaxSharedBytes = 48 * 1024;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
crnn_rhs_kernel(const T* __restrict__ y, const T* __restrict__ w_in,
                const T* __restrict__ w_b, const T* __restrict__ w_out,
                T* __restrict__ du, long long batch, int ns, int nr,
                int lanes, T lb, T ub, T exp_cap) {
  // shared layout: w_in (ns*nr) | w_out (ns*nr) | w_b (nr) |
  //                logx (lanes*ns) | rates (lanes*nr)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);
  T* s_wout = s_win + ns * nr;
  T* s_wb = s_wout + ns * nr;
  T* s_logx = s_wb + nr;
  T* s_rates = s_logx + lanes * ns;

  const long long lane0 = static_cast<long long>(blockIdx.x) * lanes;
  const long long left = batch - lane0;
  const int n_lanes = left < lanes ? static_cast<int>(left) : lanes;

  for (int k = threadIdx.x; k < ns * nr; k += blockDim.x) {
    s_win[k] = w_in[k];
    s_wout[k] = w_out[k];
  }
  for (int k = threadIdx.x; k < nr; k += blockDim.x) s_wb[k] = w_b[k];

  // phase 1: (lane, species)
  const T* yt = y + lane0 * ns;
  for (int k = threadIdx.x; k < n_lanes * ns; k += blockDim.x) {
    const T x = yt[k];
    const T xc = x < lb ? lb : (x > ub ? ub : x);
    s_logx[k] = log_t(xc);
  }
  __syncthreads();

  // phase 2: (lane, reaction)
  for (int k = threadIdx.x; k < n_lanes * nr; k += blockDim.x) {
    const int l = k / nr;
    const int r = k - l * nr;
    const T* lx = s_logx + l * ns;
    T z = T(0);
    for (int i = 0; i < ns; ++i) z += lx[i] * s_win[i * nr + r];
    z = z + s_wb[r];
    s_rates[k] = exp_t(z > exp_cap ? exp_cap : z);
  }
  __syncthreads();

  // phase 3: (lane, species)
  T* dt = du + lane0 * ns;
  for (int k = threadIdx.x; k < n_lanes * ns; k += blockDim.x) {
    const int l = k / ns;
    const int i = k - l * ns;
    const T* lr = s_rates + l * nr;
    T acc = T(0);
    for (int r = 0; r < nr; ++r) acc += lr[r] * s_wout[i * nr + r];
    dt[k] = acc;
  }
}

template <typename T>
int launch(const void* y, const void* w_in, const void* w_b, const void* w_out,
           void* du, long long batch, int ns, int nr, double lb, double ub,
           double exp_cap, int lanes, int threads, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0)
    return invalid;
  if (lanes < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return invalid;
  // the kernel's shared layout: weights, then (ns + nr) values a lane
  const long long smem =
      (2LL * ns * nr + nr + static_cast<long long>(lanes) * (ns + nr))
      * static_cast<long long>(sizeof(T));
  const long long blocks = (batch + lanes - 1) / lanes;
  if (smem > kMaxSharedBytes || blocks > INT_MAX) return invalid;
  if (batch == 0) return 0;
  crnn_rhs_kernel<T><<<static_cast<unsigned>(blocks), threads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_in),
      static_cast<const T*>(w_b), static_cast<const T*>(w_out),
      static_cast<T*>(du), batch, ns, nr, lanes, static_cast<T>(lb),
      static_cast<T>(ub), static_cast<T>(exp_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crnn_rhs_f32(const void* y, const void* w_in, const void* w_b,
                 const void* w_out, void* du, long long batch, int ns, int nr,
                 double lb, double ub, double exp_cap, int lanes, int threads,
                 void* stream) {
  return launch<float>(y, w_in, w_b, w_out, du, batch, ns, nr, lb, ub, exp_cap,
                       lanes, threads, stream);
}

int crnn_rhs_f64(const void* y, const void* w_in, const void* w_b,
                 const void* w_out, void* du, long long batch, int ns, int nr,
                 double lb, double ub, double exp_cap, int lanes, int threads,
                 void* stream) {
  return launch<double>(y, w_in, w_b, w_out, du, batch, ns, nr, lb, ub,
                        exp_cap, lanes, threads, stream);
}

}  // extern "C"
