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
// once per Rosenbrock23 step) one call reads ~0.7 KB and writes ~2.4 KB, so
// neither bytes (3.35 TB/s) nor flops bound it: the launch latency and the
// longest serial chain of one thread do. One thread per lane would run ns
// logs, ns divisions, nr exps (software routines in f64) and the ns + ns^2
// dots of its outputs in a row; at large B its J stores would be strided by
// ns^2 values across a warp, and the bytes of J bound the call.
//
// The design is kernel 4's flat lane tile (crnn_rhs.cu). A block owns
// `lanes` consecutive lanes, so its slices of y (B, ns), du (B, ns) and
// J (B, ns, ns) are contiguous spans. Three phases, each a loop over a flat
// item index in which consecutive threads touch consecutive addresses,
// separated by barriers:
//   1. (lane, species): load y coalesced, clip, log into shared logx, and
//      dlog = in_range / clip(y) into shared dlog;
//   2. (lane, reaction): z = sum_i logx[i] w_in[i, r] (i ascending), + w_b,
//      the cap, one exp into shared rates;
//   3. (lane, i): du = sum_r rates[r] w_out[i, r], as kernel 4 computes
//      it; then (lane, i, j): J = (sum_r (rates[r] w_out[i, r]) w_in[j, r])
//      dlog[j], r ascending. Every output is stored at its flat index: the
//      J stores of a warp are one contiguous run, with no transpose.
// Each thread's chain is at most one log and one division, one exp, or one
// dot per pass. Weights staged once per block in shared memory; lanes and
// threads from crnn_tpu_torch/ops/crnn_kernels.py:tile_geometry, the shared
// bytes and the grid derived here as in kernel 4, with the same refusals; no
// early return before a barrier (a ragged tile masks its items); no atomics,
// no scratch in device memory. Each dot runs in ascending index order with
// fused multiply-adds; in J the product rates[r] w_out[i, r] is rounded
// before its multiply-add with w_in[j, r], as in the one-thread-per-lane
// kernel this replaces (the plain version's einsum may associate the triple
// product otherwise, so J agrees with it to rounding, not bitwise).
//
// NaN handling as in kernel 4: clip, the exp cap and the in-range mask are
// compare-and-select, and dlog is in_range / clip(y), so a NaN species gives
// 0 / NaN = NaN exactly as the plain version does. Built without
// --use_fast_math.
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
crnn_rhs_jac_kernel(const T* __restrict__ y, const T* __restrict__ w_in,
                    const T* __restrict__ w_b, const T* __restrict__ w_out,
                    T* __restrict__ du, T* __restrict__ jac, long long batch,
                    int ns, int nr, int lanes, T lb, T ub, T exp_cap) {
  // shared layout: w_in (ns*nr) | w_out (ns*nr) | w_b (nr) |
  //                logx (lanes*ns) | dlog (lanes*ns) | rates (lanes*nr)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);
  T* s_wout = s_win + ns * nr;
  T* s_wb = s_wout + ns * nr;
  T* s_logx = s_wb + nr;
  T* s_dlog = s_logx + lanes * ns;
  T* s_rates = s_dlog + lanes * ns;

  const long long lane0 = static_cast<long long>(blockIdx.x) * lanes;
  const long long left = batch - lane0;
  const int n_lanes = left < lanes ? static_cast<int>(left) : lanes;
  const int nss = ns * ns;

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
    const T in_range = (x > lb && x < ub) ? T(1) : T(0);
    s_dlog[k] = in_range / xc;
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

  // phase 3: (lane, i) for du, then (lane, i, j) for J
  T* dt = du + lane0 * ns;
  for (int k = threadIdx.x; k < n_lanes * ns; k += blockDim.x) {
    const int l = k / ns;
    const int i = k - l * ns;
    const T* lr = s_rates + l * nr;
    T acc = T(0);
    for (int r = 0; r < nr; ++r) acc += lr[r] * s_wout[i * nr + r];
    dt[k] = acc;
  }
  T* jt = jac + lane0 * nss;
  for (int k = threadIdx.x; k < n_lanes * nss; k += blockDim.x) {
    const int l = k / nss;
    const int ij = k - l * nss;
    const int i = ij / ns;
    const int j = ij - i * ns;
    const T* lr = s_rates + l * nr;
    T s = T(0);
    for (int r = 0; r < nr; ++r) {
      const T rw = lr[r] * s_wout[i * nr + r];
      s += rw * s_win[j * nr + r];
    }
    jt[k] = s * s_dlog[l * ns + j];
  }
}

template <typename T>
int launch(const void* y, const void* w_in, const void* w_b, const void* w_out,
           void* du, void* jac, long long batch, int ns, int nr, double lb,
           double ub, double exp_cap, int lanes, int threads, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0)
    return invalid;
  if (lanes < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return invalid;
  // the kernel's shared layout: weights, then (2 * ns + nr) values a lane
  const long long smem =
      (2LL * ns * nr + nr + static_cast<long long>(lanes) * (2 * ns + nr))
      * static_cast<long long>(sizeof(T));
  const long long blocks = (batch + lanes - 1) / lanes;
  if (smem > kMaxSharedBytes || blocks > INT_MAX) return invalid;
  if (batch == 0) return 0;
  crnn_rhs_jac_kernel<T><<<static_cast<unsigned>(blocks), threads,
                           static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_in),
      static_cast<const T*>(w_b), static_cast<const T*>(w_out),
      static_cast<T*>(du), static_cast<T*>(jac), batch, ns, nr, lanes,
      static_cast<T>(lb), static_cast<T>(ub), static_cast<T>(exp_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crnn_rhs_jac_f32(const void* y, const void* w_in, const void* w_b,
                     const void* w_out, void* du, void* jac, long long batch,
                     int ns, int nr, double lb, double ub, double exp_cap,
                     int lanes, int threads, void* stream) {
  return launch<float>(y, w_in, w_b, w_out, du, jac, batch, ns, nr, lb, ub,
                       exp_cap, lanes, threads, stream);
}

int crnn_rhs_jac_f64(const void* y, const void* w_in, const void* w_b,
                     const void* w_out, void* du, void* jac, long long batch,
                     int ns, int nr, double lb, double ub, double exp_cap,
                     int lanes, int threads, void* stream) {
  return launch<double>(y, w_in, w_b, w_out, du, jac, batch, ns, nr, lb, ub,
                        exp_cap, lanes, threads, stream);
}

}  // extern "C"
