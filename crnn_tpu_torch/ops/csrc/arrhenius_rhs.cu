// Batched Arrhenius CRNN right-hand side for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crnn_tpu/ops/crnn_kernels.py:_arrh_rhs_kernel
// (launched through _arrh_rhs_pallas). For y (B, ns+1) whose last column is T:
//
//   du[b, :ns] = w_out . exp(min(w_in_x^T log(clip(x_b, lb, ub))
//                                + w_ea * (-1/(R T_b)) + w_b, exp_cap))
//   du[b, ns]  = 0
//
// What bounds it: at the shapes of the case2 training epoch (B = 20 or 30,
// ns = 6, nr = 3, every stage of the solve) one call reads about 0.6 KB and
// writes about 0.56 KB, and does a few thousand flops, so neither bytes
// (3.35 TB/s) nor flops bound it: the launch latency and the longest serial
// chain of one thread do. One thread per lane would run ns logs, a division,
// nr exps and ns + nr dots in a row, and its loads and stores would be
// strided by ns + 1 values across a warp.
//
// The design is the isothermal kernel's flat lane tile (crnn_rhs.cu) with
// the temperature column. A block owns `lanes` consecutive lanes, so its
// slices of y (B, ns+1) and du (B, ns+1) are contiguous spans. Each lane
// keeps a row of ns + 1 features in shared memory: logx in columns 0..ns-1
// and the T feature inv_t = (-1/R)/T in column ns, so a feature sits at the
// flat index of the y value it comes from. Three phases, each a loop over a
// flat item index in which consecutive threads touch consecutive addresses,
// separated by barriers:
//   1. (lane, column c <= ns): load y coalesced; for c < ns clip and log into
//      the feature row, for c = ns the T feature;
//   2. (lane, reaction): z = sum_i logx[i] w_in_x[i, r] (i ascending), then
//      + inv_t w_ea[r] + w_b[r], the cap, one exp into shared rates;
//   3. (lane, c <= ns): du = sum_r rates[r] w_out[c, r] (r ascending) for
//      c < ns, 0 for c = ns, stored at its flat index.
// A thread walks a phase's items from threadIdx.x in steps of blockDim.x
// and carries its (lane, column) forward with one compare a step (FlatWalk),
// so no item pays an integer division. The weights are staged once per
// block in shared memory. The wrapper chooses the lanes and threads
// (crnn_tpu_torch/ops/crnn_kernels.py:tile_geometry with temperature=True);
// the launcher derives the shared bytes from the layout below and the grid
// ceil(B / lanes), and refuses through the return code no lanes, threads
// that are not whole warps within 256 or a layout above 48 KB. No thread
// returns early: a ragged last tile masks its items, so every thread
// reaches every barrier. No atomics, no scratch in device memory. Every
// expression is the one-thread-per-lane kernel's, in the same order, so du
// is bitwise the same.
//
// NaN handling: clip and min are compare-and-select, so a NaN input gives a
// NaN output, as XLA and torch.minimum/torch.maximum do (fminf/fmaxf would
// drop it). The solver rejects a step through isfinite(y1), so the kernel
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
constexpr double kInvRKcal = -1.0 / 1.98720425864083e-3;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

// A thread's walk over the flat items k = q * w + c of one phase: it starts
// at k = start and steps by step = dq * w + dc, carrying (q, c) with one
// compare a step; by default from threadIdx.x in steps of blockDim.x.
struct FlatWalk {
  int q, c, dq, dc;
  __device__ FlatWalk(int start, int step, int w)
      : q(start / w), c(start % w), dq(step / w), dc(step % w) {}
  __device__ explicit FlatWalk(int w)
      : FlatWalk(static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x),
                 w) {}
  __device__ void step(int w) {
    q += dq;
    c += dc;
    if (c >= w) {
      c -= w;
      ++q;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
arrh_rhs_kernel(const T* __restrict__ y, const T* __restrict__ w_in_x,
                const T* __restrict__ w_ea, const T* __restrict__ w_b,
                const T* __restrict__ w_out, T* __restrict__ du,
                long long batch, int ns, int nr, int lanes, T lb, T ub,
                T exp_cap) {
  // shared layout: w_in_x (ns*nr) | w_out (ns*nr) | w_ea (nr) | w_b (nr) |
  //                feat (lanes*(ns+1): logx, inv_t) | rates (lanes*nr)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);
  T* s_wout = s_win + ns * nr;
  T* s_wea = s_wout + ns * nr;
  T* s_wb = s_wea + nr;
  T* s_feat = s_wb + nr;
  T* s_rates = s_feat + lanes * (ns + 1);

  const int w = ns + 1;
  const long long lane0 = static_cast<long long>(blockIdx.x) * lanes;
  const long long left = batch - lane0;
  const int n_lanes = left < lanes ? static_cast<int>(left) : lanes;

  for (int k = threadIdx.x; k < ns * nr; k += blockDim.x) {
    s_win[k] = w_in_x[k];
    s_wout[k] = w_out[k];
  }
  for (int k = threadIdx.x; k < nr; k += blockDim.x) {
    s_wea[k] = w_ea[k];
    s_wb[k] = w_b[k];
  }

  // phase 1: (lane, column)
  const T* yt = y + lane0 * w;
  FlatWalk p1(w);
  for (int k = threadIdx.x; k < n_lanes * w; k += blockDim.x, p1.step(w)) {
    const T v = yt[k];
    if (p1.c < ns) {
      const T xc = v < lb ? lb : (v > ub ? ub : v);
      s_feat[k] = log_t(xc);
    } else {
      s_feat[k] = static_cast<T>(kInvRKcal) / v;
    }
  }
  __syncthreads();

  // phase 2: (lane, reaction)
  FlatWalk p2(nr);
  for (int k = threadIdx.x; k < n_lanes * nr; k += blockDim.x, p2.step(nr)) {
    const int r = p2.c;
    const T* lf = s_feat + p2.q * w;
    T z = T(0);
    for (int i = 0; i < ns; ++i) z += lf[i] * s_win[i * nr + r];
    z = z + lf[ns] * s_wea[r] + s_wb[r];
    s_rates[k] = exp_t(z > exp_cap ? exp_cap : z);
  }
  __syncthreads();

  // phase 3: (lane, column)
  T* dt = du + lane0 * w;
  FlatWalk p3(w);
  for (int k = threadIdx.x; k < n_lanes * w; k += blockDim.x, p3.step(w)) {
    T acc = T(0);
    if (p3.c < ns) {
      const T* lr = s_rates + p3.q * nr;
      for (int r = 0; r < nr; ++r) acc += lr[r] * s_wout[p3.c * nr + r];
    }
    dt[k] = acc;
  }
}

template <typename T>
int launch(const void* y, const void* w_in_x, const void* w_ea, const void* w_b,
           const void* w_out, void* du, long long batch, int ns, int nr,
           double lb, double ub, double exp_cap, int lanes, int threads,
           void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0)
    return invalid;
  if (lanes < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return invalid;
  // the kernel's shared layout: weights, then (ns + 1 + nr) values a lane
  const long long smem =
      (2LL * ns * nr + 2 * nr + static_cast<long long>(lanes) * (ns + 1 + nr))
      * static_cast<long long>(sizeof(T));
  const long long blocks = (batch + lanes - 1) / lanes;
  if (smem > kMaxSharedBytes || blocks > INT_MAX) return invalid;
  if (batch == 0) return 0;
  arrh_rhs_kernel<T><<<static_cast<unsigned>(blocks), threads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_in_x),
      static_cast<const T*>(w_ea), static_cast<const T*>(w_b),
      static_cast<const T*>(w_out), static_cast<T*>(du), batch, ns, nr, lanes,
      static_cast<T>(lb), static_cast<T>(ub), static_cast<T>(exp_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int arrh_rhs_f32(const void* y, const void* w_in_x, const void* w_ea,
                 const void* w_b, const void* w_out, void* du, long long batch,
                 int ns, int nr, double lb, double ub, double exp_cap,
                 int lanes, int threads, void* stream) {
  return launch<float>(y, w_in_x, w_ea, w_b, w_out, du, batch, ns, nr, lb, ub,
                       exp_cap, lanes, threads, stream);
}

int arrh_rhs_f64(const void* y, const void* w_in_x, const void* w_ea,
                 const void* w_b, const void* w_out, void* du, long long batch,
                 int ns, int nr, double lb, double ub, double exp_cap,
                 int lanes, int threads, void* stream) {
  return launch<double>(y, w_in_x, w_ea, w_b, w_out, du, batch, ns, nr, lb, ub,
                        exp_cap, lanes, threads, stream);
}

}  // extern "C"
