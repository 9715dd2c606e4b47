// Batched Arrhenius CRNN right-hand side and its dense Jacobian for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// crnn_tpu/ops/crnn_kernels.py:_arrh_rhs_jac_kernel (launched through
// _arrh_rhs_jac_pallas). For y (B, ns+1) whose last column is T, with
// rates_r = exp(min(w_in_x[:, r] . log(clip(x, lb, ub)) + w_ea_r * (-1/(R T))
// + w_b_r, exp_cap)) and dlog_j = [lb < x_j < ub] / clip(x_j, lb, ub):
//
//   du[b, i]     = sum_r w_out[i, r] rates_r          (i < ns), du[b, ns] = 0
//   J[b, i, j]   = (sum_r rates_r w_out[i, r] w_in_x[j, r]) dlog_j   (j < ns)
//   J[b, i, ns]  = (sum_r rates_r w_ea_r w_out[i, r]) / (R T^2)
//   J[b, ns, :]  = 0
//
// What bounds it: at the shapes of the case2 dense-mode epoch (B = 20 or 30,
// ns = 6, nr = 3, once per Rosenbrock23 step) one call reads ~0.8 KB and
// writes ~4.5 KB (J is 49 values a lane), so neither bytes (3.35 TB/s) nor
// flops bound it: the launch latency and the longest serial chain of one
// thread do. At large B the bytes of J do (B = 65536: 12.8 MB in f32). One
// thread per lane would run ns logs, ns + 2 divisions, nr exps and the
// (ns + 1)^2 dots of its outputs in a row, and a warp's J stores would be
// strided by (ns + 1)^2 values.
//
// The design is the isothermal kernel's flat lane tile (crnn_rhs_jac.cu)
// with the temperature column. A block owns `lanes` consecutive lanes, so
// its slices of y (B, ns+1), du (B, ns+1) and J (B, ns+1, ns+1) are
// contiguous spans. Each lane keeps two rows of ns + 1 values in shared
// memory: the features (logx, then inv_t = (-1/R)/T in column ns) and the
// column factors of J (dlog, then dt_feat = (1/R)/T^2 in column ns), so
// J[l, i, j] for i < ns is a dot times the factor of column j, in the T
// column too. Four phases over flat item indices in which consecutive
// threads touch consecutive addresses; a barrier after each of the first
// two:
//   1. (lane, column c <= ns): load y coalesced; for c < ns clip, log and
//      in_range / clip(x); for c = ns the two T features;
//   2. (lane, reaction): z = sum_i logx[i] w_in_x[i, r] (i ascending), then
//      + inv_t w_ea[r] + w_b[r], the cap, one exp into shared rates;
//   3. (lane, c <= ns): du = sum_r rates[r] w_out[c, r] (r ascending) for
//      c < ns, 0 for c = ns;
//   4. (lane, i, j) over (ns + 1)^2 items a lane: the x-block
//      (sum_r (rates[r] w_out[i, r]) w_in_x[j, r]) dlog[j], the product
//      rounded before its multiply-add as in the one-thread-per-lane kernel
//      this replaces; the T column (sum_r rates[r] w_ea[r] w_out[i, r])
//      dt_feat, associated as there; the T row 0.
// Every output is stored at its flat index: the J stores of a warp are one
// contiguous run. No item pays an integer division: a thread walks a
// phase's items from threadIdx.x in steps of blockDim.x, and carries its
// (lane, column) or (lane, i, j) forward with one compare a digit (FlatWalk,
// FlatWalk3), from a decomposition of its first index and of the step made
// once a phase. Weights staged once per block in shared memory; lanes and
// threads from crnn_tpu_torch/ops/crnn_kernels.py:tile_geometry with
// temperature=True, the shared bytes and the grid derived here, with the
// refusals of arrhenius_rhs.cu; no early return before a barrier (a ragged
// tile masks its items); no atomics, no scratch in device memory. The plain
// version's einsum may associate J's triple product otherwise, so J agrees
// with it to rounding, not bitwise.
//
// NaN handling: clip, the exp cap and the in-range mask are
// compare-and-select (fminf/fmaxf would drop a NaN), and dlog is
// in_range / xc, so a NaN species gives 0 / NaN = NaN exactly as the plain
// version does. The mask is the strict (x > lb) & (x < ub). The T row is
// stored as 0 whatever the inputs, as the plain version's zeros. Built
// without --use_fast_math.
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

// The same over k = (l * w + i) * w + j: (l, i) is a FlatWalk over rows of
// w, j the digit below it, with its own carry into i.
struct FlatWalk3 {
  FlatWalk li;
  int j, dj;
  __device__ explicit FlatWalk3(int w)
      : li(static_cast<int>(threadIdx.x) / w, static_cast<int>(blockDim.x) / w,
           w),
        j(static_cast<int>(threadIdx.x) % w),
        dj(static_cast<int>(blockDim.x) % w) {}
  __device__ void step(int w) {
    j += dj;
    if (j >= w) {
      j -= w;
      ++li.c;  // at most 2w - 1 after li.step below adds li.dc < w
    }
    li.step(w);
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
arrh_rhs_jac_kernel(const T* __restrict__ y, const T* __restrict__ w_in_x,
                    const T* __restrict__ w_ea, const T* __restrict__ w_b,
                    const T* __restrict__ w_out, T* __restrict__ du,
                    T* __restrict__ jac, long long batch, int ns, int nr,
                    int lanes, T lb, T ub, T exp_cap) {
  // shared layout: w_in_x (ns*nr) | w_out (ns*nr) | w_ea (nr) | w_b (nr) |
  //                feat (lanes*(ns+1): logx, inv_t) |
  //                fac (lanes*(ns+1): dlog, dt_feat) | rates (lanes*nr)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);
  T* s_wout = s_win + ns * nr;
  T* s_wea = s_wout + ns * nr;
  T* s_wb = s_wea + nr;
  T* s_feat = s_wb + nr;
  T* s_fac = s_feat + lanes * (ns + 1);
  T* s_rates = s_fac + lanes * (ns + 1);

  const int w = ns + 1;
  const int ww = w * w;
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
      const T in_range = (v > lb && v < ub) ? T(1) : T(0);
      s_fac[k] = in_range / xc;
    } else {
      s_feat[k] = static_cast<T>(kInvRKcal) / v;
      s_fac[k] = static_cast<T>(-kInvRKcal) / (v * v);
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

  // phase 3: (lane, column) for du
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

  // phase 4: (lane, i, j) for J
  T* jt = jac + lane0 * ww;
  FlatWalk3 p4(w);
  for (int k = threadIdx.x; k < n_lanes * ww; k += blockDim.x, p4.step(w)) {
    const int l = p4.li.q;
    const int i = p4.li.c;
    const int j = p4.j;
    T s = T(0);
    if (i < ns) {
      const T* lr = s_rates + l * nr;
      const T* wo = s_wout + i * nr;
      if (j < ns) {
        for (int r = 0; r < nr; ++r) {
          const T rw = lr[r] * wo[r];
          s += rw * s_win[j * nr + r];
        }
      } else {
        for (int r = 0; r < nr; ++r) s += lr[r] * s_wea[r] * wo[r];
      }
      s = s * s_fac[l * w + j];
    }
    jt[k] = s;
  }
}

template <typename T>
int launch(const void* y, const void* w_in_x, const void* w_ea, const void* w_b,
           const void* w_out, void* du, void* jac, long long batch, int ns,
           int nr, double lb, double ub, double exp_cap, int lanes, int threads,
           void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0)
    return invalid;
  if (lanes < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return invalid;
  // the kernel's shared layout: weights, then (2 * (ns + 1) + nr) values a
  // lane
  const long long smem =
      (2LL * ns * nr + 2 * nr
       + static_cast<long long>(lanes) * (2 * (ns + 1) + nr))
      * static_cast<long long>(sizeof(T));
  const long long blocks = (batch + lanes - 1) / lanes;
  if (smem > kMaxSharedBytes || blocks > INT_MAX) return invalid;
  if (batch == 0) return 0;
  arrh_rhs_jac_kernel<T><<<static_cast<unsigned>(blocks), threads,
                           static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_in_x),
      static_cast<const T*>(w_ea), static_cast<const T*>(w_b),
      static_cast<const T*>(w_out), static_cast<T*>(du), static_cast<T*>(jac),
      batch, ns, nr, lanes, static_cast<T>(lb), static_cast<T>(ub),
      static_cast<T>(exp_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int arrh_rhs_jac_f32(const void* y, const void* w_in_x, const void* w_ea,
                     const void* w_b, const void* w_out, void* du, void* jac,
                     long long batch, int ns, int nr, double lb, double ub,
                     double exp_cap, int lanes, int threads, void* stream) {
  return launch<float>(y, w_in_x, w_ea, w_b, w_out, du, jac, batch, ns, nr, lb,
                       ub, exp_cap, lanes, threads, stream);
}

int arrh_rhs_jac_f64(const void* y, const void* w_in_x, const void* w_ea,
                     const void* w_b, const void* w_out, void* du, void* jac,
                     long long batch, int ns, int nr, double lb, double ub,
                     double exp_cap, int lanes, int threads, void* stream) {
  return launch<double>(y, w_in_x, w_ea, w_b, w_out, du, jac, batch, ns, nr, lb,
                        ub, exp_cap, lanes, threads, stream);
}

}  // extern "C"
