// Whole adaptive Rosenbrock23 solve of a batch of case2-family Arrhenius
// lanes in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// crnn_tpu/ops/rb23_solve_kernel.py:_arrh_rb23_solve_kernel (launched
// through _arrh_rb23_solve_pallas, with _inv_rows). Each lane integrates
// y' = f(y), y = [x (ns species), T], from t0 to t1 with the Shampine 2(3)
// W-method: Hairer's initial dt, three stages over one Woodbury W-solve
// (the rank-nr Jacobian J = U V, inner matrix M = I - h d V U inverted by
// Gauss-Jordan without pivoting), the Hairer error norm and the
// I-controller, exactly as the JAX kernel body does, line by line. Every
// step's endpoints (t, t_new, accepted, y, y_new, f0, f2) are recorded into
// step-major histories (K, B) and (K, ns+1, B); the cubic-Hermite saveat
// output is a plain-torch post-pass (rb23_solve_kernel.py:_dense_output).
//
// What bounds it: not bytes and not flops. At case2's shapes (B = 30,
// ns = 6, nr = 3, ~60 steps) a lane's step is ~500 flops in a chain of
// dependent exp/log/div/sqrt/pow, and the lanes of a warp advance in lock
// step until the slowest is done: the serial step chain of the longest lane
// bounds the launch. The design follows from that: one thread per lane with
// the whole carry in registers (arrays sized by the compile-time caps
// kMaxSpecies / kMaxReactions, every loop unrolled to the cap and guarded by
// the runtime ns / nr, so no array index is dynamic), the weights and the
// Woodbury coefficients woodc[r*nr+q, j] = w_in[j, r] w_out[j, q] staged once
// per block in shared memory, 32 threads per block so that lanes spread over
// as many SMs as the batch allows, and history stores in which neighbouring
// lanes write neighbouring addresses. The temperature is kept apart from the
// species (Vec::t) so that it needs no dynamic index either.
//
// A lane leaves its loop when it is done or failed, or after max_steps
// iterations. That is the JAX kernel's global early exit per lane: there a
// finished lane's carry is frozen and its rows are written with accepted = 0,
// here its rows are not written at all; the wrapper zeroes accepted and the
// post-pass masks every history with it.
//
// NaN handling: min, max and clip are compare-and-select that propagate NaN
// as jnp.minimum / jnp.maximum do (fminf / fmaxf would drop it); a step whose
// y1 or error estimate is not finite is rejected. Built without
// --use_fast_math.
//
// Plain C interface, loaded with ctypes (crnn_tpu_torch/ops/rb23_solve_kernel.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxSpecies = 8;
constexpr int kMaxReactions = 4;
constexpr int kRunning = 0, kDone = 1, kFailed = 2;
constexpr double kInvRKcal = -1.0 / 1.98720425864083e-3;
constexpr double kSqrt2 = 1.4142135623730951;  // sqrt(2) rounded to double
constexpr double kD = 1.0 / (2.0 + kSqrt2);
constexpr double kE32 = 6.0 + kSqrt2;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float pow_t(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double pow_t(double x, double e) { return pow(x, e); }

// jnp.maximum / jnp.minimum: a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T mn(T a, T b) { return (a < b || a != a) ? a : b; }

// A lane's state vector: species x[0..ns) and the temperature t.
template <typename T>
struct Vec {
  T x[kMaxSpecies];
  T t;
};

// Block-shared constants of one solve.
template <typename T>
struct Params {
  const T* w_in;   // (ns+1, nr): w_in[j*nr + r]; row ns is the Ea feature
  const T* w_b;    // (nr,)
  const T* w_out;  // (ns, nr): w_out[i*nr + r]
  const T* woodc;  // (nr*nr, ns): woodc[(r*nr + q)*ns + j]
  int ns, nr;
  T lb, ub, exp_cap;
};

// du = [w_out . rates, 0] and rates (the JAX kernel's rhs, :104-112)
template <typename T>
__device__ __forceinline__ void rhs(const Params<T>& p, const Vec<T>& y,
                                    Vec<T>& du, T (&rates)[kMaxReactions]) {
  const T inv_t = static_cast<T>(kInvRKcal) / y.t;
  T logx[kMaxSpecies];
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j) {
    if (j < p.ns) {
      const T x = y.x[j];
      logx[j] = log_t(x < p.lb ? p.lb : (x > p.ub ? p.ub : x));
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxReactions; ++r) {
    if (r < p.nr) {
      T z = T(0);
#pragma unroll
      for (int j = 0; j < kMaxSpecies; ++j)
        if (j < p.ns) z += p.w_in[j * p.nr + r] * logx[j];
      z = z + p.w_in[p.ns * p.nr + r] * inv_t + p.w_b[r];
      rates[r] = exp_t(z > p.exp_cap ? p.exp_cap : z);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxSpecies; ++i) {
    if (i < p.ns) {
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < kMaxReactions; ++r)
        if (r < p.nr) acc += p.w_out[i * p.nr + r] * rates[r];
      du.x[i] = acc;
    }
  }
  du.t = T(0);
}

// Woodbury W-solve v + h d U M^-1 V v (the JAX kernel's wsolve, :174-184)
template <typename T>
__device__ __forceinline__ void wsolve(const Params<T>& p, const Vec<T>& v,
                                       const T (&dlog)[kMaxSpecies], T dt_feat,
                                       const T (&rates)[kMaxReactions],
                                       const T (&minv)[kMaxReactions][kMaxReactions],
                                       T hd, Vec<T>& out) {
  T s[kMaxReactions];
  const T vt = v.t * dt_feat;
#pragma unroll
  for (int r = 0; r < kMaxReactions; ++r) {
    if (r < p.nr) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < kMaxSpecies; ++j)
        if (j < p.ns) acc += p.w_in[j * p.nr + r] * (v.x[j] * dlog[j]);
      s[r] = rates[r] * (acc + p.w_in[p.ns * p.nr + r] * vt);
    }
  }
  T xr[kMaxReactions];
#pragma unroll
  for (int r = 0; r < kMaxReactions; ++r) {
    if (r < p.nr) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < kMaxReactions; ++q)
        if (q < p.nr) acc += minv[r][q] * s[q];
      xr[r] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxSpecies; ++i) {
    if (i < p.ns) {
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < kMaxReactions; ++r)
        if (r < p.nr) acc += p.w_out[i * p.nr + r] * xr[r];
      out.x[i] = v.x[i] + hd * acc;
    }
  }
  out.t = v.t + hd * T(0);
}

// sqrt(mean((v / scale)^2)) over the ns+1 rows
template <typename T>
__device__ __forceinline__ T rms(const Params<T>& p, const Vec<T>& v,
                                 const Vec<T>& scale) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j) {
    if (j < p.ns) {
      const T r = v.x[j] / scale.x[j];
      acc += r * r;
    }
  }
  const T r = v.t / scale.t;
  acc += r * r;
  return sqrt_t(acc / static_cast<T>(p.ns + 1));
}

// Hairer error norm with non-finite ratios as inf (:114-118)
template <typename T>
__device__ __forceinline__ T err_norm(const Params<T>& p, const Vec<T>& err,
                                      const Vec<T>& ya, const Vec<T>& yb,
                                      T rtol, T atol) {
  const T inf = static_cast<T>(INFINITY);
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j) {
    if (j < p.ns) {
      T r = err.x[j] / (atol + rtol * mx(fabs(ya.x[j]), fabs(yb.x[j])));
      r = isfinite(r) ? r : inf;
      acc += r * r;
    }
  }
  T r = err.t / (atol + rtol * mx(fabs(ya.t), fabs(yb.t)));
  r = isfinite(r) ? r : inf;
  acc += r * r;
  return sqrt_t(acc / static_cast<T>(p.ns + 1));
}

template <typename T>
__device__ __forceinline__ bool all_finite(const Params<T>& p, const Vec<T>& v) {
  bool ok = isfinite(v.t);
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j)
    if (j < p.ns) ok = ok && isfinite(v.x[j]);
  return ok;
}

// out = a + c * b
template <typename T>
__device__ __forceinline__ void axpy(const Params<T>& p, const Vec<T>& a, T c,
                                     const Vec<T>& b, Vec<T>& out) {
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j)
    if (j < p.ns) out.x[j] = a.x[j] + c * b.x[j];
  out.t = a.t + c * b.t;
}

template <typename T>
__device__ __forceinline__ void store(const Params<T>& p, const Vec<T>& v,
                                      T* __restrict__ hist, long long batch,
                                      long long lane) {
  // hist points at row i of a (K, ns+1, B) history
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j)
    if (j < p.ns) hist[j * batch + lane] = v.x[j];
  hist[p.ns * batch + lane] = v.t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
arrh_rb23_solve_kernel(const T* __restrict__ y0, const T* __restrict__ w_in,
                       const T* __restrict__ w_b, const T* __restrict__ w_out,
                       T* __restrict__ t_hist, T* __restrict__ tn_hist,
                       T* __restrict__ acc_hist, T* __restrict__ y_hist,
                       T* __restrict__ yn_hist, T* __restrict__ f0_hist,
                       T* __restrict__ f2_hist, int* __restrict__ status_out,
                       int* __restrict__ nsteps_out, T* __restrict__ y_final,
                       long long batch, int ns, int nr, int max_steps, double t0_d,
                       double t1_d, double rtol_d, double atol_d, double lb,
                       double ub, double exp_cap, double safety_d,
                       double factor_min_d, double factor_max_d,
                       double dtmin_d) {
  // shared layout: w_in (ns1*nr) | w_b (nr) | w_out (ns*nr) | woodc (nr*nr*ns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);
  T* s_wb = s_win + (ns + 1) * nr;
  T* s_wout = s_wb + nr;
  T* s_woodc = s_wout + ns * nr;
  for (int i = threadIdx.x; i < (ns + 1) * nr; i += blockDim.x) s_win[i] = w_in[i];
  for (int i = threadIdx.x; i < nr; i += blockDim.x) s_wb[i] = w_b[i];
  for (int i = threadIdx.x; i < ns * nr; i += blockDim.x) s_wout[i] = w_out[i];
  for (int i = threadIdx.x; i < nr * nr * ns; i += blockDim.x) {
    const int rq = i / ns, j = i % ns;
    s_woodc[i] = w_in[j * nr + rq / nr] * w_out[j * nr + rq % nr];
  }
  __syncthreads();

  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= batch) return;

  const Params<T> p{s_win, s_wb, s_wout, s_woodc, ns, nr, static_cast<T>(lb),
                    static_cast<T>(ub), static_cast<T>(exp_cap)};
  const T rtol = static_cast<T>(rtol_d), atol = static_cast<T>(atol_d);
  const T t1 = static_cast<T>(t1_d), span = static_cast<T>(t1_d - t0_d);
  const T safety = static_cast<T>(safety_d), dtmin = static_cast<T>(dtmin_d);
  const T factor_min = static_cast<T>(factor_min_d);
  const T factor_max = static_cast<T>(factor_max_d);
  const T inf = static_cast<T>(INFINITY);
  const T tiny = static_cast<T>(1e-30), small = static_cast<T>(1e-6);

  Vec<T> y;
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j)
    if (j < ns) y.x[j] = y0[lane * (ns + 1) + j];
  y.t = y0[lane * (ns + 1) + ns];

  T rates[kMaxReactions];
  // ---- Hairer automatic initial dt (:126-141) ----------------------------
  T dt;
  {
    Vec<T> f0, scale, probe, f1;
#pragma unroll
    for (int j = 0; j < kMaxSpecies; ++j)
      if (j < ns) scale.x[j] = atol + rtol * fabs(y.x[j]);
    scale.t = atol + rtol * fabs(y.t);
    rhs(p, y, f0, rates);
    const T d0 = rms(p, y, scale);
    const T d1 = rms(p, f0, scale);
    T h0 = (d0 < static_cast<T>(1e-5) || d1 < static_cast<T>(1e-5))
               ? small : static_cast<T>(0.01) * d0 / mx(d1, tiny);
    h0 = mn(h0, span);
    axpy(p, y, h0, f0, probe);
    rhs(p, probe, f1, rates);
    axpy(p, f1, T(-1), f0, probe);  // f1 - f0
    const T d2 = rms(p, probe, scale) / mx(h0, tiny);
    const T dmax = mx(d1, d2);
    const T h1 = dmax <= static_cast<T>(1e-15)
                     ? mx(small, h0 * static_cast<T>(1e-3))
                     : pow_t(static_cast<T>(0.01) / mx(dmax, tiny),
                             static_cast<T>(1.0 / 3.0));
    dt = mn(mn(static_cast<T>(100.0) * h0, h1), span);
  }

  T t = static_cast<T>(t0_d);
  int status = kRunning;
  int n_steps = 0;
  for (int i = 0; i < max_steps && status == kRunning; ++i) {
    const T t_rem = t1 - t;
    const bool clipped = dt >= t_rem;
    dt = mn(dt, t_rem);
    dt = mx(dt, T(0));
    const T hd = dt * static_cast<T>(kD);

    // ---- value + low-rank Jacobian factors, Woodbury inner matrix --------
    Vec<T> f0;
    rhs(p, y, f0, rates);
    T dlog[kMaxSpecies];
#pragma unroll
    for (int j = 0; j < kMaxSpecies; ++j) {
      if (j < ns) {
        const T x = y.x[j];
        const T xc = x < p.lb ? p.lb : (x > p.ub ? p.ub : x);
        dlog[j] = ((x > p.lb && x < p.ub) ? T(1) : T(0)) / xc;
      }
    }
    const T dt_feat = static_cast<T>(-kInvRKcal) / (y.t * y.t);
    T aug[kMaxReactions][kMaxReactions];
    T minv[kMaxReactions][kMaxReactions];
#pragma unroll
    for (int r = 0; r < kMaxReactions; ++r) {
#pragma unroll
      for (int q = 0; q < kMaxReactions; ++q) {
        if (r < nr && q < nr) {
          T vu = T(0);
#pragma unroll
          for (int j = 0; j < kMaxSpecies; ++j)
            if (j < ns) vu += p.woodc[(r * nr + q) * ns + j] * dlog[j];
          aug[r][q] = (r == q ? T(1) : T(0)) - hd * (rates[r] * vu);
          minv[r][q] = r == q ? T(1) : T(0);
        }
      }
    }
    // Gauss-Jordan without pivoting (_inv_rows, :59-82)
#pragma unroll
    for (int col = 0; col < kMaxReactions; ++col) {
      if (col < nr) {
        const T inv_piv = T(1) / aug[col][col];
#pragma unroll
        for (int q = 0; q < kMaxReactions; ++q) {
          if (q < nr) {
            aug[col][q] = aug[col][q] * inv_piv;
            minv[col][q] = minv[col][q] * inv_piv;
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxReactions; ++r) {
          if (r < nr && r != col) {
            const T f = aug[r][col];
#pragma unroll
            for (int q = 0; q < kMaxReactions; ++q) {
              if (q < nr) {
                aug[r][q] = aug[r][q] - f * aug[col][q];
                minv[r][q] = minv[r][q] - f * minv[col][q];
              }
            }
          }
        }
      }
    }

    // ---- three stages (:186-192) -----------------------------------------
    Vec<T> k1, k2, k3, f1, f2, y1, tmp;
    T rates_s[kMaxReactions];
    wsolve(p, f0, dlog, dt_feat, rates, minv, hd, k1);
    axpy(p, y, static_cast<T>(0.5) * dt, k1, tmp);
    rhs(p, tmp, f1, rates_s);
    axpy(p, f1, T(-1), k1, tmp);  // f1 - k1
    wsolve(p, tmp, dlog, dt_feat, rates, minv, hd, k2);
    axpy(p, k2, T(1), k1, k2);    // + k1
    axpy(p, y, dt, k2, y1);
    rhs(p, y1, f2, rates_s);
#pragma unroll
    for (int j = 0; j < kMaxSpecies; ++j)
      if (j < ns)
        tmp.x[j] = f2.x[j] - static_cast<T>(kE32) * (k2.x[j] - f1.x[j])
                   - T(2) * (k1.x[j] - f0.x[j]);
    tmp.t = f2.t - static_cast<T>(kE32) * (k2.t - f1.t) - T(2) * (k1.t - f0.t);
    wsolve(p, tmp, dlog, dt_feat, rates, minv, hd, k3);
    const T dt6 = dt / T(6);
    Vec<T> y_err;
#pragma unroll
    for (int j = 0; j < kMaxSpecies; ++j)
      if (j < ns) y_err.x[j] = dt6 * (k1.x[j] - T(2) * k2.x[j] + k3.x[j]);
    y_err.t = dt6 * (k1.t - T(2) * k2.t + k3.t);

    // ---- error, acceptance, step-endpoint histories (:194-211) -----------
    const bool ok = all_finite(p, y1) && all_finite(p, y_err);
    const T err = ok ? err_norm(p, y_err, y, y1, rtol, atol) : inf;
    const bool accept = err <= T(1);
    const T t_new = t + dt;
    const long long row = static_cast<long long>(i) * batch + lane;
    t_hist[row] = t;
    tn_hist[row] = t_new;
    acc_hist[row] = accept ? T(1) : T(0);
    const long long vrow = static_cast<long long>(i) * (ns + 1) * batch;
    store(p, y, y_hist + vrow, batch, lane);
    store(p, y1, yn_hist + vrow, batch, lane);
    store(p, f0, f0_hist + vrow, batch, lane);
    store(p, f2, f2_hist + vrow, batch, lane);

    // ---- I-controller and status (:214-233) ------------------------------
    const T errc = mx(err, static_cast<T>(1e-10));
    T factor = safety * pow_t(errc, static_cast<T>(-1.0 / 3.0));
    factor = mn(mx(factor, factor_min), accept ? factor_max : T(1));
    const T dt_next = dt * factor;
    status = (accept && clipped) ? kDone
                                 : (dt_next < dtmin ? kFailed : kRunning);
    if (accept) {
      t = t_new;
#pragma unroll
      for (int j = 0; j < kMaxSpecies; ++j)
        if (j < ns) y.x[j] = isfinite(y1.x[j]) ? y1.x[j] : T(0);
      y.t = isfinite(y1.t) ? y1.t : T(0);
    }
    dt = dt_next;
    ++n_steps;
  }
  status_out[lane] = status;
  nsteps_out[lane] = n_steps;
#pragma unroll
  for (int j = 0; j < kMaxSpecies; ++j)
    if (j < ns) y_final[lane * (ns + 1) + j] = y.x[j];
  y_final[lane * (ns + 1) + ns] = y.t;
}

template <typename T>
int launch(const void* y0, const void* w_in, const void* w_b, const void* w_out,
           void* t_hist, void* tn_hist, void* acc_hist, void* y_hist,
           void* yn_hist, void* f0_hist, void* f2_hist, void* status,
           void* n_steps, void* y_final, long long batch, int ns, int nr,
           int max_steps, double t0, double t1, double rtol, double atol,
           double lb, double ub, double exp_cap, double safety,
           double factor_min, double factor_max, double dtmin, void* stream) {
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0 ||
      max_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long blocks = (batch + kThreads - 1) / kThreads;
  const size_t smem =
      static_cast<size_t>((ns + 1) * nr + nr + ns * nr + nr * nr * ns) * sizeof(T);
  arrh_rb23_solve_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y0), static_cast<const T*>(w_in),
      static_cast<const T*>(w_b), static_cast<const T*>(w_out),
      static_cast<T*>(t_hist), static_cast<T*>(tn_hist),
      static_cast<T*>(acc_hist), static_cast<T*>(y_hist),
      static_cast<T*>(yn_hist), static_cast<T*>(f0_hist),
      static_cast<T*>(f2_hist), static_cast<int*>(status),
      static_cast<int*>(n_steps), static_cast<T*>(y_final), batch, ns, nr,
      max_steps, t0, t1, rtol, atol, lb, ub, exp_cap, safety, factor_min,
      factor_max, dtmin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ARRH_RB23_SOLVE_ENTRY(NAME, T)                                          \
  int NAME(const void* y0, const void* w_in, const void* w_b,                   \
           const void* w_out, void* t_hist, void* tn_hist, void* acc_hist,      \
           void* y_hist, void* yn_hist, void* f0_hist, void* f2_hist,           \
           void* status, void* n_steps, void* y_final, long long batch, int ns, \
           int nr, int max_steps, double t0, double t1, double rtol,            \
           double atol, double lb, double ub, double exp_cap, double safety,    \
           double factor_min, double factor_max, double dtmin, void* stream) {  \
    return launch<T>(y0, w_in, w_b, w_out, t_hist, tn_hist, acc_hist, y_hist,   \
                     yn_hist, f0_hist, f2_hist, status, n_steps, y_final,       \
                     batch, ns, nr, max_steps, t0, t1, rtol, atol, lb, ub,      \
                     exp_cap, safety, factor_min, factor_max, dtmin, stream);   \
  }

ARRH_RB23_SOLVE_ENTRY(arrh_rb23_solve_f32, float)
ARRH_RB23_SOLVE_ENTRY(arrh_rb23_solve_f64, double)

#undef ARRH_RB23_SOLVE_ENTRY

}  // extern "C"
