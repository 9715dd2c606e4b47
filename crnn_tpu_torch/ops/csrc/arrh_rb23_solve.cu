// Whole adaptive Rosenbrock23 solve of a batch of case2-family Arrhenius
// lanes in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// crnn_tpu/ops/rb23_solve_kernel.py:85 _arrh_rb23_solve_kernel (launched
// through _arrh_rb23_solve_pallas, :294, with _inv_rows). Each lane
// integrates y' = f(y), y = [x (ns species), T], from t0 to t1 with the
// Shampine 2(3) W-method: Hairer's initial dt, three stages over one
// Woodbury W-solve (the rank-nr Jacobian J = U V, inner matrix
// M = I - h d V U inverted by Gauss-Jordan without pivoting), the Hairer
// error norm and the I-controller, exactly as the JAX kernel body does,
// line by line. Every step's endpoints (t, t_new, accepted, y, y_new, f0,
// f2) are recorded into step-major histories (K, B) and (K, ns+1, B); the
// cubic-Hermite saveat output is a plain-torch post-pass
// (rb23_solve_kernel.py:_dense_output).
//
// What bounds it: not bytes and not flops. A lane's steps form one serial
// chain of dependent log/exp/div/sqrt/pow, and the launch lasts as long as
// its longest lane (~60 steps at case2's shapes). At case2's B = 30 a
// thread per lane made the whole solve one warp on one SM scheduler, which
// issued a step's thousands of instructions one by one.
//
// The design shortens what one thread issues per step:
// - A group of G threads (8, or 16 for ns + 1 > 8) carries one lane.
//   Thread c owns state component c (species c, the temperature at
//   c = ns) and reaction c (c < nr): its log, its exp, its dlog division,
//   its error ratio and its history stores. At B = 30 that is eight warps.
// - Every dot product gathers its terms from the group by __shfl_sync and
//   sums them in one thread in the order of the one-thread version, j = 0
//   .. ns, so the sums round as before. The per-lane scalars (dt, hd, the
//   nr x nr Woodbury inverse, err, pow, the status) are computed the same
//   way in every thread of the group.
// - Loops are unrolled over compile-time bounds: (NS, NR) = (6, 3), case2's
//   shape, is one instantiation with constant weight indices and no guarded
//   iterations; NS = NR = 0 takes (ns, nr) at launch and unrolls to the caps
//   kMaxSpecies / kMaxReactions with guards. Each thread keeps its own
//   weights in registers: its reaction's orders, its species' row of w_out
//   and its reaction's Woodbury coefficients woodc[c, q, j] =
//   w_in[j, c] w_out[j, q].
// - A lane that is done stays in the loop, its state and stores frozen,
//   until no lane of its warp runs (a warp vote), so every shuffle names
//   the whole warp; lanes past the batch copy the last lane and never
//   store. That is the JAX kernel's global early exit per warp. Unvisited
//   history rows are never written; the wrapper zeroes accepted and the
//   post-pass masks every history with it.
//
// NaN handling: min, max and clip are compare-and-select that propagate NaN
// as jnp.minimum / jnp.maximum do (fminf / fmaxf would drop it); a step whose
// y1 or error estimate is not finite is rejected. Built without
// --use_fast_math: expf / logf / powf / sqrtf and IEEE division.
//
// Plain C interface, loaded with ctypes (crnn_tpu_torch/ops/rb23_solve_kernel.py,
// whose solve_geometry gives the launch geometry).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxSpecies = 8;
constexpr int kMaxReactions = 4;
constexpr unsigned kFullWarp = 0xffffffffu;
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

// One thread of a lane's group: its component c, its weights, and the
// group's collective pieces of a step. NS, NR > 0 fix (ns, nr); 0 takes
// them at launch. Every member that shuffles is called by the whole warp.
template <typename T, int NS, int NR, int G>
struct Group {
  static constexpr int CS = NS > 0 ? NS : kMaxSpecies;    // species loops
  static constexpr int CR = NR > 0 ? NR : kMaxReactions;  // reaction loops

  int ns, nr, c;  // ns == NS and nr == NR where those are fixed
  T lb, ub, exp_cap;
  T wi[CS];      // w_in[j, c]: reaction c's orders
  T wea, wb;     // w_in[ns, c] (the Ea feature) and w_b[c]
  T wo[CR];      // w_out[c, r]: species c's stoichiometry
  T wc[CR][CS];  // woodc[c, q, j] = w_in[j, c] * w_out[j, q], rounded

  __device__ __forceinline__ T at(T v, int j) const {
    return __shfl_sync(kFullWarp, v, j, G);
  }

  __device__ void load(const T* __restrict__ w_in, const T* __restrict__ w_b,
                       const T* __restrict__ w_out) {
    const bool reaction = c < nr, species = c < ns;
    wea = T(0);
    wb = T(0);
    if (reaction) {
      wea = w_in[ns * nr + c];
      wb = w_b[c];
    }
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      wi[j] = T(0);
      if (j < ns && reaction) wi[j] = w_in[j * nr + c];
    }
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      wo[r] = T(0);
      if (r < nr && species) wo[r] = w_out[c * nr + r];
    }
#pragma unroll
    for (int q = 0; q < CR; ++q) {
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        wc[q][j] = T(0);
        if (q < nr && j < ns && reaction) wc[q][j] = wi[j] * w_out[j * nr + q];
      }
    }
  }

  // du_c = (w_out . rates)_c, 0 at the temperature; rate = rates_c (the
  // JAX kernel's rhs, :104-112)
  __device__ __forceinline__ void rhs(T yc, T& du, T& rate) const {
    const T inv_t = static_cast<T>(kInvRKcal) / at(yc, ns);
    const T logx = log_t(yc < lb ? lb : (yc > ub ? ub : yc));
    T z = T(0);
#pragma unroll
    for (int j = 0; j < CS; ++j)
      if (j < ns) z += wi[j] * at(logx, j);
    z = z + wea * inv_t + wb;
    rate = exp_t(z > exp_cap ? exp_cap : z);
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < CR; ++r)
      if (r < nr) acc += wo[r] * at(rate, r);
    du = c < ns ? acc : T(0);
  }

  // J's column factor of component c: dlog_c for a species, dt_feat =
  // 1 / (R T^2) at the temperature (:160-165)
  __device__ __forceinline__ T column_factor(T yc) const {
    const T xc = yc < lb ? lb : (yc > ub ? ub : yc);
    const T num = c < ns ? ((yc > lb && yc < ub) ? T(1) : T(0))
                         : static_cast<T>(-kInvRKcal);
    return num / (c < ns ? xc : yc * yc);
  }

  // M^-1 of M = I - hd V U, in every thread: row c of M (c < nr) from this
  // thread's coefficients, broadcast, then Gauss-Jordan without pivoting
  // (:167-172, _inv_rows :59-82)
  __device__ __forceinline__ void inverse(T fac, T rate, T hd,
                                          T (&minv)[CR][CR]) const {
    T dlog[CS];
#pragma unroll
    for (int j = 0; j < CS; ++j)
      if (j < ns) dlog[j] = at(fac, j);
    T row[CR];
#pragma unroll
    for (int q = 0; q < CR; ++q) {
      if (q < nr) {
        T vu = T(0);
#pragma unroll
        for (int j = 0; j < CS; ++j)
          if (j < ns) vu += wc[q][j] * dlog[j];
        row[q] = (c == q ? T(1) : T(0)) - hd * (rate * vu);
      }
    }
    T aug[CR][CR];
#pragma unroll
    for (int r = 0; r < CR; ++r) {
#pragma unroll
      for (int q = 0; q < CR; ++q) {
        if (r < nr && q < nr) {
          aug[r][q] = at(row[q], r);
          minv[r][q] = r == q ? T(1) : T(0);
        }
      }
    }
#pragma unroll
    for (int col = 0; col < CR; ++col) {
      if (col < nr) {
        const T inv_piv = T(1) / aug[col][col];
#pragma unroll
        for (int q = 0; q < CR; ++q) {
          if (q < nr) {
            aug[col][q] = aug[col][q] * inv_piv;
            minv[col][q] = minv[col][q] * inv_piv;
          }
        }
#pragma unroll
        for (int r = 0; r < CR; ++r) {
          if (r < nr && r != col) {
            const T f = aug[r][col];
#pragma unroll
            for (int q = 0; q < CR; ++q) {
              if (q < nr) {
                aug[r][q] = aug[r][q] - f * aug[col][q];
                minv[r][q] = minv[r][q] - f * minv[col][q];
              }
            }
          }
        }
      }
    }
  }

  // component c of the Woodbury W-solve v + hd U M^-1 V v (:174-184)
  __device__ __forceinline__ T wsolve(T v, T fac, T rate,
                                      const T (&minv)[CR][CR], T hd) const {
    const T vd = v * fac;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < CS; ++j)
      if (j < ns) acc += wi[j] * at(vd, j);
    const T s = rate * (acc + wea * at(vd, ns));
    T sq[CR];
#pragma unroll
    for (int q = 0; q < CR; ++q)
      if (q < nr) sq[q] = at(s, q);
    T u = T(0);
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      if (r < nr) {
        T xr = T(0);
#pragma unroll
        for (int q = 0; q < CR; ++q)
          if (q < nr) xr += minv[r][q] * sq[q];
        u += wo[r] * xr;
      }
    }
    return v + hd * (c < ns ? u : T(0));
  }

  // sqrt(mean(r^2)) over the ns + 1 components, summed in component order
  __device__ __forceinline__ T rms(T r) const {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      if (j < ns) {
        const T rj = at(r, j);
        acc += rj * rj;
      }
    }
    const T rt = at(r, ns);
    acc += rt * rt;
    return sqrt_t(acc / static_cast<T>(ns + 1));
  }

  // true when ok holds for every component of the lane
  __device__ __forceinline__ bool all(bool ok) const {
    int v = (c > ns || ok) ? 1 : 0;
#pragma unroll
    for (int o = G / 2; o > 0; o /= 2) v &= __shfl_xor_sync(kFullWarp, v, o, G);
    return v != 0;
  }
};

template <typename T, int NS, int NR, int G>
__global__ void __launch_bounds__(kMaxThreads, 1)
arrh_rb23_solve_kernel(const T* __restrict__ y0, const T* __restrict__ w_in,
                       const T* __restrict__ w_b, const T* __restrict__ w_out,
                       T* __restrict__ t_hist, T* __restrict__ tn_hist,
                       T* __restrict__ acc_hist, T* __restrict__ y_hist,
                       T* __restrict__ yn_hist, T* __restrict__ f0_hist,
                       T* __restrict__ f2_hist, int* __restrict__ status_out,
                       int* __restrict__ nsteps_out, T* __restrict__ y_final,
                       long long batch, int ns_rt, int nr_rt, int max_steps,
                       double t0_d, double t1_d, double rtol_d, double atol_d,
                       double lb, double ub, double exp_cap, double safety_d,
                       double factor_min_d, double factor_max_d,
                       double dtmin_d) {
  using Grp = Group<T, NS, NR, G>;
  Grp g;
  g.ns = NS > 0 ? NS : ns_rt;
  g.nr = NR > 0 ? NR : nr_rt;
  g.c = static_cast<int>(threadIdx.x % G);
  g.lb = static_cast<T>(lb);
  g.ub = static_cast<T>(ub);
  g.exp_cap = static_cast<T>(exp_cap);
  g.load(w_in, w_b, w_out);
  const int ns = g.ns, c = g.c;
  const int ns1 = ns + 1;

  const long long lane = static_cast<long long>(blockIdx.x) * (blockDim.x / G)
                         + threadIdx.x / G;
  const bool live = lane < batch;
  const long long src = live ? lane : batch - 1;

  const T rtol = static_cast<T>(rtol_d), atol = static_cast<T>(atol_d);
  const T t1 = static_cast<T>(t1_d), span = static_cast<T>(t1_d - t0_d);
  const T safety = static_cast<T>(safety_d), dtmin = static_cast<T>(dtmin_d);
  const T factor_min = static_cast<T>(factor_min_d);
  const T factor_max = static_cast<T>(factor_max_d);
  const T inf = static_cast<T>(INFINITY);
  const T tiny = static_cast<T>(1e-30), small = static_cast<T>(1e-6);

  // this thread's component of y; a thread past ns + 1 holds a harmless 1
  T y = c < ns1 ? y0[src * ns1 + c] : T(1);

  // ---- Hairer automatic initial dt (:126-141) ------------------------------
  T dt;
  {
    const T scale = atol + rtol * fabs(y);
    T f0, f1, rate;
    g.rhs(y, f0, rate);
    const T d0 = g.rms(y / scale);
    const T d1 = g.rms(f0 / scale);
    T h0 = (d0 < static_cast<T>(1e-5) || d1 < static_cast<T>(1e-5))
               ? small : static_cast<T>(0.01) * d0 / mx(d1, tiny);
    h0 = mn(h0, span);
    g.rhs(y + h0 * f0, f1, rate);
    const T d2 = g.rms((f1 + T(-1) * f0) / scale) / mx(h0, tiny);
    const T dmax = mx(d1, d2);
    const T h1 = dmax <= static_cast<T>(1e-15)
                     ? mx(small, h0 * static_cast<T>(1e-3))
                     : pow_t(static_cast<T>(0.01) / mx(dmax, tiny),
                             static_cast<T>(1.0 / 3.0));
    dt = mn(mn(static_cast<T>(100.0) * h0, h1), span);
  }

  T t = static_cast<T>(t0_d);
  int status = live ? kRunning : kDone;
  int n_steps = 0;
  for (int i = 0; i < max_steps; ++i) {
    const bool running = status == kRunning;
    if (!__any_sync(kFullWarp, running)) break;
    const T t_rem = t1 - t;
    const bool clipped = dt >= t_rem;
    T h = mn(dt, t_rem);
    h = mx(h, T(0));
    const T hd = h * static_cast<T>(kD);

    // ---- value, low-rank Jacobian factors, Woodbury inverse --------------
    T f0, rate;
    g.rhs(y, f0, rate);
    const T fac = g.column_factor(y);
    T minv[Grp::CR][Grp::CR];
    g.inverse(fac, rate, hd, minv);

    // ---- three stages (:186-192) -------------------------------------------
    T f1, f2, rate_s;
    const T k1 = g.wsolve(f0, fac, rate, minv, hd);
    g.rhs(y + (static_cast<T>(0.5) * h) * k1, f1, rate_s);
    T k2 = g.wsolve(f1 + T(-1) * k1, fac, rate, minv, hd);
    k2 = k2 + T(1) * k1;
    const T y1 = y + h * k2;
    g.rhs(y1, f2, rate_s);
    const T k3 = g.wsolve(
        f2 - static_cast<T>(kE32) * (k2 - f1) - T(2) * (k1 - f0), fac, rate,
        minv, hd);
    const T dt6 = h / T(6);
    const T y_err = dt6 * (k1 - T(2) * k2 + k3);

    // ---- error, acceptance, step-endpoint histories (:194-211) ------------
    const bool ok = g.all(isfinite(y1) && isfinite(y_err));
    T ratio = y_err / (atol + rtol * mx(fabs(y), fabs(y1)));
    ratio = isfinite(ratio) ? ratio : inf;
    const T norm = g.rms(ratio);
    const T err = ok ? norm : inf;
    const bool accept = err <= T(1);
    const T t_new = t + h;
    if (running) {
      const long long row = static_cast<long long>(i) * batch + lane;
      if (c == 0) t_hist[row] = t;
      if (c == 1) tn_hist[row] = t_new;
      if (c == 2) acc_hist[row] = accept ? T(1) : T(0);
      if (c < ns1) {
        const long long v = (static_cast<long long>(i) * ns1 + c) * batch + lane;
        y_hist[v] = y;
        yn_hist[v] = y1;
        f0_hist[v] = f0;
        f2_hist[v] = f2;
      }
    }

    // ---- I-controller and status (:214-233) --------------------------------
    const T errc = mx(err, static_cast<T>(1e-10));
    T factor = safety * pow_t(errc, static_cast<T>(-1.0 / 3.0));
    factor = mn(mx(factor, factor_min), accept ? factor_max : T(1));
    const T dt_next = h * factor;
    if (running) {
      status = (accept && clipped) ? kDone
                                   : (dt_next < dtmin ? kFailed : kRunning);
      if (accept) {
        t = t_new;
        y = isfinite(y1) ? y1 : T(0);
      }
      dt = dt_next;
      ++n_steps;
    }
  }
  if (live) {
    if (c == 0) {
      status_out[lane] = status;
      nsteps_out[lane] = n_steps;
    }
    if (c < ns1) y_final[lane * ns1 + c] = y;
  }
}

template <typename T>
int launch(const void* y0, const void* w_in, const void* w_b, const void* w_out,
           void* t_hist, void* tn_hist, void* acc_hist, void* y_hist,
           void* yn_hist, void* f0_hist, void* f2_hist, void* status,
           void* n_steps, void* y_final, long long batch, int ns, int nr,
           int max_steps, double t0, double t1, double rtol, double atol,
           double lb, double ub, double exp_cap, double safety,
           double factor_min, double factor_max, double dtmin, int group,
           int lanes, void* stream) {
  // the group is 8 or 16 threads (a power of two that covers ns + 1, with
  // an instantiation); a block holds whole warps within kMaxThreads
  const long long threads = static_cast<long long>(group) * lanes;
  if (ns < 1 || ns > kMaxSpecies || nr < 1 || nr > kMaxReactions || batch < 0 ||
      max_steps < 1 || (group != 8 && group != 16) || group < ns + 1 ||
      lanes < 1 || threads % 32 != 0 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long blocks = (batch + lanes - 1) / lanes;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = group == 16                  ? arrh_rb23_solve_kernel<T, 0, 0, 16>
                : (ns == 6 && nr == 3)       ? arrh_rb23_solve_kernel<T, 6, 3, 8>
                                             : arrh_rb23_solve_kernel<T, 0, 0, 8>;
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads), 0,
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
           double factor_min, double factor_max, double dtmin, int group,       \
           int lanes, void* stream) {                                           \
    return launch<T>(y0, w_in, w_b, w_out, t_hist, tn_hist, acc_hist, y_hist,   \
                     yn_hist, f0_hist, f2_hist, status, n_steps, y_final,       \
                     batch, ns, nr, max_steps, t0, t1, rtol, atol, lb, ub,      \
                     exp_cap, safety, factor_min, factor_max, dtmin, group,     \
                     lanes, stream);                                            \
  }

ARRH_RB23_SOLVE_ENTRY(arrh_rb23_solve_f32, float)
ARRH_RB23_SOLVE_ENTRY(arrh_rb23_solve_f64, double)

#undef ARRH_RB23_SOLVE_ENTRY

}  // extern "C"
