// Latency of one dependent operation of each class on the card: a
// measurement aid for the latency bound of the whole-solve kernel
// (chip_smoke.py:rb23_latency_bound_ms), not a kernel of the solver.
//
// One warp runs a chain of n dependent operations of one class, in the
// arithmetic the solve kernel uses (no --use_fast_math): FMA, IEEE
// division, sqrt, exp, log, pow, a shuffle within a group of 8, and the
// NaN-propagating compare-and-select max. The caller times launches of two
// lengths with CUDA events; the difference over the difference of n is one
// operation's latency. Each chain is kept inside the normal range, away
// from the special-value branches of the math library.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Op { kFma = 0, kDiv, kSqrt, kExp, kLog, kPow, kShfl, kMax, kNumOps };

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float pow_t(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double pow_t(double x, double e) { return pow(x, e); }

template <typename T>
__device__ __forceinline__ T step(int op, T x, T a, T b) {
  switch (op) {
    case kFma: return x * a + b;               // a = b = 0.5: -> 1
    case kDiv: return a / x;                   // x0, a / x0, x0, ...
    case kSqrt: return sqrt_t(x);              // -> 1
    case kExp: return exp_t(-x);               // -> 0.567
    case kLog: return -log_t(x);               // -> 0.567
    case kPow: return pow_t(a, x);             // a = 0.5: -> 0.641
    case kShfl: return __shfl_xor_sync(0xffffffffu, x, 1, 8);
    default: return (x > a || x != x) ? x : a; // the solver's mx
  }
}

template <typename T>
__global__ void latency_chain(int op, int n, T x0, T a, T b, T* out) {
  // a shuffle of a warp-uniform value may be folded away: give each thread
  // its own start there
  T x = op == kShfl ? x0 + static_cast<T>(threadIdx.x) : x0;
  // the op is uniform: one branch, then a straight chain
  switch (op) {
#define CHAIN(OP)                                         \
  case OP:                                                \
    for (int i = 0; i < n; i += 8) {                      \
      _Pragma("unroll") for (int k = 0; k < 8; ++k)       \
        x = step<T>(OP, x, a, b);                         \
    }                                                     \
    break;
    CHAIN(kFma) CHAIN(kDiv) CHAIN(kSqrt) CHAIN(kExp) CHAIN(kLog) CHAIN(kPow)
    CHAIN(kShfl) CHAIN(kMax)
#undef CHAIN
  }
  out[threadIdx.x] = x;
}

template <typename T>
int launch(int op, int n, double x0, double a, double b, void* out,
           void* stream) {
  if (op < 0 || op >= kNumOps || n < 0 || n % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  latency_chain<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      op, n, static_cast<T>(x0), static_cast<T>(a), static_cast<T>(b),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int latency_chain_f32(int op, int n, double x0, double a, double b, void* out,
                      void* stream) {
  return launch<float>(op, n, x0, a, b, out, stream);
}

int latency_chain_f64(int op, int n, double x0, double a, double b, void* out,
                      void* stream) {
  return launch<double>(op, n, x0, a, b, out, stream);
}

}  // extern "C"
