// The velocity of Becker's viscous shock wave at given wave coordinates,
// by bisection of its implicit profile: one thread per point, the halvings
// in registers.
//
// This replaces no TPU kernel: the TPU package evaluates the same bisection
// (esdg_cns_tpu/physics/exact.py BeckerShock.velocity_jax, a fori_loop of
// 100 halvings) under jit, where XLA fuses it.  In the port the eager
// version (physics/exact.BeckerShock.velocity_torch through
// ops/becker_bisect.becker_bisect_plain) is some 1,400 small launches per
// call, and the Becker shock tubes call it once per RHS for their
// Dirichlet ghosts.
//
// It repeats the eager version's arithmetic exactly: the same bracket,
//   f(v) = -xi + c2 (a log(v0 - v) - b log(v - v1)),
// each operation rounded once to T in the eager order (the __*_rn
// intrinsics forbid contraction into FMAs), the scalars rounded to T as
// PyTorch rounds a Python float against a tensor of T, and the IEEE log
// of libdevice, which PyTorch's log also calls.  So both agree bitwise.
//
// What bounds it: per point `iters` halvings of two logarithms and ten
// other operations, against 2 values of I/O: operations, and at the
// tubes' few thousand face points, launch latency.
#include <cuda_runtime.h>

namespace esdg {

__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}
__device__ __forceinline__ float sub_rn(float x, float y) {
  return __fsub_rn(x, y);
}
__device__ __forceinline__ double sub_rn(double x, double y) {
  return __dsub_rn(x, y);
}
__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}

template <typename T>
__global__ void __launch_bounds__(256)
    becker_bisect_kernel(const T* __restrict__ xi, T* __restrict__ u,
                         long long n, T a, T b, T c2, T v0, T v1, T lo0,
                         T hi0, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T nxi = -xi[i];
  T lo = lo0, hi = hi0;
  for (int it = 0; it < iters; ++it) {
    const T mid = mul_rn(T(0.5), add_rn(lo, hi));
    const T la = mul_rn(a, log(sub_rn(v0, mid)));
    const T lb = mul_rn(b, log(sub_rn(mid, v1)));
    const T f = add_rn(nxi, mul_rn(c2, sub_rn(la, lb)));
    if (f > T(0)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  u[i] = mul_rn(T(0.5), add_rn(lo, hi));
}

template <typename T>
int launch_becker_bisect(const void* xi, void* u, long long n, double a,
                         double b, double c2, double v0, double v1,
                         double lo, double hi, int iters,
                         cudaStream_t stream) {
  const unsigned threads = 256;
  const unsigned blocks = unsigned((n + threads - 1) / threads);
  becker_bisect_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(xi), static_cast<T*>(u), n, T(a), T(b), T(c2),
      T(v0), T(v1), T(lo), T(hi), iters);
  return int(cudaGetLastError());
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  xi [n] wave coordinates, u [n] the
// velocities; a, b, c2, v0, v1 the profile's constants and [lo, hi] the
// bracket, each rounded to the dtype here.  Returns cudaGetLastError()
// after the launch, -2 for an unknown dtype.
extern "C" int esdg_becker_bisect(int dtype, const void* xi, void* u,
                                  long long n, double a, double b, double c2,
                                  double v0, double v1, double lo, double hi,
                                  int iters, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::launch_becker_bisect<float>(xi, u, n, a, b, c2, v0, v1, lo,
                                             hi, iters, st);
  if (dtype == 1)
    return esdg::launch_becker_bisect<double>(xi, u, n, a, b, c2, v0, v1, lo,
                                              hi, iters, st);
  return -2;
}
