// LSRK45's two updates of a stage in one pass over the state:
//
//   res <- A res + dt dq,   q_new <- q + B res
//
// This replaces no TPU kernel: the TPU package writes the update as plain
// jnp, which XLA fuses into one loop.  In the port the same two lines were
// five PyTorch kernels, each writing a temporary: twelve passes over the
// state a stage where the update needs five (q, res and dq read; res
// written in place and q_new), four at the first stage, which never reads
// res (A = 0 there and res holds whatever its buffer held).
//
// What bounds it: bytes.  Two additions and three multiplies a value
// against 20 bytes of f32 I/O (40 f64).  So each thread moves one 16-byte
// vector of each array (float4, double2), which keeps 48 bytes a thread
// and some 96 KB an SM in flight at full residency, well above the ~20 KB
// that HBM's latency asks for; a scalar tail takes numel not a multiple of
// the vector.  A state one of whose pointers is not 16-byte aligned (a
// view at an odd offset) takes the same kernel one value a thread.  Loads
// and stores take the default cache policy: streaming hints (__ldcs on q,
// dq and res, __stcs on res) measured 3% slower alone and no faster inside
// the Euler step on the H100.
//
// It repeats the plain form's arithmetic: each product and sum rounded
// once to T in the plain order (the __*_rn intrinsics forbid contraction
// into FMAs) with A, B and dt rounded to T as PyTorch rounds a Python
// float against a tensor of T.  At the first stage 0 + dt dq stands for
// A res + dt dq with the zero res the plain form used to start from (it
// turns -0 into +0 as that sum did).  So both agree bitwise.
#include <cuda_runtime.h>

namespace esdg {

__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}
__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}

// the 16-byte vector of T and the values it holds; with VEC false, one
// value (the form for unaligned pointers)
template <typename T, bool VEC>
struct Vec {
  using type = T;
  static constexpr int width = 1;
};
template <>
struct Vec<float, true> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct Vec<double, true> {
  using type = double2;
  static constexpr int width = 2;
};

constexpr unsigned kUpdateThreads = 256;

template <typename T, bool FIRST>
__device__ __forceinline__ void update_one(T q, T& res, T dq, T& q_new, T a,
                                           T b, T dt) {
  const T r = FIRST ? add_rn(T(0), mul_rn(dt, dq))
                    : add_rn(mul_rn(a, res), mul_rn(dt, dq));
  res = r;
  q_new = add_rn(q, mul_rn(b, r));
}

// One vector of each array a thread (n / width of them), then the tail's
// n % width values, one a thread of the first block.  With VEC every
// pointer is 16-byte aligned (the launcher's test).
template <typename T, bool FIRST, bool VEC>
__global__ void __launch_bounds__(kUpdateThreads)
    lsrk45_update_kernel(const T* __restrict__ q, T* __restrict__ res,
                         const T* __restrict__ dq, T* __restrict__ q_new,
                         long long n, T a, T b, T dt) {
  using V = typename Vec<T, VEC>::type;
  constexpr int W = Vec<T, VEC>::width;
  const long long nv = n / W;
  const long long i = (long long)blockIdx.x * kUpdateThreads + threadIdx.x;
  if (i < nv) {
    const V qv = reinterpret_cast<const V*>(q)[i];
    const V dv = reinterpret_cast<const V*>(dq)[i];
    V rv;
    if (!FIRST) rv = reinterpret_cast<const V*>(res)[i];
    V ov;
    const T* qs = reinterpret_cast<const T*>(&qv);
    const T* ds = reinterpret_cast<const T*>(&dv);
    T* rs = reinterpret_cast<T*>(&rv);
    T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int c = 0; c < W; ++c)
      update_one<T, FIRST>(qs[c], rs[c], ds[c], os[c], a, b, dt);
    reinterpret_cast<V*>(res)[i] = rv;
    reinterpret_cast<V*>(q_new)[i] = ov;
  }
  const long long t = nv * W + i;
  if (t < n) {
    T r = FIRST ? T(0) : res[t];
    T o;
    update_one<T, FIRST>(q[t], r, dq[t], o, a, b, dt);
    res[t] = r;
    q_new[t] = o;
  }
}

template <typename T, bool VEC>
int launch_update_form(int first, const T* q, T* res, const T* dq, T* q_new,
                       long long n, T a, T b, T dt, cudaStream_t stream) {
  const long long nv = n / Vec<T, VEC>::width;
  const unsigned blocks =
      unsigned(nv > 0 ? (nv + kUpdateThreads - 1) / kUpdateThreads : 1);
  if (first)
    lsrk45_update_kernel<T, true, VEC><<<blocks, kUpdateThreads, 0, stream>>>(
        q, res, dq, q_new, n, a, b, dt);
  else
    lsrk45_update_kernel<T, false, VEC><<<blocks, kUpdateThreads, 0, stream>>>(
        q, res, dq, q_new, n, a, b, dt);
  return int(cudaGetLastError());
}

template <typename T>
int launch_lsrk45_update(int first, const void* q, void* res, const void* dq,
                         void* q_new, long long n, double a, double b,
                         double dt, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* dp = static_cast<const T*>(dq);
  T* rp = static_cast<T*>(res);
  T* op = static_cast<T*>(q_new);
  const bool aligned = ((reinterpret_cast<unsigned long long>(q) |
                         reinterpret_cast<unsigned long long>(res) |
                         reinterpret_cast<unsigned long long>(dq) |
                         reinterpret_cast<unsigned long long>(q_new)) &
                        15ull) == 0;
  if (aligned)
    return launch_update_form<T, true>(first, qp, rp, dp, op, n, T(a), T(b),
                                       T(dt), stream);
  return launch_update_form<T, false>(first, qp, rp, dp, op, n, T(a), T(b),
                                      T(dt), stream);
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  first: 1 at a step's first stage (res
// is written, not read).  q, res, dq, q_new: n values each, contiguous
// (16-byte aligned ones take the vector form); res is updated in place.
// a, b, dt are rounded to the dtype here.  Returns cudaGetLastError()
// after the launch, -2 for an unknown dtype.
extern "C" int esdg_lsrk45_update(int dtype, int first, const void* q,
                                  void* res, const void* dq, void* q_new,
                                  long long n, double a, double b, double dt,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::launch_lsrk45_update<float>(first, q, res, dq, q_new, n, a,
                                             b, dt, st);
  if (dtype == 1)
    return esdg::launch_lsrk45_update<double>(first, q, res, dq, q_new, n, a,
                                              b, dt, st);
  return -2;
}
