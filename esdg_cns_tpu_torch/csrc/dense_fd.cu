// K5: dense skew EC flux differencing of any element type.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_fd.py::_fd_kernel
// (wrapper flux_differencing_pallas; bodies triangular_fd, full_fd and
// triangular_fd8, three layouts of one sum), the volume term of the plain
// RHS with flux_diff_impl='pallas'.  Per element it takes the flux
// variables qh [Nf, Nh, K] = (rho, u_1..DIM, beta) and qlog [2, Nh, K] =
// (log rho, log beta) at the Nh hybridized points, the skew operators
// qs [DIM, Nh, Nh] and the metric geo [DIM^2, 1 | Nh, K], and writes
//   out_i = 2 sum_j sum_x (sum_r Q_r[i,j] g_rx) F_x(q_i, q_j)  [Nf, Nh, K]
// with the body K3 shares (dense_fd.cuh): the face-face block skipped,
// g pairwise-averaged on curved elements.
//
// What bounds it on this card: the pair loop.  On the 2D cavity (tri N=3,
// Nh=24, Nq=12, K=32768) each element needs 210 pairs (the triangular
// count; this kernel evaluates each from both sides) with three divisions
// and two logarithmic means each, against about 1 KB of HBM traffic per
// element in f32; on a hex N=3 (Nh=160, Nq=64) 8,160 pairs per element.
// Counting a division or logarithm as one operation, the cavity's bytes
// and operations give floors within 10% of each other; those cost far more
// than an FMA, so the pair loop bounds it, as it binds K3.
//
// Simple design: a block owns TE elements (threadIdx.x, so the K-last
// loads and stores coalesce) and 256 / TE workers (threadIdx.y); the
// element's point values (and, when curved, its [DIM^2, Nh] metric) sit in
// shared memory, one thread sums one row.  The operators sit in shared
// memory when a tile of at least 8 elements fits beside them (tri N=3:
// 1,152 values), and are read through the read-only path from global
// memory otherwise (hex N=3: 76,800 values; L1/L2-resident).  Lanes past K
// compute on a quiescent state (rho=1, u=0, beta=1, logs 0) with the
// identity metric and store nothing.
#include "dense_fd.cuh"

namespace esdg {

constexpr int kDenseThreads = 256;

template <typename T, int DIM, bool CURVED, bool OPS_GLOBAL>
__global__ void __launch_bounds__(kDenseThreads)
    dense_fd_kernel(const T* __restrict__ qh, const T* __restrict__ qlog,
                    const T* __restrict__ qs, const T* __restrict__ geo,
                    T* __restrict__ out, long long K, int nq, int nh,
                    double gamma) {
  constexpr int NF = DIM + 2, NV = DIM + 4, G = DIM * DIM;
  const Consts<T> c(gamma);
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_qs = reinterpret_cast<T*>(smem_raw);        // [DIM][Nh][Nh], shared
  T* s_h = s_qs + (OPS_GLOBAL ? 0 : DIM * nh * nh);  // [NV Nh][TE]
  T* s_g = s_h + NV * nh * TE;                     // [G Nh][TE], curved

  if (!OPS_GLOBAL) {
    for (int i = tid; i < DIM * nh * nh; i += nthreads) s_qs[i] = qs[i];
  }
  for (int i = w; i < nh; i += NW) {
    T v[NV];
#pragma unroll
    for (int r = 0; r < NV; ++r) v[r] = (r == 0 || r == NF - 1) ? T(1) : T(0);
    if (live) {
#pragma unroll
      for (int r = 0; r < NF; ++r) v[r] = qh[(long long)(r * nh + i) * K + k];
      v[NF] = qlog[(long long)i * K + k];
      v[NF + 1] = qlog[(long long)(nh + i) * K + k];
    }
#pragma unroll
    for (int r = 0; r < NV; ++r) s_h[(r * nh + i) * TE + e] = v[r];
    if (CURVED) {
#pragma unroll
      for (int rx = 0; rx < G; ++rx) {
        const T ident = (rx % (DIM + 1) == 0) ? T(1) : T(0);
        s_g[(rx * nh + i) * TE + e] =
            live ? geo[(long long)(rx * nh + i) * K + k] : ident;
      }
    }
  }
  T ga[G];  // the affine metric
#pragma unroll
  for (int rx = 0; rx < G; ++rx) {
    ga[rx] = (rx % (DIM + 1) == 0) ? T(1) : T(0);
    if (!CURVED && live) ga[rx] = geo[(long long)rx * K + k];
  }
  __syncthreads();

  if (!live) return;  // no barrier below
  const T* ops = OPS_GLOBAL ? qs : s_qs;
  for (int i = w; i < nh; i += NW) {
    T acc[NF];
    dense_fd_row<T, DIM, CURVED, OPS_GLOBAL>(i, s_h + e, s_g + e, ga, ops, nq,
                                             nh, TE, c, acc);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[(long long)(f * nh + i) * K + k] = T(2) * acc[f];
  }
}

template <typename T, int DIM, bool CURVED>
int launch_dense_fd(const void* qh, const void* qlog, const void* qs,
                    const void* geo, void* out, long long K, int nq, int nh,
                    double gamma, cudaStream_t stream) {
  constexpr int NV = DIM + 4, G = DIM * DIM;
  const size_t per = size_t(NV + (CURVED ? G : 0)) * nh;
  const size_t ops = size_t(DIM) * nh * nh;
  // the operators in shared memory when a tile of 8 elements still fits
  const int te_shared = tile_elements<T>(ops, per);
  const bool ops_global = te_shared < 8;
  const int te = ops_global ? tile_elements<T>(0, per) : te_shared;
  if (te == 0) return -1;
  const size_t smem = ((ops_global ? 0 : ops) + per * te) * sizeof(T);
  auto kern = ops_global ? dense_fd_kernel<T, DIM, CURVED, true>
                         : dense_fd_kernel<T, DIM, CURVED, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 block(te, kDenseThreads / te);
  const dim3 grid(unsigned((K + te - 1) / te));
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(qh), static_cast<const T*>(qlog),
      static_cast<const T*>(qs), static_cast<const T*>(geo),
      static_cast<T*>(out), K, nq, nh, gamma);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dense_fd(int dim, int curved, const void* qh, const void* qlog,
                      const void* qs, const void* geo, void* out, long long K,
                      int nq, int nh, double gamma, cudaStream_t stream) {
#define ESDG_DENSE_CASE(D)                                                  \
  case D:                                                                   \
    return curved ? launch_dense_fd<T, D, true>(qh, qlog, qs, geo, out, K,  \
                                                nq, nh, gamma, stream)      \
                  : launch_dense_fd<T, D, false>(qh, qlog, qs, geo, out, K, \
                                                 nq, nh, gamma, stream);
  switch (dim) {
    ESDG_DENSE_CASE(1)
    ESDG_DENSE_CASE(2)
    ESDG_DENSE_CASE(3)
    default:
      return -3;
  }
#undef ESDG_DENSE_CASE
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  qh [dim + 2, nh, K], qlog [2, nh, K],
// qs [dim, nh, nh], geo [dim^2, 1, K] or (curved = 1) [dim^2, nh, K];
// out [dim + 2, nh, K] = 2 QF.  Returns cudaGetLastError() after the
// launch, -1 when one element's tile does not fit in shared memory, -2 for
// an unknown dtype, -3 for a dim outside 1..3.
extern "C" int esdg_dense_fd(int dtype, int dim, int curved, const void* qh,
                             const void* qlog, const void* qs,
                             const void* geo, void* out, long long K, int nq,
                             int nh, double gamma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::dispatch_dense_fd<float>(dim, curved, qh, qlog, qs, geo, out,
                                          K, nq, nh, gamma, st);
  if (dtype == 1)
    return esdg::dispatch_dense_fd<double>(dim, curved, qh, qlog, qs, geo,
                                           out, K, nq, nh, gamma, st);
  return -2;
}
