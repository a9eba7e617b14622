// K3: fused modal volume stage of the affine CNS / Euler RHS on lines,
// tris and hexes (DIM = 1, 2, 3; curved metrics on tris).  The entry point
// is tri_modal_volume.cu (DIM 2 instantiated there); DIM 1 and 3 are
// modal_volume_dim1.cu and _dim3.cu, so the three build in parallel.
//
// Replaces the TPU kernel
// esdg_cns_tpu/ops/pallas_modal_volume.py::_modal_volume_kernel (wrapper
// euler_modal_volume_pallas; flux-differencing body
// esdg_cns_tpu/ops/pallas_fd.py::triangular_fd through fd_body).  Per
// element, with NF = DIM + 2 fields, it computes:
//   1. Uq = Vq U at the Nq quadrature points and v(Uq), written out as
//      vu_q [NF, Nq, K] (the viscous front end reads it);
//   2. the hybridized projection Vh Pq v and U(v_h) at the Nh = Nq + Nfq
//      points, then the flux variables (rho, u_1..DIM, beta) and their
//      logs, staged in shared memory; the face rows are written out as
//      traces [NF + 2, Nfq, K] = (rho, u_1..DIM, beta, log rho, log beta);
//   3. the dense skew EC flux differencing (dense_fd.cuh, the body K5
//      shares)
//      acc_i = sum_j sum_x (sum_r Q_r[i,j] g_rx) F_x(q_i, q_j),
//      skipping the zero face-face block and the zero diagonal, g the
//      element's affine metric (geo [DIM^2, 1, K]) or, on curved tris
//      (CURVED, geo [4, Nh, K]), the pairwise average 0.5 (g_i + g_j);
//   4. ph_qf = 2 Ph acc  [NF, Np, K].
//
// What bounds it on this card: the pair loop, with three divisions and two
// logarithmic means per pair.  Tri N=3 (Np=10, Nq=12, Nh=24): 420 pair
// evaluations per element here (every ordered vol-vol pair and both orders
// of the vol-face pairs), 24 pow/exp inverse maps and about 3.3k
// multiply-adds of small dense products, against 44 values read and 160
// written (0.8 KB in f32); hex N=3 (Np=Nq=64, Nh=160): 16,320 pair
// evaluations per element (8,160 pairs); line N=4 (Np=Nq=5, Nh=7): 30, and
// at K=128 a launch is launch latency.  HBM is far from the limit at every
// shape.
//
// Simple design: a block owns TE elements (threadIdx.x, so the K-last
// loads and stores coalesce) and 256/TE workers (threadIdx.y).  The
// operators Vq, VhP, Ph and Q_r sit in shared memory when a tile of at
// least 8 elements still fits beside them (lines, tris: OPS_GLOBAL false),
// and are read through the read-only path from global memory otherwise
// (hexes at N=3: the three Q_r alone hold 76,800 values, 307 KB in f32;
// L1/L2-resident), as K5 does; the per-element arrays (and, when curved,
// the element's [4, Nh] metric) always sit in shared memory.  In the flux
// differencing one thread owns one (element, row i) and sums its whole
// row over the partners j.  That evaluates each pair twice, once from each
// side, but needs no cross-thread reduction and no atomics, so the result
// is deterministic.  Halving the pair work (the TPU's triangular form: row
// j takes the negated column sum) is later work.  Lanes past K compute on
// a quiescent state (rho=1, m=0, E=1) with the identity metric and store
// nothing.  Sizes (Np, Nq, Nh) are runtime values, so every N whose tile
// fits in shared memory runs.
#pragma once

#include "dense_fd.cuh"

namespace esdg {

constexpr int kModalThreads = 256;

// operators: vq [Nq][Np], vhp [Nh][Nq], ph [Np][Nh], qs [DIM][Nh][Nh]
inline size_t modal_ops(int dim, int np, int nq, int nh) {
  return size_t(nq) * np + size_t(nh) * nq + size_t(np) * nh +
         size_t(dim) * nh * nh;
}
// per element: q [NF][Np], v [NF][Nq], h [NF + 2][Nh], acc [NF][Nh] and,
// curved, g [DIM^2][Nh]
inline size_t modal_per_elem(int dim, int np, int nq, int nh, bool curved) {
  const size_t nf = dim + 2;
  return nf * np + nf * nq + (nf + 2) * nh + nf * nh +
         (curved ? size_t(dim) * dim * nh : 0);
}

template <typename T, int DIM, bool CURVED, bool OPS_GLOBAL>
__global__ void __launch_bounds__(kModalThreads)
    modal_volume_kernel(const T* __restrict__ q, const T* __restrict__ geo,
                        const T* __restrict__ qs, const T* __restrict__ vq,
                        const T* __restrict__ vhp, const T* __restrict__ ph,
                        T* __restrict__ out, T* __restrict__ traces,
                        T* __restrict__ vuq, long long K, int np, int nq,
                        int nh, double gamma) {
  constexpr int NF = DIM + 2, NV = DIM + 4, G = DIM * DIM;
  const Consts<T> c(gamma);
  const int nfq = nh - nq;
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const T *o_vq = vq, *o_vhp = vhp, *o_ph = ph, *o_qs = qs;
  if (!OPS_GLOBAL) {
    T* s_vq = s;
    T* s_vhp = s_vq + nq * np;
    T* s_ph = s_vhp + nh * nq;
    T* s_qs = s_ph + np * nh;
    for (int i = tid; i < nq * np; i += nthreads) s_vq[i] = vq[i];
    for (int i = tid; i < nh * nq; i += nthreads) s_vhp[i] = vhp[i];
    for (int i = tid; i < np * nh; i += nthreads) s_ph[i] = ph[i];
    for (int i = tid; i < DIM * nh * nh; i += nthreads) s_qs[i] = qs[i];
    o_vq = s_vq;
    o_vhp = s_vhp;
    o_ph = s_ph;
    o_qs = s_qs;
    s = s_qs + DIM * nh * nh;
  }
  T* s_q = s;                     // [NF Np][TE]
  T* s_v = s_q + NF * np * TE;    // [NF Nq][TE]
  T* s_h = s_v + NF * nq * TE;    // [NV Nh][TE]
  T* s_acc = s_h + NV * nh * TE;  // [NF Nh][TE]
  T* s_g = s_acc + NF * nh * TE;  // [G Nh][TE], curved only

  for (int row = w; row < NF * np; row += NW) {
    const int f = row / np;
    const T quiescent = (f == 0 || f == NF - 1) ? T(1) : T(0);
    s_q[row * TE + e] = live ? q[(long long)row * K + k] : quiescent;
  }
  if (CURVED) {
    for (int row = w; row < G * nh; row += NW) {
      const int rx = row / nh;
      const T ident = rx % (DIM + 1) == 0 ? T(1) : T(0);
      s_g[row * TE + e] = live ? geo[(long long)row * K + k] : ident;
    }
  }
  __syncthreads();

  // ---- 1. Uq = Vq U and v(Uq) ----
  for (int i = w; i < nq; i += NW) {
    T u[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) u[f] = T(0);
    for (int j = 0; j < np; ++j) {
      const T a = load_op<OPS_GLOBAL>(o_vq + i * np + j);
#pragma unroll
      for (int f = 0; f < NF; ++f) u[f] += a * s_q[(f * np + j) * TE + e];
    }
    const T rho = u[0], E = u[NF - 1];
    T msum = u[1] * u[1];
#pragma unroll
    for (int d = 1; d < DIM; ++d) msum = msum + u[1 + d] * u[1 + d];
    const T p = c.gm1 * (E - (T(0.5) * msum) / rho);
    const T s = log(p) - c.gamma * log(rho);
    T v[NF];
    v[0] = (c.gamma_p1 - s) - (c.gm1 * E) / p;
#pragma unroll
    for (int d = 0; d < DIM; ++d) v[1 + d] = (c.gm1 * u[1 + d]) / p;
    v[NF - 1] = (-c.gm1 * rho) / p;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      s_v[(f * nq + i) * TE + e] = v[f];
      if (live) vuq[(long long)(f * nq + i) * K + k] = v[f];
    }
  }
  __syncthreads();

  // ---- 2. v_h = VhP v, U(v_h), flux variables + logs at Nh points ----
  for (int i = w; i < nh; i += NW) {
    T hv[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) hv[f] = T(0);
    for (int j = 0; j < nq; ++j) {
      const T a = load_op<OPS_GLOBAL>(o_vhp + i * nq + j);
#pragma unroll
      for (int f = 0; f < NF; ++f) hv[f] += a * s_v[(f * nq + j) * TE + e];
    }
    const T hve = hv[NF - 1];
    T vnorm = hv[1] * hv[1];
#pragma unroll
    for (int d = 1; d < DIM; ++d) vnorm = vnorm + hv[1 + d] * hv[1 + d];
    const T sf = (c.gamma - hv[0]) + vnorm / (T(2) * hve);
    const T rhoe =
        pow(c.gm1 / pow(-hve, c.gamma), c.inv_gm1) * exp(-sf / c.gm1);
    const T hrho = rhoe * (-hve);
    const T he = rhoe * (T(1) - vnorm / (T(2) * hve));
    T vals[NV];
    vals[0] = hrho;
    T usum = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vals[1 + d] = hv[1 + d] / (-hve);
      usum = d == 0 ? vals[1] * vals[1] : usum + vals[1 + d] * vals[1 + d];
    }
    const T hp = c.gm1 * (he - (T(0.5) * hrho) * usum);
    const T hbeta = hrho / (T(2) * hp);
    vals[NF - 1] = hbeta;
    vals[NF] = log(hrho);
    vals[NF + 1] = log(hbeta);
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      s_h[(r * nh + i) * TE + e] = vals[r];
      if (live && i >= nq)
        traces[(long long)(r * nfq + i - nq) * K + k] = vals[r];
    }
  }
  __syncthreads();

  // ---- 3. dense skew EC flux differencing, one row per thread ----
  T ga[G];  // geo[r * DIM + x], affine
#pragma unroll
  for (int rx = 0; rx < G; ++rx) ga[rx] = rx % (DIM + 1) == 0 ? T(1) : T(0);
  if (!CURVED && live) {
#pragma unroll
    for (int rx = 0; rx < G; ++rx) ga[rx] = geo[(long long)rx * K + k];
  }
  for (int i = w; i < nh; i += NW) {
    T acc[NF];
    dense_fd_row<T, DIM, CURVED, OPS_GLOBAL>(i, s_h + e, s_g + e, ga, o_qs,
                                             nq, nh, TE, c, acc);
#pragma unroll
    for (int f = 0; f < NF; ++f) s_acc[(f * nh + i) * TE + e] = acc[f];
  }
  __syncthreads();

  // ---- 4. ph_qf = 2 Ph acc ----
  if (!live) return;  // no barrier below
  for (int n = w; n < np; n += NW) {
    T o[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) o[f] = T(0);
    for (int i = 0; i < nh; ++i) {
      const T a = load_op<OPS_GLOBAL>(o_ph + n * nh + i);
#pragma unroll
      for (int f = 0; f < NF; ++f) o[f] += a * s_acc[(f * nh + i) * TE + e];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[(long long)(f * np + n) * K + k] = T(2) * o[f];
  }
}

template <typename T, int DIM, bool CURVED>
int launch_modal_volume(const void* q, const void* geo, const void* qs,
                        const void* vq, const void* vhp, const void* ph,
                        void* out, void* traces, void* vuq, long long K,
                        int np, int nq, int nh, double gamma,
                        cudaStream_t stream) {
  const size_t ops = modal_ops(DIM, np, nq, nh);
  const size_t per = modal_per_elem(DIM, np, nq, nh, CURVED);
  // the operators in shared memory when a tile of 8 elements still fits
  const int te_shared = tile_elements<T>(ops, per);
  const bool ops_global = te_shared < 8;
  const int te = ops_global ? tile_elements<T>(0, per) : te_shared;
  if (te == 0) return -1;
  const size_t smem = ((ops_global ? 0 : ops) + per * te) * sizeof(T);
  auto kern = ops_global ? modal_volume_kernel<T, DIM, CURVED, true>
                         : modal_volume_kernel<T, DIM, CURVED, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 block(te, kModalThreads / te);
  const dim3 grid(unsigned((K + te - 1) / te));
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(geo),
      static_cast<const T*>(qs), static_cast<const T*>(vq),
      static_cast<const T*>(vhp), static_cast<const T*>(ph),
      static_cast<T*>(out), static_cast<T*>(traces), static_cast<T*>(vuq), K,
      np, nq, nh, gamma);
  return int(cudaGetLastError());
}

#define ESDG_MODAL_ARGS                                                     \
  int curved, const void *q, const void *geo, const void *qs,              \
      const void *vq, const void *vhp, const void *ph, void *out,           \
      void *traces, void *vuq, long long K, int np, int nq, int nh,         \
      double gamma, cudaStream_t stream

// One dimension's forms: affine at any DIM, curved at DIM 2 (the only
// curved modal mesh); -3 for a curved metric elsewhere.
template <typename T, int DIM>
int modal_volume_dim(ESDG_MODAL_ARGS) {
  if (curved) {
    if constexpr (DIM == 2)
      return launch_modal_volume<T, DIM, true>(q, geo, qs, vq, vhp, ph, out,
                                               traces, vuq, K, np, nq, nh,
                                               gamma, stream);
    return -3;
  }
  return launch_modal_volume<T, DIM, false>(q, geo, qs, vq, vhp, ph, out,
                                            traces, vuq, K, np, nq, nh, gamma,
                                            stream);
}

}  // namespace esdg
