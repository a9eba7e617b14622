// The dense skew EC flux differencing of one element, shared by K3
// (tri_modal_volume.cu) and K5 (dense_fd.cu).  It replaces the one body
// both TPU kernels share, esdg_cns_tpu/ops/pallas_fd.py::triangular_fd
// (through fd_body; its 'tri8' and 'full' forms are layouts of the same
// sum):
//   acc_i = sum_j sum_x b_x(i, j) F_x(q_i, q_j),
//   b_x(i, j) = sum_r Q_r[i, j] g_rx,
// the operator contracted with the metric first (pallas_fd.py:72-86), g
// the element's affine metric or, on curved elements, the pairwise average
// 0.5 (g_i + g_j).  The zero face-face block is skipped exactly: a face
// row i >= Nq runs over the volume partners j < Nq only; the zero diagonal
// is skipped too.
//
// One thread owns one row i of one element and sums it over its partners,
// so each pair is evaluated from both sides: no cross-thread reduction, no
// atomics, a deterministic result.  dense_fd_row (K5) runs over every
// partner; list_fd_row (K3) over a list of the partners whose operator
// entry is above roundoff, which on the Gauss-collocated hex is the
// points of the row's node lines: 1,344 ordered pairs an element at N=3
// against dense_fd_row's 16,320.  The metric-contracted flux is formed
// from the contracted velocity (common.cuh's ec_contract).  Point values
// sit in shared memory in the tile layout [row][TE]; the operators (Q_r
// [DIM][Nh][Nh], or the list) sit in shared memory where they fit
// (OPS_GLOBAL false) and are read through the read-only path from global
// memory otherwise (L1/L2-resident).
#pragma once

#include "common.cuh"

namespace esdg {

template <bool GLOBAL, typename T>
__device__ __forceinline__ T load_op(const T* p) {
  if constexpr (GLOBAL) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Row i of one element.  h: the element's point values, value (r, j) at
// h[(r * nh + j) * te], r over (rho, u_1..DIM, beta, log rho, log beta);
// gc: the curved metric, value (rx, j) at gc[(rx * nh + j) * te] (CURVED);
// ga: the affine metric [DIM * DIM] (not CURVED); qs [DIM][nh][nh].
// acc receives (f_rho, f_m1..DIM, f_E), not doubled.
template <typename T, int DIM, bool CURVED, bool OPS_GLOBAL>
__device__ __forceinline__ void dense_fd_row(int i, const T* h, const T* gc,
                                             const T* ga, const T* qs,
                                             int nq, int nh, int te,
                                             const Consts<T>& c,
                                             T acc[DIM + 2]) {
  constexpr int NF = DIM + 2, NV = DIM + 4, G = DIM * DIM;
  T L[NV];
#pragma unroll
  for (int r = 0; r < NV; ++r) L[r] = h[(r * nh + i) * te];
  T gi[G];
#pragma unroll
  for (int rx = 0; rx < G; ++rx)
    gi[rx] = CURVED ? gc[(rx * nh + i) * te] : ga[rx];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
  const int jend = i < nq ? nh : nq;  // the face-face block is zero
  for (int j = 0; j < jend; ++j) {
    if (j == i) continue;
    T R[NV];
#pragma unroll
    for (int r = 0; r < NV; ++r) R[r] = h[(r * nh + j) * te];
    T a[DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r)
      a[r] = load_op<OPS_GLOBAL>(qs + ((long long)r * nh + i) * nh + j);
    T b[DIM];
#pragma unroll
    for (int x = 0; x < DIM; ++x) {
      T t = T(0);
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        const T g = CURVED ? T(0.5) * (gi[r * DIM + x] +
                                       gc[((r * DIM + x) * nh + j) * te])
                           : gi[r * DIM + x];
        t += a[r] * g;
      }
      b[x] = t;
    }
    const EcPairN<T, DIM> p = ec_pair_n<T, DIM>(L, R, c);
    T fc[NF];
    ec_contract<T, DIM>(p, b, fc);
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] += fc[f];
  }
}

// Row i of one element over its partner list (K3): the partners j of row
// i in ascending order, cols[n] for n in rp[i]..rp[i+1]-1, with their
// operator entries qv[n DIM + r] = Q_r[i, j]; the list holds the pairs
// whose entry is above roundoff in some direction (ops/modal_volume.
// modal_lists), so the sum is dense_fd_row's over the pairs the operator
// needs.  h, gc, ga, acc as in dense_fd_row.
template <typename T, int DIM, bool CURVED, bool OPS_GLOBAL>
__device__ __forceinline__ void list_fd_row(int i, const T* h, const T* gc,
                                            const T* ga, const int* rp,
                                            const int* cols, const T* qv,
                                            int nh, int te,
                                            const Consts<T>& c,
                                            T acc[DIM + 2]) {
  constexpr int NF = DIM + 2, NV = DIM + 4, G = DIM * DIM;
  T L[NV];
#pragma unroll
  for (int r = 0; r < NV; ++r) L[r] = h[(r * nh + i) * te];
  T gi[G];
#pragma unroll
  for (int rx = 0; rx < G; ++rx)
    gi[rx] = CURVED ? gc[(rx * nh + i) * te] : ga[rx];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
  const int n1 = load_op<OPS_GLOBAL>(rp + i + 1);
  for (int n = load_op<OPS_GLOBAL>(rp + i); n < n1; ++n) {
    const int j = load_op<OPS_GLOBAL>(cols + n);
    T R[NV];
#pragma unroll
    for (int r = 0; r < NV; ++r) R[r] = h[(r * nh + j) * te];
    T a[DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r) a[r] = load_op<OPS_GLOBAL>(qv + n * DIM + r);
    T b[DIM];
#pragma unroll
    for (int x = 0; x < DIM; ++x) {
      T t = T(0);
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        const T g = CURVED ? T(0.5) * (gi[r * DIM + x] +
                                       gc[((r * DIM + x) * nh + j) * te])
                           : gi[r * DIM + x];
        t += a[r] * g;
      }
      b[x] = t;
    }
    const EcPairN<T, DIM> p = ec_pair_n<T, DIM>(L, R, c);
    T fc[NF];
    ec_contract<T, DIM>(p, b, fc);
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] += fc[f];
  }
}

}  // namespace esdg
