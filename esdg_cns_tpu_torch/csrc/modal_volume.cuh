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
//   3. the skew EC flux differencing over each row's partner list
//      (dense_fd.cuh's list_fd_row; K5 runs the dense row of that file)
//      acc_i = sum_j sum_x (sum_r Q_r[i,j] g_rx) F_x(q_i, q_j),
//      over the partners j with an entry above roundoff (never the zero
//      face-face block or the zero diagonal), g the
//      element's affine metric (geo [DIM^2, 1, K]) or, on curved tris
//      (CURVED, geo [4, Nh, K]), the pairwise average 0.5 (g_i + g_j);
//   4. ph_qf = 2 Ph acc  [NF, Np, K].
//
// Design.  The operators arrive as lists of the entries they need
// (ModalLists below; built once on the host, ops/modal_volume.modal_lists):
// each row's partners j with their Q_r[i, j], and the entries of Vq,
// Vh Pq and Ph above roundoff.  On lines and tris that is every entry
// (the work is the dense form's); on the Gauss-collocated hex, where Q_r
// couples only the points of one node line, a volume row has 3 N + 6
// partners and a face row N + 1: at N=3, 1,344 ordered pairs an element
// where the dense sum took 16,320, and Vq, Vh Pq, Ph are the identity and
// one node line per face point (64, 448 and 448 entries of 4,096, 10,240
// and 10,240).  The lists sit in shared memory (21.5 KB for Q at hex N=3
// in f32) beside a tile of TE elements, 256 threads a block: threadIdx.x
// runs over the elements (the K-last loads and stores coalesce),
// threadIdx.y over 256/TE workers.  Of the tiles that fit, the kernel
// takes the one with the most warps resident on an SM, then the most
// elements (modal_shape, from the occupancy query; cached per shape).
// In the flux differencing one thread owns one (element, row i) and sums
// it over its partners, so each pair is evaluated from both sides: no
// cross-thread reduction, no atomics, a deterministic result; the rows go
// to the workers in snake order, so the heavy volume rows and the light
// face rows spread over them.  Lanes past K compute on a quiescent state
// (rho=1, m=0, E=1) with the identity metric and store nothing.  Sizes
// (Np, Nq, Nh) are runtime values, so every N whose tile fits in shared
// memory runs.
//
// What bounds it on this card: the pairs, each with five IEEE divisions
// and two logarithmic means (common.cuh), once from each side; HBM is far
// from the limit at every shape.  On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py; PERF.md §6): hex N=3, K=4096, 0.0806 ms against 0.0247
// ms priced at the probes' operation costs (the priced count takes each
// pair once, the kernel twice), 32 warps resident an SM in f32 (2
// elements a block); tri N=3, K=32768, 0.1032 against 0.0472.  The state
// changes the time: a fluid at rest gives equal states across a pair, and
// the IEEE f32 divider leaves its fast path on a zero dividend (the
// logarithmic means' da^2 / aavg^2; row 12's chain runs 3.17x longer on
// zero dividends): 0.0980 ms on the 3D cavity at rest.
#pragma once

#include "dense_fd.cuh"

namespace esdg {

constexpr int kModalThreads = 256;

// The operator lists (ops/modal_volume.modal_lists), one int and one value
// array: idx = the row pointers of Q (nh + 1), Vq (nq + 1), Vh Pq (nh + 1)
// and Ph (np + 1), then each list's columns in that order; vals = Q's
// entries (DIM a partner), then Vq's, Vh Pq's and Ph's.
template <typename T, bool GLOBAL>
struct ModalLists {
  const int *rp_q, *rp_vq, *rp_vhp, *rp_ph, *c_q, *c_vq, *c_vhp, *c_ph;
  const T *v_q, *v_vq, *v_vhp, *v_ph;
  __device__ ModalLists(const int* idx, const T* vals, int dim, int np,
                        int nq, int nh) {
    rp_q = idx;
    rp_vq = rp_q + nh + 1;
    rp_vhp = rp_vq + nq + 1;
    rp_ph = rp_vhp + nh + 1;
    c_q = rp_ph + np + 1;
    const int nnz_q = load_op<GLOBAL>(rp_q + nh);
    const int nnz_vq = load_op<GLOBAL>(rp_vq + nq);
    const int nnz_vhp = load_op<GLOBAL>(rp_vhp + nh);
    c_vq = c_q + nnz_q;
    c_vhp = c_vq + nnz_vq;
    c_ph = c_vhp + nnz_vhp;
    v_q = vals;
    v_vq = v_q + nnz_q * dim;
    v_vhp = v_vq + nnz_vq;
    v_ph = v_vhp + nnz_vhp;
  }
};

// s[f] += sum over row i of a list of val * x(f, col)
template <bool GLOBAL, int NF, typename T, typename X>
__device__ __forceinline__ void list_row(const int* rp, const int* cols,
                                         const T* vals, int i, X x, T s[NF]) {
  const int n1 = load_op<GLOBAL>(rp + i + 1);
  for (int n = load_op<GLOBAL>(rp + i); n < n1; ++n) {
    const int j = load_op<GLOBAL>(cols + n);
    const T a = load_op<GLOBAL>(vals + n);
#pragma unroll
    for (int f = 0; f < NF; ++f) s[f] += a * x(f, j);
  }
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
                        const int* __restrict__ idx,
                        const T* __restrict__ vals, T* __restrict__ out,
                        T* __restrict__ traces, T* __restrict__ vuq,
                        long long K, int np, int nq, int nh, int n_idx,
                        int n_vals, double gamma) {
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
  const int* o_idx = idx;
  const T* o_vals = vals;
  if (!OPS_GLOBAL) {
    T* s_vals = s;
    for (int n = tid; n < n_vals; n += nthreads) s_vals[n] = vals[n];
    o_vals = s_vals;
    s = s_vals + n_vals;
  }
  T* s_q = s;                     // [NF Np][TE]
  T* s_v = s_q + NF * np * TE;    // [NF Nq][TE]
  T* s_h = s_v + NF * nq * TE;    // [NV Nh][TE]
  T* s_acc = s_h + NV * nh * TE;  // [NF Nh][TE]
  T* s_g = s_acc + NF * nh * TE;  // [G Nh][TE], curved only
  if (!OPS_GLOBAL) {
    int* s_idx = reinterpret_cast<int*>(s_g + (CURVED ? G * nh * TE : 0));
    for (int n = tid; n < n_idx; n += nthreads) s_idx[n] = idx[n];
    o_idx = s_idx;
  }

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
  const ModalLists<T, OPS_GLOBAL> ops(o_idx, o_vals, DIM, np, nq, nh);

  // ---- 1. Uq = Vq U and v(Uq) ----
  for (int i = w; i < nq; i += NW) {
    T u[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) u[f] = T(0);
    list_row<OPS_GLOBAL, NF>(ops.rp_vq, ops.c_vq, ops.v_vq, i,
                             [&](int f, int j) {
                               return s_q[(f * np + j) * TE + e];
                             },
                             u);
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
    list_row<OPS_GLOBAL, NF>(ops.rp_vhp, ops.c_vhp, ops.v_vhp, i,
                             [&](int f, int j) {
                               return s_v[(f * nq + j) * TE + e];
                             },
                             hv);
    const T hve = hv[NF - 1];
    T vnorm = hv[1] * hv[1];
#pragma unroll
    for (int d = 1; d < DIM; ++d) vnorm = vnorm + hv[1 + d] * hv[1 + d];
    const T sf = (c.gamma - hv[0]) + vnorm / (T(2) * hve);
    const T rhoe =
        pow(c.gm1 / pow(-hve, c.gamma), c.inv_gm1) * exp(-sf / c.gm1);
    const T hrho = rhoe * (-hve);
    const T he = rhoe * (T(1) - vnorm / (T(2) * hve));
    T vals_h[NV];
    vals_h[0] = hrho;
    T usum = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vals_h[1 + d] = hv[1 + d] / (-hve);
      usum = d == 0 ? vals_h[1] * vals_h[1]
                    : usum + vals_h[1 + d] * vals_h[1 + d];
    }
    const T hp = c.gm1 * (he - (T(0.5) * hrho) * usum);
    const T hbeta = hrho / (T(2) * hp);
    vals_h[NF - 1] = hbeta;
    vals_h[NF] = log(hrho);
    vals_h[NF + 1] = log(hbeta);
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      s_h[(r * nh + i) * TE + e] = vals_h[r];
      if (live && i >= nq)
        traces[(long long)(r * nfq + i - nq) * K + k] = vals_h[r];
    }
  }
  __syncthreads();

  // ---- 3. skew EC flux differencing over each row's partner list ----
  T ga[G];  // geo[r * DIM + x], affine
#pragma unroll
  for (int rx = 0; rx < G; ++rx) ga[rx] = rx % (DIM + 1) == 0 ? T(1) : T(0);
  if (!CURVED && live) {
#pragma unroll
    for (int rx = 0; rx < G; ++rx) ga[rx] = geo[(long long)rx * K + k];
  }
  // rows in snake order: pass p takes rows p NW .. p NW + NW - 1, in
  // reverse on odd passes, so the heavy volume rows (more partners, first)
  // and the light face rows spread over the workers
  for (int p = 0; p * NW < nh; ++p) {
    const int i = p * NW + (p % 2 == 0 ? w : NW - 1 - w);
    if (i >= nh) continue;
    T acc[NF];
    list_fd_row<T, DIM, CURVED, OPS_GLOBAL>(i, s_h + e, s_g + e, ga,
                                            ops.rp_q, ops.c_q, ops.v_q, nh,
                                            TE, c, acc);
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
    list_row<OPS_GLOBAL, NF>(ops.rp_ph, ops.c_ph, ops.v_ph, n,
                             [&](int f, int i) {
                               return s_acc[(f * nh + i) * TE + e];
                             },
                             o);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[(long long)(f * np + n) * K + k] = T(2) * o[f];
  }
}

// The tile: TE elements of 256 threads.  The operator lists go in shared
// memory when a tile of 8 elements still fits beside them (else they are
// read from global memory, L1/L2-resident); of the tiles that fit, the one
// with the most warps resident on an SM (cudaOccupancy..., which counts
// the kernel's registers), then the most elements.  Cached per shape: the
// host-bound paths launch K3 once per RHS.
struct ModalShape {
  int te;
  bool ops_global;
  size_t smem;
};

template <typename T, int DIM, bool CURVED>
int modal_shape(int np, int nq, int nh, int n_idx, int n_vals,
                ModalShape* out) {
  struct Entry {
    int key[5];
    ModalShape shape;
  };
  static Entry cache[16];
  static int n_cache = 0;
  const int key[5] = {np, nq, nh, n_idx, n_vals};
  for (int i = 0; i < n_cache; ++i) {
    bool same = true;
    for (int j = 0; j < 5; ++j) same = same && cache[i].key[j] == key[j];
    if (same) {
      *out = cache[i].shape;
      return 0;
    }
  }
  const size_t per = modal_per_elem(DIM, np, nq, nh, CURVED) * sizeof(T);
  const size_t ops = size_t(n_vals) * sizeof(T) + size_t(n_idx) * sizeof(int);
  const bool ops_global = ops + 8 * per > kMaxSmem;
  const size_t fixed = ops_global ? 0 : ops;
  auto kern = ops_global ? modal_volume_kernel<T, DIM, CURVED, true>
                         : modal_volume_kernel<T, DIM, CURVED, false>;
  ModalShape best{0, ops_global, 0};
  int best_warps = 0, best_elems = 0;
  for (int te = 32; te >= 1; te /= 2) {
    const size_t smem = fixed + per * te;
    if (smem > kMaxSmem) continue;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        kModalThreads, smem);
    if (err != cudaSuccess) return int(err);
    const int warps = blocks * kModalThreads / 32, elems = blocks * te;
    if (warps > best_warps || (warps == best_warps && elems > best_elems)) {
      best = ModalShape{te, ops_global, smem};
      best_warps = warps;
      best_elems = elems;
    }
  }
  if (best.te == 0) return -1;
  if (n_cache < 16) cache[n_cache++] = Entry{{np, nq, nh, n_idx, n_vals}, best};
  *out = best;
  return 0;
}

template <typename T, int DIM, bool CURVED>
int launch_modal_volume(const void* q, const void* geo, const void* idx,
                        const void* vals, void* out, void* traces, void* vuq,
                        long long K, int np, int nq, int nh, int n_idx,
                        int n_vals, double gamma, cudaStream_t stream,
                        int* occ) {
  ModalShape sh;
  int rc = modal_shape<T, DIM, CURVED>(np, nq, nh, n_idx, n_vals, &sh);
  if (rc != 0) return rc;
  auto kern = sh.ops_global ? modal_volume_kernel<T, DIM, CURVED, true>
                            : modal_volume_kernel<T, DIM, CURVED, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(sh.smem));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr) {
    rc = launch_shape(kern, kModalThreads, sh.smem, sh.te, occ);
    occ[6] = sh.ops_global;  // the lists read from global memory
    return rc;
  }
  const dim3 block(sh.te, kModalThreads / sh.te);
  const dim3 grid(unsigned((K + sh.te - 1) / sh.te));
  kern<<<grid, block, sh.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(geo),
      static_cast<const int*>(idx), static_cast<const T*>(vals),
      static_cast<T*>(out), static_cast<T*>(traces), static_cast<T*>(vuq), K,
      np, nq, nh, n_idx, n_vals, gamma);
  return int(cudaGetLastError());
}

#define ESDG_MODAL_ARGS                                                     \
  int curved, const void *q, const void *geo, const void *idx,             \
      const void *vals, void *out, void *traces, void *vuq, long long K,    \
      int np, int nq, int nh, int n_idx, int n_vals, double gamma,          \
      cudaStream_t stream, int *occ

// One dimension's forms: affine at any DIM, curved at DIM 2 (the only
// curved modal mesh); -3 for a curved metric elsewhere.
template <typename T, int DIM>
int modal_volume_dim(ESDG_MODAL_ARGS) {
  if (curved) {
    if constexpr (DIM == 2)
      return launch_modal_volume<T, DIM, true>(q, geo, idx, vals, out,
                                               traces, vuq, K, np, nq, nh,
                                               n_idx, n_vals, gamma, stream,
                                               occ);
    return -3;
  }
  return launch_modal_volume<T, DIM, false>(q, geo, idx, vals, out, traces,
                                            vuq, K, np, nq, nh, n_idx, n_vals,
                                            gamma, stream, occ);
}

}  // namespace esdg
