// K7: the viscous mid-section of the affine CNS RHS alone, in 1D (lines),
// 2D (tris) and 3D (hexes), with the projected front (proj) or, on
// collocated hexes, the gradient rows alone; the stress traces
// normal-contracted (contract) or per component.  The entry point is
// cns_viscous.cu (with DIM 2 instantiated there); DIM 1 and 3 are
// instantiated in cns_viscous_dim1.cu and _dim3.cu.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_viscous.py::
// _viscous_kernel (wrapper cns_viscous_pallas, body _viscous_body).  It
// runs after the separate surface stage (K8, cns_surface.cu), which hands
// it the BC-adjusted entropy jump dv.  Per element: the quadrature stage
// visc_quad_node (front product, gradients, sigma = K(v) grad(v), the
// production share), the stress traces at the face nodes (contracted,
// t_f = sum_x (Ef sigma_x) nxj_x [Nf, Nfq, K], or the components
// Ef sigma_x at rows x Nf + f of [DIM Nf, Nfq, K]), the divergence at the
// Np nodes and the per-element production summed over the quadrature
// nodes in a fixed order (cns_stages.cuh, the same device code as K4's
// viscous half).
//
// What bounds it on an H100: the same products as K4's viscous half.
// 2D tri N=3 and 1D: full operators in shared memory, dense loops
// (HBM-bound on the tri, launch latency at K=128 on the line).  3D hex
// N=3: the operator lists of K4 (cns_stages.cuh ViscListLayout, all but
// LIFT's), in shared memory beside the tile (read from global memory
// past 32 KB, N >= 5), each row summed over its 4 or 6 entries in the
// dense loop's column order; the tile is list_tile's.  On an NVIDIA H100
// 80GB HBM3 at 700.00 W, f32 hex N=3 K=4096: 0.0512 ms against the
// dense loops' 0.2988, 21 warps an SM (80 registers, three blocks of 7
// elements).  It reads the jump dv instead of rebuilding it.
//
// Simple design, as K4: a block owns TE elements (threadIdx.x) and NW
// workers an element (threadIdx.y); no atomics; lanes past K compute on
// a quiescent state and store nothing.
#pragma once

#include "cns_stages.cuh"

namespace esdg {

template <typename T, int DIM, bool PROJ, bool OPS_SMEM>
__global__ void __launch_bounds__(kViscThreads)
    cns_viscous_kernel(const T* __restrict__ vu, const T* __restrict__ dv,
                       const T* __restrict__ geo, const T* __restrict__ nxj,
                       const T* __restrict__ invj, const T* __restrict__ wjq,
                       const T* __restrict__ front,
                       const T* __restrict__ vqlift, const T* __restrict__ ef,
                       const T* __restrict__ drpq,
                       const T* __restrict__ lval,
                       const unsigned short* __restrict__ lcol,
                       ViscListLayout lay, T* __restrict__ tf_out,
                       T* __restrict__ div_out, T* __restrict__ prod_out,
                       T* __restrict__ vuq_out, long long K,
                       ViscSizes sz, ViscParams<T> vp, int contract) {
  constexpr int NF = DIM + 2;
  const int np = sz.np, nq = sz.nq, nfq = sz.nfq;
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;
  const TileRows<T> S{TE, e};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  ViscOps<T> op{front, vqlift, ef, drpq, nullptr, lval, lcol, lay};
  // the lists this launch reads: all but LIFT (the last)
  const int n_slots = lay.off[kLLift];
  if constexpr (OPS_SMEM && kViscLists<DIM>) {
    for (int i = tid; i < n_slots; i += nthreads) s[i] = lval[i];
    op.lval = s;
    s += n_slots;
  } else if constexpr (OPS_SMEM) {
    const int n_front = (int(PROJ) + DIM) * nq * nq;
    T* s_front = s;
    T* s_vqlift = s_front + n_front;
    T* s_ef = s_vqlift + nq * nfq;
    T* s_drpq = s_ef + nfq * nq;
    for (int i = tid; i < n_front; i += nthreads) s_front[i] = front[i];
    for (int i = tid; i < nq * nfq; i += nthreads) s_vqlift[i] = vqlift[i];
    for (int i = tid; i < nfq * nq; i += nthreads) s_ef[i] = ef[i];
    for (int i = tid; i < DIM * np * nq; i += nthreads) s_drpq[i] = drpq[i];
    op.front = s_front;
    op.vqlift = s_vqlift;
    op.ef = s_ef;
    op.drpq = s_drpq;
    s = s_drpq + DIM * np * nq;
  }
  T* s_vu = s;                        // [NF Nq][TE]
  T* s_dv = s_vu + NF * nq * TE;      // [NF Nfq][TE]
  T* s_nxj = s_dv + NF * nfq * TE;    // [DIM Nfq][TE]
  T* s_sig = s_nxj + DIM * nfq * TE;  // [DIM][NF][Nq][TE]
  T* s_prod = s_sig + DIM * NF * nq * TE;  // [Nq][TE]
  if constexpr (OPS_SMEM && kViscLists<DIM>) {
    // the columns after the tile (16-bit, past every T array)
    unsigned short* s_col =
        reinterpret_cast<unsigned short*>(s_prod + nq * TE);
    for (int i = tid; i < n_slots; i += nthreads) s_col[i] = lcol[i];
    op.lcol = s_col;
  }

  for (int row = w; row < NF * nq; row += NW) {
    // quiescent entropy state past K keeps 1/ve^3 finite
    const T quiescent = row / nq == NF - 1 ? T(-1) : T(0);
    S(s_vu, row) = live ? vu[(long long)row * K + k] : quiescent;
  }
  for (int row = w; row < NF * nfq; row += NW)
    S(s_dv, row) = live ? dv[(long long)row * K + k] : T(0);
  for (int row = w; row < DIM * nfq; row += NW)
    S(s_nxj, row) = live ? nxj[(long long)row * K + k] : T(0);
  T g[DIM * DIM];  // geo[r * DIM + x], affine
  T ij = T(0);
#pragma unroll
  for (int r = 0; r < DIM * DIM; ++r) g[r] = T(0);
  if (live) {
#pragma unroll
    for (int r = 0; r < DIM * DIM; ++r) g[r] = geo[(long long)r * K + k];
    ij = invj[k];
  }
  __syncthreads();

  for (int i = w; i < nq; i += NW) {
    const T wq = live ? wjq[(long long)i * K + k] : T(0);
    visc_quad_node<T, DIM, PROJ, OPS_SMEM>(i, nq, nfq, S, s_vu, s_dv, s_nxj,
                                           s_sig, s_prod, op, g, ij, wq, vp,
                                           vuq_out, K, k, live);
  }
  __syncthreads();
  if (!live) return;  // no barrier below

  for (int fp = w; fp < nfq; fp += NW)
    visc_traces_node<T, DIM, OPS_SMEM>(fp, nq, nfq, S, s_sig, s_nxj, op,
                                       contract != 0, tf_out, K, k);
  for (int nn = w; nn < np; nn += NW) {
    T dvg[NF];
    visc_div_node<T, DIM, OPS_SMEM>(nn, np, nq, S, s_sig, op, g, dvg);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      div_out[(long long)(f * np + nn) * K + k] = dvg[f];
  }
  if (w == 0) {
    T sum = T(0);
    for (int i = 0; i < nq; ++i) sum += S(s_prod, i);
    prod_out[k] = sum;
  }
}

template <typename T, int DIM, bool PROJ, bool OPS_SMEM>
int launch_viscous(const void* const* in, void* const* out, const void* lval,
                   const void* lcol, const ViscListLayout& lay, long long K,
                   ViscSizes sz, const ViscTile& tile,
                   const ViscParams<T>& vp, int contract,
                   cudaStream_t stream, int* occ) {
  auto kern = cns_viscous_kernel<T, DIM, PROJ, OPS_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(tile.bytes));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr) {
    const int rc =
        launch_shape(kern, tile.te * tile.nw, tile.bytes, tile.te, occ);
    occ[6] = !tile.smem_ops;  // the operators read from global memory
    return rc;
  }
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  const dim3 block(tile.te, tile.nw);
  const dim3 grid(unsigned((K + tile.te - 1) / tile.te));
  kern<<<grid, block, tile.bytes, stream>>>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), I(7), I(8), I(9),
      static_cast<const T*>(lval), static_cast<const unsigned short*>(lcol),
      lay, O(0), O(1), O(2), O(3), K, sz, vp, contract);
  return int(cudaGetLastError());
}

#define ESDG_VISCOUS_ARGS                                                   \
  int proj, int contract, const void *const *in, void *const *out,         \
      const void *lval, const void *lcol, const int *widths, long long K,   \
      esdg::ViscSizes sz, double gamma, double mu, double lam, double pr,   \
      cudaStream_t stream, int *occ

// One dimension's forms, as K4's (surface_viscous_dim): proj = 1 at any
// DIM, proj = 0 at DIM 3; DIM 1, 2 the dense operators, in shared memory
// where they fit beside the tile; DIM 3 the lists on list_tile's tile.
// With occ the launch shape instead of a launch.  -1 when the tile does
// not fit, -3 for a form not built.
template <typename T, int DIM>
int viscous_dim(ESDG_VISCOUS_ARGS) {
  constexpr size_t NF = DIM + 2;
  if (!proj && DIM != 3) return -3;
  const size_t nq = sz.nq, nfq = sz.nfq, np = sz.np;
  // per element: vu [NF][Nq]; dv [NF][Nfq]; nxj [DIM][Nfq];
  // sigma [DIM][NF][Nq]; prod [Nq]
  const size_t per_elem = NF * nq + NF * nfq + DIM * nfq + DIM * NF * nq + nq;
  const ViscParams<T> vp = make_visc_params<T>(gamma, mu, lam, pr, 1.0);
  ViscListLayout lay{};
#define ESDG_V_LAUNCH(P, S)                                                 \
  return launch_viscous<T, DIM, P, S>(in, out, lval, lcol, lay, K, sz,      \
                                      tile, vp, contract, stream, occ)
  if constexpr (kViscLists<DIM>) {
    lay = visc_list_layout(widths, DIM, sz);
    // every list but LIFT (the last)
    const size_t list_bytes =
        size_t(lay.off[kLLift]) * (sizeof(T) + sizeof(unsigned short));
#define ESDG_V_LISTS(P)                                                     \
  {                                                                         \
    ViscTile tile;                                                          \
    const int rc = list_tile<T>(                                            \
        cns_viscous_kernel<T, DIM, P, true>,                                \
        cns_viscous_kernel<T, DIM, P, false>, sz, list_bytes,               \
        per_elem * sizeof(T), &tile);                                       \
    if (rc != 0) return rc;                                                 \
    if (tile.smem_ops) ESDG_V_LAUNCH(P, true);                              \
    ESDG_V_LAUNCH(P, false);                                                \
  }
    if (proj) ESDG_V_LISTS(true)
    ESDG_V_LISTS(false)
#undef ESDG_V_LISTS
  } else {
    // operators: front [(proj + DIM) Nq][Nq], vqlift [Nq][Nfq], ef
    // [Nfq][Nq], drpq [DIM][Np][Nq]
    const size_t ops = (size_t(proj) + DIM) * nq * nq + nq * nfq +
                       nfq * nq + DIM * np * nq;
    const ViscTile tile = visc_tile<T>(ops, per_elem);
    if (tile.te == 0) return -1;
    if (tile.smem_ops) ESDG_V_LAUNCH(true, true);
    ESDG_V_LAUNCH(true, false);
  }
#undef ESDG_V_LAUNCH
}

}  // namespace esdg
