// K4: merged post-exchange surface stage + viscous mid-section of the
// affine CNS RHS, in 1D (lines), 2D (tris) and 3D (hexes), with the
// projected front (proj, the modal volume front K3's) or, on collocated
// hexes, the gradient rows alone.  The entry point is
// cns_surface_viscous.cu (with DIM 2 instantiated there); DIM 1 and 3 are
// instantiated in cns_surface_viscous_dim1.cu and _dim3.cu, so the three
// build in parallel.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_viscous.py::
// _surface_viscous_kernel (wrapper cns_surface_viscous_pallas, body
// _viscous_body; BC transport ops/pallas_cns_surface.py).  Per element:
//   1. face stage, per (element, face node): both sides' conservative and
//      entropy traces rebuilt from the flux-variable payload, then
//      surface_node (cns_stages.cuh): BC ghosts, EC flux + LF, entropy BC,
//      BR1 jump dv, penalty rows;
//   2. quadrature stage, per (element, quadrature node): visc_quad_node
//      (front product, gradients, sigma, production share);
//   3. the contracted traction t_f = sum_x (Ef sigma_x) nxj_x;
//   4. at the Np nodes the divergence, and with fold_tail the assembly
//      dq = -(ph_qf + LIFT flux)/J + div/J + LIFT pen (the penalty is
//      added after the 1/J scaling, as the reference does); the
//      per-element production, summed over the quadrature nodes in a
//      fixed order.
// The BC reaches the kernel as the pool [L, Nfq, K] (normals, masks, wall
// rows, per-call Dirichlet states) and the flat region table of
// ops/cns_surface_bc.region_table.
//
// What bounds it on an H100.  2D, tri N=3 (Np=10, Nq=Nfq=12): about 20k
// operations per element against 2 KB in f32 (66 MB per RHS at K=32768):
// HBM-bound, so the dense operators are served from shared memory and add
// no HBM traffic.  1D, line N=4 (Np=Nq=5, Nfq=2): a few thousand
// operations per element on tiny operators, which sit in shared memory;
// at K=128 a launch is launch latency.  On both the operators are full,
// and the stages run dense loops over them.  3D, hex N=3 (Np=Nq=64,
// Nfq=96): the dense operators hold 43k values (47k with the projection
// block), of which the Gauss-collocated hex needs 2,688 (2,752): a point
// couples only to its node lines, so a row of D_r Pq, Ef or the gradient
// rows holds N+1 = 4 entries and a row of Vq LIFT or LIFT 6.  There the
// kernel reads the operators as padded lists of those entries
// (cns_stages.cuh ViscListLayout; ops/surface_viscous.visc_lists, built
// once with the RHS), each row summed in the dense loop's column order
// with the zeros dropped: about 0.1M operations an element where the
// dense loops took 0.8M (chip_smoke.py's ops_k4).  The lists sit in
// shared memory beside the tile (16,512 bytes in f32 at N=3) up to 32
// KB, else they are read from global memory (L1/L2-resident: N >= 5);
// the tile (elements a block, workers an element) is list_tile's, the
// most busy workers resident.  On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py, PERF.md §6), f32 hex N=3 K=4096: 0.0880 ms against
// the dense loops' 0.3726, 16 warps an SM (111 registers, two blocks of
// 8 elements), 4.2x its byte bound: the sum of its face stage (K8's
// time) and its viscous half (K7's), held by the face stage's registers
// and the tile's residency.
//
// Simple design: a block owns TE elements (threadIdx.x, K-last loads and
// stores) and NW workers an element (threadIdx.y; 256/TE on the dense
// tile) that take the nodes of each stage in turn; __syncthreads()
// separates the stages.  No atomics: every sum has one owner and a fixed
// order, so the result is deterministic.
// Lanes past K compute on a quiescent state and store nothing.
#pragma once

#include "cns_stages.cuh"

namespace esdg {

template <typename T, int DIM, bool PROJ, bool OPS_SMEM>
__global__ void __launch_bounds__(kViscThreads)
    cns_surface_viscous_kernel(
        const T* __restrict__ vu, const T* __restrict__ qmv,
        const T* __restrict__ qml, const T* __restrict__ nbr,
        const T* __restrict__ nxj, const T* __restrict__ sj,
        const T* __restrict__ isj, const T* __restrict__ pool,
        const T* __restrict__ geo, const T* __restrict__ invj,
        const T* __restrict__ wjq, const T* __restrict__ front,
        const T* __restrict__ vqlift, const T* __restrict__ ef,
        const T* __restrict__ drpq, const T* __restrict__ phqf,
        const T* __restrict__ lift, const T* __restrict__ lval,
        const unsigned short* __restrict__ lcol, ViscListLayout lay,
        const int* __restrict__ itab, const double* __restrict__ ftab,
        T* __restrict__ flux_out,
        T* __restrict__ pen_out, T* __restrict__ tf_out,
        T* __restrict__ div_out, T* __restrict__ prod_out,
        T* __restrict__ vuq_out, long long K, ViscSizes sz, double gamma,
        ViscParams<T> vp, int dissipation, int with_penalty, int fold_tail,
        int has_bc) {
  constexpr int NF = DIM + 2;
  const Consts<T> c(gamma);
  const int np = sz.np, nq = sz.nq, nfq = sz.nfq;
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;
  const TileRows<T> S{TE, e};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  ViscOps<T> op{front, vqlift, ef, drpq, lift, lval, lcol, lay};
  // the lists this launch reads: LIFT (the last) only with fold_tail
  const int n_slots = fold_tail ? lay.slots : lay.off[kLLift];
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
    T* s_lift = s_drpq + DIM * np * nq;
    for (int i = tid; i < n_front; i += nthreads) s_front[i] = front[i];
    for (int i = tid; i < nq * nfq; i += nthreads) s_vqlift[i] = vqlift[i];
    for (int i = tid; i < nfq * nq; i += nthreads) s_ef[i] = ef[i];
    for (int i = tid; i < DIM * np * nq; i += nthreads) s_drpq[i] = drpq[i];
    if (fold_tail)
      for (int i = tid; i < np * nfq; i += nthreads) s_lift[i] = lift[i];
    op.front = s_front;
    op.vqlift = s_vqlift;
    op.ef = s_ef;
    op.drpq = s_drpq;
    op.lift = s_lift;
    s = s_lift + np * nfq;
  }
  // the flux and penalty rows stay for the LIFTs of fold_tail (the list
  // tile holds them only then)
  const bool tail_rows = !kViscLists<DIM> || fold_tail;
  T* s_vu = s;                        // [NF Nq][TE]
  T* s_flux = s_vu + NF * nq * TE;    // [NF Nfq][TE]
  T* s_pen = s_flux + (tail_rows ? NF * nfq * TE : 0);
  T* s_dv = s_pen + (tail_rows ? NF * nfq * TE : 0);
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
  T g[DIM * DIM];  // geo[r * DIM + x], affine
  T ij = T(0);
#pragma unroll
  for (int r = 0; r < DIM * DIM; ++r) g[r] = T(0);
  if (live) {
#pragma unroll
    for (int r = 0; r < DIM * DIM; ++r) g[r] = geo[(long long)r * K + k];
    ij = invj[k];
  }

  // ---- 1. face stage ----
  const long long rs = (long long)nfq * K;  // row stride
  for (int fp = w; fp < nfq; fp += NW) {
    const long long o = (long long)fp * K + k;
    T qm[NF], qp[NF], lm[2] = {T(0), T(0)}, lp[2] = {T(0), T(0)}, n[DIM];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      qm[f] = qp[f] = (f == 0 || f == NF - 1) ? T(1) : T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = T(0);
    T sjv = T(1), isjv = T(1);
    if (live) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        qm[f] = qmv[f * rs + o];
        qp[f] = nbr[f * rs + o];
      }
      lm[0] = qml[o];
      lm[1] = qml[rs + o];
      lp[0] = nbr[NF * rs + o];
      lp[1] = nbr[(NF + 1) * rs + o];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = nxj[d * rs + o];
      sjv = sj[o];
      isjv = isj[o];
    }
    T uf[NF], vuf[NF];
    flux_to_cons<T, DIM>(qm, c.gm1, uf);
    evars_from_flux<T, DIM>(qm, lm[0], lm[1], c, vuf);
    T flux[NF], dv[NF], pen[NF];
    surface_node<T, DIM>(qm, lm, qp, lp, uf, vuf, n, sjv, isjv, pool, o, rs,
                         live, itab, ftab, has_bc, dissipation, with_penalty,
                         vp.re, c, flux, dv, pen);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (tail_rows) {
        S(s_flux, f * nfq + fp) = flux[f];
        S(s_pen, f * nfq + fp) = pen[f];
      }
      S(s_dv, f * nfq + fp) = dv[f];
      if (live && !fold_tail) {
        flux_out[f * rs + o] = flux[f];
        if (with_penalty) pen_out[f * rs + o] = pen[f];
      }
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) S(s_nxj, d * nfq + fp) = n[d];
  }
  __syncthreads();

  // ---- 2. quadrature stage: front product, gradients, sigma ----
  for (int i = w; i < nq; i += NW) {
    const T wq = live ? wjq[(long long)i * K + k] : T(0);
    visc_quad_node<T, DIM, PROJ, OPS_SMEM>(i, nq, nfq, S, s_vu, s_dv, s_nxj,
                                           s_sig, s_prod, op, g, ij, wq, vp,
                                           vuq_out, K, k, live);
  }
  __syncthreads();
  if (!live) return;  // no barrier below

  // ---- 3. contracted traction ----
  for (int fp = w; fp < nfq; fp += NW)
    visc_traces_node<T, DIM, OPS_SMEM>(fp, nq, nfq, S, s_sig, s_nxj, op,
                                       true, tf_out, K, k);

  // ---- 4. divergence, and with fold_tail the assembly ----
  for (int nn = w; nn < np; nn += NW) {
    T dvg[NF];
    visc_div_node<T, DIM, OPS_SMEM>(nn, np, nq, S, s_sig, op, g, dvg);
    if (!fold_tail) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        div_out[(long long)(f * np + nn) * K + k] = dvg[f];
      continue;
    }
    T lf[NF], lpn[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) lf[f] = lpn[f] = T(0);
    auto add = [&](T a, int fp) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        lf[f] += a * S(s_flux, f * nfq + fp);
        lpn[f] += a * S(s_pen, f * nfq + fp);
      }
    };
    if constexpr (kViscLists<DIM>)
      visc_row<OPS_SMEM>(op, kLLift, nn, add);
    else
      for (int fp = 0; fp < nfq; ++fp)
        add(ldop<OPS_SMEM>(op.lift + nn * nfq + fp), fp);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long long o = (long long)(f * np + nn) * K + k;
      T acc = -(phqf[o] + lf[f]) * ij + dvg[f] * ij;
      if (with_penalty) acc = acc + lpn[f];
      div_out[o] = acc;
    }
  }
  if (w == 0) {
    T sum = T(0);
    for (int i = 0; i < nq; ++i) sum += S(s_prod, i);
    prod_out[k] = sum;
  }
}

template <typename T, int DIM, bool PROJ, bool OPS_SMEM>
int launch_surface_viscous(const void* const* in, void* const* out,
                           const void* lval, const void* lcol,
                           const ViscListLayout& lay, const int* itab,
                           const double* ftab, long long K, ViscSizes sz,
                           double gamma, const ViscTile& tile,
                           const ViscParams<T>& vp, int dissipation,
                           int with_penalty, int fold_tail, int has_bc,
                           cudaStream_t stream, int* occ) {
  auto kern = cns_surface_viscous_kernel<T, DIM, PROJ, OPS_SMEM>;
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
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), I(7), I(8), I(9), I(10),
      I(11), I(12), I(13), I(14), I(15), I(16),
      static_cast<const T*>(lval), static_cast<const unsigned short*>(lcol),
      lay, itab, ftab, O(0), O(1), O(2), O(3), O(4), O(5), K, sz, gamma, vp,
      dissipation, with_penalty, fold_tail, has_bc);
  return int(cudaGetLastError());
}

#define ESDG_SURFACE_VISCOUS_ARGS                                           \
  int proj, const void *const *in, void *const *out, const void *lval,     \
      const void *lcol, const int *widths, const int *itab,                 \
      const double *ftab, long long K, esdg::ViscSizes sz, double gamma,    \
      double mu, double lam, double pr, double re, int dissipation,         \
      int with_penalty, int fold_tail, int has_bc, cudaStream_t stream,     \
      int *occ

// One dimension's forms: the projected front (proj = 1) at any DIM, the
// gradient rows alone (proj = 0, the collocated hex) at DIM 3.  DIM 1, 2:
// the dense operators, in shared memory where they fit beside the tile
// (visc_tile), else in global memory.  DIM 3: the lists (widths: the
// slots a row of each, ViscListLayout), on list_tile's tile.  With occ
// the launch shape (common.cuh launch_shape) instead of a launch.  -1
// when the tile does not fit, -3 for a form not built.
template <typename T, int DIM>
int surface_viscous_dim(ESDG_SURFACE_VISCOUS_ARGS) {
  constexpr size_t NF = DIM + 2;
  if (!proj && DIM != 3) return -3;
  const size_t nq = sz.nq, nfq = sz.nfq, np = sz.np;
  const ViscParams<T> vp = make_visc_params<T>(gamma, mu, lam, pr, re);
  ViscListLayout lay{};
#define ESDG_SV_LAUNCH(P, S)                                                \
  return launch_surface_viscous<T, DIM, P, S>(                              \
      in, out, lval, lcol, lay, itab, ftab, K, sz, gamma, tile, vp,         \
      dissipation, with_penalty, fold_tail, has_bc, stream, occ)
  if constexpr (kViscLists<DIM>) {
    lay = visc_list_layout(widths, DIM, sz);
    // the slots read (LIFT, the last list, only with fold_tail) and the
    // tile an element: vu [NF][Nq]; with fold_tail flux, pen [NF][Nfq];
    // dv [NF][Nfq]; nxj [DIM][Nfq]; sigma [DIM][NF][Nq]; prod [Nq]
    const size_t slots = fold_tail ? lay.slots : lay.off[kLLift];
    const size_t list_bytes = slots * (sizeof(T) + sizeof(unsigned short));
    const size_t per_elem = (NF * nq + (fold_tail ? 3 : 1) * NF * nfq +
                             DIM * nfq + DIM * NF * nq + nq) * sizeof(T);
#define ESDG_SV_LISTS(P)                                                    \
  {                                                                         \
    ViscTile tile;                                                          \
    const int rc = list_tile<T>(                                            \
        cns_surface_viscous_kernel<T, DIM, P, true>,                        \
        cns_surface_viscous_kernel<T, DIM, P, false>, sz, list_bytes,       \
        per_elem, &tile);                                                   \
    if (rc != 0) return rc;                                                 \
    if (tile.smem_ops) ESDG_SV_LAUNCH(P, true);                             \
    ESDG_SV_LAUNCH(P, false);                                               \
  }
    if (proj) ESDG_SV_LISTS(true)
    ESDG_SV_LISTS(false)
#undef ESDG_SV_LISTS
  } else {
    // operators: front [(proj + DIM) Nq][Nq], vqlift [Nq][Nfq], ef
    // [Nfq][Nq], drpq [DIM][Np][Nq], lift [Np][Nfq]
    const size_t ops = (size_t(proj) + DIM) * nq * nq + nq * nfq +
                       nfq * nq + DIM * np * nq + np * nfq;
    // per element: vu [NF][Nq]; flux, pen, dv [NF][Nfq]; nxj [DIM][Nfq];
    // sigma [DIM][NF][Nq]; prod [Nq]
    const size_t per_elem = NF * nq + 3 * NF * nfq + DIM * nfq +
                            DIM * NF * nq + nq;
    const ViscTile tile = visc_tile<T>(ops, per_elem);
    if (tile.te == 0) return -1;
    if (tile.smem_ops) ESDG_SV_LAUNCH(true, true);
    ESDG_SV_LAUNCH(true, false);
  }
#undef ESDG_SV_LAUNCH
}

}  // namespace esdg
