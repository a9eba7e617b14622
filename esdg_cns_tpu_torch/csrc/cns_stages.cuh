// Device stages shared by the affine CNS kernels K4 (cns_surface_viscous.cuh),
// K7 (cns_viscous.cuh) and K8 (cns_surface.cu), templated on the dimension
// DIM (1: lines, 2: tris, 3: hexes).  The viscous stage also takes PROJ
// (the front operator carries a leading Vq Pq projection block: the modal
// front of lines, tris and hexes; without it the collocated-hex front,
// where Vq = Pq = I) and OPS_SMEM (the operators sit in shared memory).
// At DIM 1 and 2 the operators are dense, every entry needed, and the
// launchers choose OPS_SMEM by their size (visc_tile); at DIM 3 they are
// padded lists of the entries above roundoff (ViscListLayout, visc_row),
// in shared memory beside the tile up to kListSmemBytes (list_tile).
//
// They mirror the TPU package, where the merged kernel's body is the
// surface kernel's body followed by _viscous_body
// (esdg_cns_tpu/ops/pallas_cns_surface.py::_surface_kernel,
// esdg_cns_tpu/ops/pallas_viscous.py::_viscous_body):
//   * the face stage, one face node of one element (surface_node): the
//     neighbour's conservative and entropy traces rebuilt from the
//     exchanged flux variables (no transcendentals), the wall-BC ghosts
//     walked over the region table in region order, the EC face flux +
//     LF, the entropy BC, the BR1 jump dv and the interface penalty;
//   * the viscous stage over a tile of elements in shared memory
//     (visc_quad_node, visc_ef_sigma_node, visc_div_node): the front
//     product, gradients, sigma = K(v) grad(v) (viscous_flux_nd's formulas
//     and loop order), the node's share of the entropy production, the
//     stress traces Ef sigma_x (contracted with the normal, t_f = sum_x
//     (Ef sigma_x) nxj_x, or per component) and the divergence
//     sum_r (D_r Pq)(sum_x geo[r,x] sigma_x).
// Entropy variables of both face sides come from the same
// transcendental-free formula (solvers/_shared.entropy_vars_from_flux), so
// the jump is bitwise antisymmetric across conforming faces.  Built without
// fast math; gamma- and mu-derived constants are formed in double and
// rounded once.
#pragma once

#include "common.cuh"

namespace esdg {

constexpr int kViscThreads = 256;
// per-block shared memory of a tile whose operators stay in global memory
// (read through the read-only path, L1/L2-resident): two blocks per SM
constexpr size_t kTileBytesGlobalOps = 98304;
enum WallKind { kAdiabatic = 0, kIsothermal = 1, kSlip = 2, kDirichlet = 3 };

// the element's sizes: Np solution nodes, Nq quadrature nodes, Nfq face nodes
struct ViscSizes {
  int np, nq, nfq;
};

template <typename T>
struct ViscParams {
  T mu, lam, l2m, lpm, gmu, pr, re;
};

template <typename T>
inline ViscParams<T> make_visc_params(double gamma, double mu, double lam,
                                      double pr, double re) {
  ViscParams<T> vp;
  vp.mu = T(mu);
  vp.lam = T(lam);
  vp.l2m = T(2.0 * mu + lam);
  vp.lpm = T(lam + mu);
  vp.gmu = T(gamma * mu);
  vp.pr = T(pr);
  vp.re = T(re);
  return vp;
}

// The viscous operators of a hex (DIM 3) as lists
// (ops/surface_viscous.visc_lists): Vq Pq, the gradient rows Vq D_r Pq,
// Vq LIFT, Ef, D_r Pq and LIFT, each [rows][w] slots of (value, column)
// with a row's entries above roundoff in ascending column order and the
// row padded to w with zero values.  The Gauss-collocated hex operators
// couple a point only to its node lines, so every row of one list holds
// about the same count (N + 1 or 6): padding costs nothing there, and a
// row sits at a fixed stride with no row pointers to load.
enum ViscList {
  kLVqPq = 0, kLGrad, kLVqLift, kLEf, kLDrPq, kLLift, kNumViscLists
};
template <int DIM>
constexpr bool kViscLists = DIM == 3;

struct ViscListLayout {
  int off[kNumViscLists];  // the list's first slot
  int w[kNumViscLists];    // its slots a row (0: absent)
  int slots;
};

// rows: Vq Pq [Nq], gradient rows [DIM Nq], Vq LIFT [Nq], Ef [Nfq],
// D_r Pq [DIM Np], LIFT [Np]
inline ViscListLayout visc_list_layout(const int* widths, int dim,
                                       ViscSizes sz) {
  const int rows[kNumViscLists] = {sz.nq, dim * sz.nq, sz.nq,
                                   sz.nfq, dim * sz.np, sz.np};
  ViscListLayout lay;
  int at = 0;
  for (int l = 0; l < kNumViscLists; ++l) {
    lay.off[l] = at;
    lay.w[l] = widths[l];
    at += rows[l] * widths[l];
  }
  lay.slots = at;
  return lay;
}

// the small operators of the viscous stage, in shared or global memory:
// dense at DIM 1 and 2, the lists (lval, lcol, lay) at DIM 3
template <typename T>
struct ViscOps {
  const T *front, *vqlift, *ef, *drpq, *lift;
  const T* lval;
  const unsigned short* lcol;
  ViscListLayout lay;
};

template <bool SMEM, typename T>
__device__ __forceinline__ T ldop(const T* p) {
  if constexpr (SMEM)
    return *p;
  else
    return __ldg(p);
}

// body(a, j) over the slots of row `row` of list l, in column order
template <bool SMEM, typename T, typename F>
__device__ __forceinline__ void visc_row(const ViscOps<T>& op, int l,
                                         int row, F&& body) {
  const int w = op.lay.w[l];
  const int base = op.lay.off[l] + row * w;
  for (int n = 0; n < w; ++n)
    body(ldop<SMEM>(op.lval + base + n), int(ldop<SMEM>(op.lcol + base + n)));
}

// Largest tile of elements whose per-element arrays fit in `cap` bytes,
// else in a whole block; 0 if not even one element fits.
template <typename T>
inline int tile_elements_capped(size_t fixed, size_t per_elem, size_t cap) {
  for (int te = 32; te >= 1; te /= 2)
    if ((fixed + per_elem * te) * sizeof(T) <= cap) return te;
  return tile_elements<T>(fixed, per_elem) >= 1 ? 1 : 0;
}

// The tile of a launch: (elements, workers an element, whether the
// operators are in shared memory, bytes of shared memory); te = 0 when
// not even one element fits.
struct ViscTile {
  int te;         // elements a block (threadIdx.x)
  int nw;         // workers an element (threadIdx.y)
  bool smem_ops;
  size_t bytes;
};

// The dense tile (DIM 1, 2): the `ops` operator values sit in shared
// memory when they fit beside a tile at least as large as the global
// form's within the same per-block budget (kTileBytesGlobalOps, so that
// two blocks share an SM either way), else they are read through the
// read-only path from global memory, L1/L2-resident.  The tri and line
// operators fit.
template <typename T>
inline ViscTile visc_tile(size_t ops, size_t per_elem) {
  const int te_global =
      tile_elements_capped<T>(0, per_elem, kTileBytesGlobalOps);
  int te_smem = 0;
  for (int te = 32; te >= 1 && te_smem == 0; te /= 2)
    if ((ops + per_elem * te) * sizeof(T) <= kTileBytesGlobalOps)
      te_smem = te;
  ViscTile t;
  t.smem_ops = te_smem > 0 && te_smem >= te_global;
  t.te = t.smem_ops ? te_smem : te_global;
  t.nw = t.te > 0 ? kViscThreads / t.te : 0;
  t.bytes = ((t.smem_ops ? ops : 0) + per_elem * t.te) * sizeof(T);
  return t;
}

// The list tile (DIM 3): te elements of nw workers each.  The lists go
// to shared memory when they take at most kListSmemBytes (every block
// copies them once: at hex N=3, 16.5 KB in f32 and 27.5 KB in f64, a
// tile sweep on the card could not tell the two placements apart; at
// N=5, 70 KB in f32, the copy halved the elements resident and the lists
// read from global memory, L1/L2-resident, ran faster), else they are
// read from global memory.  Of the tiles with nw = 32, 64, 128 or 256,
// te nw <= kViscThreads and te words of at least 8 bytes (a warp's load
// of a row covers te elements' words: one 4-byte word uses 4 bytes of a
// 32-byte sector, and at N=5 the f32 tiles of one element ran slower than
// the 2 x 128 one), the one with the most busy workers resident
// on an SM: blocks te nw (the occupancy query, which counts the kernel's
// registers) times the share of the workers a stage's nodes keep busy
// (Nq and Nfq nodes over nw workers, rounds of nw), then the most
// elements, then the largest te (the fewest copies of the lists).
// list_bytes: the slots the launch reads; per_elem: the tile's bytes an
// element.  Cached per kernel and sizes: the host-bound paths launch
// once per RHS.  Returns 0, -1 when no tile fits, or a CUDA error.
constexpr size_t kListSmemBytes = 32768;

template <typename T, typename Kern>
int list_tile(Kern smem_kern, Kern global_kern, ViscSizes sz,
              size_t list_bytes, size_t per_elem, ViscTile* out) {
  struct Entry {
    const void* kern;
    size_t list_bytes, per_elem;
    ViscTile tile;
  };
  static Entry cache[32];
  static int n_cache = 0;
  for (int i = 0; i < n_cache; ++i)
    if (cache[i].kern == (const void*)smem_kern &&
        cache[i].list_bytes == list_bytes && cache[i].per_elem == per_elem) {
      *out = cache[i].tile;
      return 0;
    }
  const bool smem_ops =
      list_bytes <= kListSmemBytes && list_bytes + per_elem <= kMaxSmem;
  const Kern kern = smem_ops ? smem_kern : global_kern;
  const size_t fixed = smem_ops ? list_bytes : 0;
  auto busy = [](int n, int nw) {  // the share of nw workers n nodes keep
    return double(n) / (double((n + nw - 1) / nw) * nw);
  };
  ViscTile best{0, 0, smem_ops, 0};
  double best_score = 0.0;
  int best_elems = 0;
  const int te_min = int((8 + sizeof(T) - 1) / sizeof(T));
  for (int nw = 32; nw <= kViscThreads; nw *= 2)
    for (int te = te_min; te * nw <= kViscThreads; ++te) {
      const size_t bytes = fixed + per_elem * te;
      if (bytes > kMaxSmem) continue;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
      if (err != cudaSuccess) return int(err);
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          te * nw, bytes);
      if (err != cudaSuccess) return int(err);
      const int elems = blocks * te;
      const double score =
          elems * nw * 0.5 * (busy(sz.nq, nw) + busy(sz.nfq, nw));
      if (score > best_score ||
          (score == best_score &&
           (elems > best_elems || (elems == best_elems && te > best.te)))) {
        best = ViscTile{te, nw, smem_ops, bytes};
        best_score = score;
        best_elems = elems;
      }
    }
  if (best.te == 0) return -1;
  if (n_cache < 32)
    cache[n_cache++] = Entry{(const void*)smem_kern, list_bytes, per_elem,
                             best};
  *out = best;
  return 0;
}

// (rho, u_1..DIM, beta) -> (rho, m_1..DIM, E), p = rho / (2 beta)
template <typename T, int DIM>
__device__ __forceinline__ void flux_to_cons(const T* qv, T gm1, T* u) {
  const T rho = qv[0];
  u[0] = rho;
  T u2 = qv[1] * qv[1];
#pragma unroll
  for (int d = 1; d < DIM; ++d) u2 = u2 + qv[1 + d] * qv[1 + d];
#pragma unroll
  for (int d = 0; d < DIM; ++d) u[1 + d] = rho * qv[1 + d];
  u[DIM + 1] = rho / ((T(2) * qv[DIM + 1]) * gm1) + (T(0.5) * rho) * u2;
}

// entropy variables from the flux variables and their logs, with no
// transcendentals (solvers/_shared.entropy_vars_from_flux)
template <typename T, int DIM>
__device__ __forceinline__ void evars_from_flux(const T* qv, T lrho, T lbeta,
                                                const Consts<T>& c, T* v) {
  const T s = ((-c.gm1) * lrho - lbeta) - T(0.6931471805599453);
  const T tb = (T(2) * c.gm1) * qv[DIM + 1];
  T u2 = qv[1] * qv[1];
#pragma unroll
  for (int d = 1; d < DIM; ++d) u2 = u2 + qv[1 + d] * qv[1 + d];
  v[0] = (c.gamma - s) - (T(0.5) * tb) * u2;
#pragma unroll
  for (int d = 0; d < DIM; ++d) v[1 + d] = tb * qv[1 + d];
  v[DIM + 1] = -tb;
}

// |u_n| + c with the normal momentum along the local scaled normal
template <typename T, int DIM>
__device__ __forceinline__ T wavespeed_n(const T* u, const T* n, T isj,
                                         const Consts<T>& c) {
  T rhoun = u[1] * n[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) rhoun = rhoun + u[1 + d] * n[d];
  const T un = (rhoun * isj) / u[0];
  const T p = c.gm1 * (u[DIM + 1] - ((T(0.5) * u[0]) * un) * un);
  return fabs(un) + sqrt((c.gamma * p) / u[0]);
}

// The face stage at one face node of one element.  qm, lm: local flux
// variables and logs; qp, lp: the exchanged neighbour's (overwritten by
// the ghosts); uf, vuf: the local conservative and entropy traces; n: the
// scaled normal.  The pool rows of the node are read at pool[row * rs + o]
// (only when live; lanes past K read zeros, so no region applies).
template <typename T, int DIM>
__device__ __forceinline__ void surface_node(
    const T* qm, const T* lm, T* qp, T* lp, const T* uf, const T* vuf,
    const T* n, T sjv, T isjv, const T* __restrict__ pool, long long o,
    long long rs, bool live, const int* __restrict__ itab,
    const double* __restrict__ ftab, int has_bc, int dissipation,
    int with_penalty, T re, const Consts<T>& c, T* flux, T* dv, T* pen) {
  constexpr int NF = DIM + 2;
  auto P = [&](int row) -> T { return live ? pool[row * rs + o] : T(0); };
  T vup[NF], up[NF];
  evars_from_flux<T, DIM>(qp, lp[0], lp[1], c, vup);
  flux_to_cons<T, DIM>(qp, c.gm1, up);  // pre-BC neighbour, as the hooks
  T nhat[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) nhat[d] = T(0);
  const int nreg = has_bc ? itab[0] : 0;
  if (has_bc) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) nhat[d] = P(itab[1] + d);
    // inviscid ghosts (WallBC.inviscid), regions in order
    for (int r = 0; r < nreg; ++r) {
      const int* ri = itab + 4 + 8 * r;
      if (!(P(ri[1]) > T(0.5))) continue;
      if (ri[0] == kDirichlet) {
#pragma unroll
        for (int f = 0; f < NF; ++f) qp[f] = P(ri[6] + f);
        continue;
      }
      T vn = qm[1] * nhat[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) vn = vn + qm[1 + d] * nhat[d];
      qp[0] = qm[0];
#pragma unroll
      for (int d = 0; d < DIM; ++d) qp[1 + d] = qm[1 + d] - (T(2) * vn) * nhat[d];
      qp[NF - 1] = qm[NF - 1];
    }
    // ghost states may change rho/beta: recompute the ghost logs
    lp[0] = log(qp[0]);
    lp[1] = log(qp[NF - 1]);
  }
  T qmv[NF + 2], qpv[NF + 2];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    qmv[f] = qm[f];
    qpv[f] = qp[f];
  }
  qmv[NF] = lm[0];
  qmv[NF + 1] = lm[1];
  qpv[NF] = lp[0];
  qpv[NF + 1] = lp[1];
  const EcPairN<T, DIM> pr = ec_pair_n<T, DIM>(qmv, qpv, c);
  {
    T fx[NF];
    ec_dir_n<T, DIM>(pr, 0, fx);
#pragma unroll
    for (int f = 0; f < NF; ++f) flux[f] = fx[f] * n[0];
#pragma unroll
    for (int x = 1; x < DIM; ++x) {
      ec_dir_n<T, DIM>(pr, x, fx);
#pragma unroll
      for (int f = 0; f < NF; ++f) flux[f] = flux[f] + fx[f] * n[x];
    }
  }
  if (dissipation) {
    const T lfc = (T(0.25) * fmax(wavespeed_n<T, DIM>(uf, n, isjv, c),
                                  wavespeed_n<T, DIM>(up, n, isjv, c))) *
                  sjv;
#pragma unroll
    for (int f = 0; f < NF; ++f) flux[f] = flux[f] - lfc * (up[f] - uf[f]);
  }
  // entropy-variable ghosts (WallBC.entropy_vars), regions in order
  for (int r = 0; r < nreg; ++r) {
    const int* ri = itab + 4 + 8 * r;
    const double* rf = ftab + 4 * r;
    if (!(P(ri[1]) > T(0.5))) continue;
    const int kind = ri[0];
    if (kind == kDirichlet) {
#pragma unroll
      for (int f = 0; f < NF; ++f) vup[f] = P(ri[7] + f);
    } else if (kind == kSlip) {
      T vn = vuf[1] * nhat[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) vn = vn + vuf[1 + d] * nhat[d];
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        vup[1 + d] = vuf[1 + d] - (T(2) * vn) * nhat[d];
      vup[NF - 1] = vuf[NF - 1];
    } else if (kind == kAdiabatic) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T uw = ri[2 + d] >= 0 ? P(ri[2 + d]) : T(rf[d]);
        vup[1 + d] = T(2) * (uw * (-vuf[NF - 1])) - vuf[1 + d];
      }
      vup[NF - 1] = vuf[NF - 1];
    } else {  // isothermal: v_mom = u_wall / theta, v_last = -1 / theta
      const bool th_arr = ri[5] >= 0;
      const T th = th_arr ? P(ri[5]) : T(rf[3]);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        T two_uw_th;
        if (ri[2 + d] < 0 && !th_arr) {
          two_uw_th = T(2.0 * rf[d] / rf[3]);
        } else {
          const T num = ri[2 + d] >= 0 ? T(2) * P(ri[2 + d]) : T(2.0 * rf[d]);
          two_uw_th = num / th;
        }
        vup[1 + d] = two_uw_th - vuf[1 + d];
      }
      vup[NF - 1] = (th_arr ? T(-2) / th : T(-2.0 / rf[3])) - vuf[NF - 1];
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    dv[f] = vup[f] - vuf[f];
    pen[f] = T(0);
  }
  if (with_penalty) {
    const T tau = T(-1) / (re * vuf[NF - 1]);
#pragma unroll
    for (int f = 1; f < NF; ++f) pen[f] = tau * dv[f];
    // boundary energy row (WallBC.penalty_energy_rows)
    if (has_bc && itab[3] >= 0 && P(itab[2]) > T(0.5)) {
      T base = (T(0.5) * (vup[1] + vuf[1])) * dv[1];
#pragma unroll
      for (int d = 1; d < DIM; ++d)
        base = base + (T(0.5) * (vup[1 + d] + vuf[1 + d])) * dv[1 + d];
      const T num = P(itab[3]) > T(0.5)
                        ? base
                        : base + (T(0.5) * dv[NF - 1]) * dv[NF - 1];
      pen[NF - 1] = ((-tau) * num) / vuf[NF - 1];
    }
  }
}

// sigma_a = sum_b K(ab) grad_b (physics/viscous.py viscous_flux_nd, loop
// order kept); v and g[b] are [DIM + 2] rows, sig[a] likewise
template <typename T, int DIM>
__device__ __forceinline__ void viscous_flux(const T* v, const T (*g)[DIM + 2],
                                             const ViscParams<T>& vp,
                                             T (*sig)[DIM + 2]) {
  const T ve = v[DIM + 1];
  const T inv3 = T(1) / ((ve * ve) * ve);
  const T ve2i = (ve * ve) * inv3;
  T w[DIM], wvei[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    w[i] = v[1 + i];
    wvei[i] = (w[i] * ve) * inv3;
  }
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    T smom[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) smom[i] = T(0);
    T se = T(0);
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      const T* gw = g[b] + 1;
      const T gve = g[b][DIM + 1];
      if (a == b) {
        T kee = T(0);
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
          const T cc = i == a ? vp.l2m : vp.mu;
          smom[i] = smom[i] - (cc * ve2i) * gw[i] + (cc * wvei[i]) * gve;
          se = se + (cc * wvei[i]) * gw[i];
          kee = kee + (cc * w[i]) * w[i];
        }
        se = se - ((kee - (vp.gmu * ve) / vp.pr) * inv3) * gve;
      } else {
        smom[a] = smom[a] - (vp.lam * ve2i) * gw[b] + (vp.lam * wvei[b]) * gve;
        smom[b] = smom[b] - (vp.mu * ve2i) * gw[a] + (vp.mu * wvei[a]) * gve;
        se = se + (vp.mu * wvei[b]) * gw[a] + (vp.lam * wvei[a]) * gw[b] -
             (((vp.lpm * w[a]) * w[b]) * inv3) * gve;
      }
    }
    sig[a][0] = T(0);
#pragma unroll
    for (int i = 0; i < DIM; ++i) sig[a][1 + i] = smom[i];
    sig[a][DIM + 1] = se;
  }
}

// One element's arrays in shared memory, element-minor: row r of the
// element in lane e is base[r * te + e].
template <typename T>
struct TileRows {
  int te, e;
  __device__ __forceinline__ T& operator()(T* base, int row) const {
    return base[row * te + e];
  }
};

// The viscous stage at quadrature node i of one element: front product,
// gradients, sigma (stored to s_sig [DIM][NF][Nq]) and the node's share of
// the production (s_prod [Nq]).  vu [NF][Nq], dv [NF][Nfq], nxj
// [DIM][Nfq] are the element's rows in shared memory; g the element's
// geo[r * DIM + x], ij its 1/J, wq its wJq at node i.  With PROJ the
// projected entropy variables go to vuq_out (when live).
template <typename T, int DIM, bool PROJ, bool OPS_SMEM>
__device__ __forceinline__ void visc_quad_node(
    int i, int nq, int nfq, const TileRows<T>& S, T* s_vu, T* s_dv,
    T* s_nxj, T* s_sig, T* s_prod, const ViscOps<T>& op, const T* g, T ij,
    T wq, const ViscParams<T>& vp, T* __restrict__ vuq_out, long long K,
    long long k, bool live) {
  constexpr int NF = DIM + 2;
  constexpr int OFF = PROJ ? 1 : 0;   // gradient rows after Vq Pq
  T vq_[NF], vqd[DIM][NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    vq_[f] = T(0);
#pragma unroll
    for (int r = 0; r < DIM; ++r) vqd[r][f] = T(0);
  }
  if constexpr (kViscLists<DIM>) {
    // each front row over its own entries, in the dense loop's order
    if constexpr (PROJ)
      visc_row<OPS_SMEM>(op, kLVqPq, i, [&](T a, int j) {
#pragma unroll
        for (int f = 0; f < NF; ++f) vq_[f] += a * S(s_vu, f * nq + j);
      });
#pragma unroll
    for (int r = 0; r < DIM; ++r)
      visc_row<OPS_SMEM>(op, kLGrad, r * nq + i, [&](T a, int j) {
#pragma unroll
        for (int f = 0; f < NF; ++f) vqd[r][f] += a * S(s_vu, f * nq + j);
      });
  } else {
    for (int j = 0; j < nq; ++j) {
      T a[DIM];
#pragma unroll
      for (int r = 0; r < DIM; ++r)
        a[r] = ldop<OPS_SMEM>(op.front + ((OFF + r) * nq + i) * nq + j);
      T a0 = T(0);
      if constexpr (PROJ) a0 = ldop<OPS_SMEM>(op.front + i * nq + j);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const T vv = S(s_vu, f * nq + j);
        if constexpr (PROJ) vq_[f] += a0 * vv;
#pragma unroll
        for (int r = 0; r < DIM; ++r) vqd[r][f] += a[r] * vv;
      }
    }
  }
  if constexpr (!PROJ) {
#pragma unroll
    for (int f = 0; f < NF; ++f) vq_[f] = S(s_vu, f * nq + i);
  }
  T grad[DIM][NF];
#pragma unroll
  for (int x = 0; x < DIM; ++x)
#pragma unroll
    for (int f = 0; f < NF; ++f) grad[x][f] = T(0);   // the surface term
  auto surface = [&](T a, int fp) {
    T nx[DIM];
#pragma unroll
    for (int x = 0; x < DIM; ++x) nx[x] = S(s_nxj, x * nfq + fp);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const T hdv = T(0.5) * S(s_dv, f * nfq + fp);
#pragma unroll
      for (int x = 0; x < DIM; ++x) grad[x][f] += a * (hdv * nx[x]);
    }
  };
  if constexpr (kViscLists<DIM>)
    visc_row<OPS_SMEM>(op, kLVqLift, i, surface);
  else
    for (int fp = 0; fp < nfq; ++fp)
      surface(ldop<OPS_SMEM>(op.vqlift + i * nfq + fp), fp);
#pragma unroll
  for (int x = 0; x < DIM; ++x)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T vol = g[x] * vqd[0][f];
#pragma unroll
      for (int r = 1; r < DIM; ++r) vol = vol + g[r * DIM + x] * vqd[r][f];
      grad[x][f] = (vol + grad[x][f]) * ij;
    }
  T sig[DIM][NF];
  viscous_flux<T, DIM>(vq_, grad, vp, sig);
  T pr = T(0);
#pragma unroll
  for (int x = 0; x < DIM; ++x)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      S(s_sig, (x * NF + f) * nq + i) = sig[x][f];
      pr += (wq * grad[x][f]) * sig[x][f];
    }
  S(s_prod, i) = pr;
  if constexpr (PROJ) {
    if (live) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        vuq_out[(long long)(f * nq + i) * K + k] = vq_[f];
    }
  }
}

// the stress traces at face node fp: s[x][f] = (Ef sigma_x)[f]
template <typename T, int DIM, bool OPS_SMEM>
__device__ __forceinline__ void visc_ef_sigma_node(int fp, int nq,
                                                   const TileRows<T>& S,
                                                   T* s_sig,
                                                   const ViscOps<T>& op,
                                                   T (*s)[DIM + 2]) {
  constexpr int NF = DIM + 2;
#pragma unroll
  for (int x = 0; x < DIM; ++x)
#pragma unroll
    for (int f = 0; f < NF; ++f) s[x][f] = T(0);
  auto add = [&](T a, int i) {
#pragma unroll
    for (int x = 0; x < DIM; ++x)
#pragma unroll
      for (int f = 0; f < NF; ++f) s[x][f] += a * S(s_sig, (x * NF + f) * nq + i);
  };
  if constexpr (kViscLists<DIM>)
    visc_row<OPS_SMEM>(op, kLEf, fp, add);
  else
    for (int i = 0; i < nq; ++i) add(ldop<OPS_SMEM>(op.ef + fp * nq + i), i);
}

// The traces of face node fp to out [rows, Nfq, K]: with contract the
// normal-contracted traction t_f = sum_x (Ef sigma_x)[f] nxj_x (rows f),
// else the components (rows x NF + f).
template <typename T, int DIM, bool OPS_SMEM>
__device__ __forceinline__ void visc_traces_node(int fp, int nq, int nfq,
                                                 const TileRows<T>& S,
                                                 T* s_sig, T* s_nxj,
                                                 const ViscOps<T>& op,
                                                 bool contract,
                                                 T* __restrict__ out,
                                                 long long K, long long k) {
  constexpr int NF = DIM + 2;
  T s[DIM][NF];
  visc_ef_sigma_node<T, DIM, OPS_SMEM>(fp, nq, S, s_sig, op, s);
  if (!contract) {
#pragma unroll
    for (int x = 0; x < DIM; ++x)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        out[(long long)((x * NF + f) * nfq + fp) * K + k] = s[x][f];
    return;
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T acc = s[0][f] * S(s_nxj, fp);
#pragma unroll
    for (int x = 1; x < DIM; ++x) acc = acc + s[x][f] * S(s_nxj, x * nfq + fp);
    out[(long long)(f * nfq + fp) * K + k] = acc;
  }
}

// the divergence at solution node n: sum_r (D_r Pq)(sum_x geo[r,x] sigma_x)
template <typename T, int DIM, bool OPS_SMEM>
__device__ __forceinline__ void visc_div_node(int n, int np, int nq,
                                              const TileRows<T>& S, T* s_sig,
                                              const ViscOps<T>& op,
                                              const T* g, T* dvg) {
  constexpr int NF = DIM + 2;
#pragma unroll
  for (int f = 0; f < NF; ++f) dvg[f] = T(0);
#pragma unroll
  for (int r = 0; r < DIM; ++r) {
    T t[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) t[f] = T(0);
    auto add = [&](T a, int i) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        T gs = g[r * DIM] * S(s_sig, f * nq + i);
#pragma unroll
        for (int x = 1; x < DIM; ++x)
          gs = gs + g[r * DIM + x] * S(s_sig, (x * NF + f) * nq + i);
        t[f] += a * gs;
      }
    };
    if constexpr (kViscLists<DIM>)
      visc_row<OPS_SMEM>(op, kLDrPq, r * np + n, add);
    else
      for (int i = 0; i < nq; ++i)
        add(ldop<OPS_SMEM>(op.drpq + (r * np + n) * nq + i), i);
#pragma unroll
    for (int f = 0; f < NF; ++f) dvg[f] += t[f];
  }
}

}  // namespace esdg
