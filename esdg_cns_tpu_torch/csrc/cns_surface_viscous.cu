// K4: merged post-exchange surface stage + viscous mid-section of the 2D
// affine CNS RHS.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_viscous.py::
// _surface_viscous_kernel (wrapper cns_surface_viscous_pallas, body
// _viscous_body; BC transport ops/pallas_cns_surface.py).  Per element:
//   1. face stage, one thread per (element, face node): the conservative
//      and entropy traces of both sides rebuilt from the flux-variable
//      payload (no transcendentals), the wall-BC ghosts walked over the
//      region table in region order, the EC face flux + LF, the entropy
//      BC, the BR1 jump dv and the interface-penalty rows;
//   2. quadrature stage, one thread per (element, quadrature node): the
//      front product [Vq Pq; Vq D_r Pq] v(U), the gradients
//      grad_x = (sum_r geo[r,x] vqd_r + (Vq L)(dv/2 nxj_x)) / J, the
//      viscous flux sigma = K(v) grad (viscous_flux_nd's formulas) and
//      the node's share of the entropy production wJq grad.sigma;
//   3. the contracted traction t_f = sum_x (Ef sigma_x) nxj_x;
//   4. at the Np nodes the divergence sum_r (D_r Pq)(sum_x geo[r,x]
//      sigma_x), and with fold_tail the assembly
//      dq = -(ph_qf + LIFT flux)/J + div/J + LIFT pen
//      (the penalty is added after the 1/J scaling, as the reference
//      does); the per-element production, summed over the quadrature
//      nodes in a fixed order.
// The small operators live in shared memory with the tile's per-element
// arrays.  The BC reaches the kernel as the pool [L, Nfq, K] (normals,
// masks, wall rows, per-call Dirichlet states) and a flat region table
// (ops/cns_surface_bc.region_table): ints (R, nhat row, bmask row,
// adiabatic row, then per region kind, mask row, u_wall rows, theta row,
// Dirichlet rows) and floats (per region the u_wall and theta scalars).
//
// What bounds it on this card: at N=3 (Np=10, Nq=Nfq=12) each element
// evaluates 12 face fluxes (two logarithmic means, two logs with a BC,
// two square roots), 12 viscous matrices (one division) and about 7k
// multiply-adds of small dense products, about 16k operations, while it
// reads about 370 and writes about 140 values (2 KB in f32, 66 MB per
// RHS at K=32768).  At the card's peaks the stream takes 2.5 times as
// long as the arithmetic, so the bound is HBM; the dense products are
// served from shared memory so that they add no HBM traffic.
//
// Simple design: a block owns TE elements (threadIdx.x, coalesced K-last
// loads and stores) and 256/TE workers (threadIdx.y) that take the nodes
// of each stage in turn; __syncthreads() separates the stages.  No
// atomics: every sum has one owner and a fixed order, so the result is
// deterministic.  Lanes past K compute on a quiescent state and store
// nothing.  dim = 2 only (the 3D cavity's dim=3 / proj=False form is
// later work; the wrapper raises).
#include "common.cuh"

namespace esdg {

constexpr int kViscThreads = 256;
enum WallKind { kAdiabatic = 0, kIsothermal = 1, kSlip = 2, kDirichlet = 3 };

struct ViscSizes {
  int np, nq, nfq;
  // operators: front [3 Nq][Nq], vqlift [Nq][Nfq], ef [Nfq][Nq],
  // drpq [2][Np][Nq], lift [Np][Nfq]
  size_t fixed() const {
    return size_t(3) * nq * nq + size_t(nq) * nfq + size_t(nfq) * nq +
           size_t(2) * np * nq + size_t(np) * nfq;
  }
  // per element: vu [4][Nq], flux, pen, dv [4][Nfq] each, nxj [2][Nfq],
  // sigma [2][4][Nq], prod [Nq]
  size_t per_elem() const {
    return size_t(4) * nq + size_t(12) * nfq + size_t(2) * nfq +
           size_t(8) * nq + size_t(nq);
  }
};

template <typename T>
struct ViscParams {
  T mu, lam, l2m, lpm, gmu, pr, re;
};

// (rho, u1, u2, beta) -> (rho, m1, m2, E), p = rho / (2 beta)
template <typename T>
__device__ __forceinline__ void flux_to_cons(const T* qv, T gm1, T u[4]) {
  const T rho = qv[0];
  u[0] = rho;
  u[1] = rho * qv[1];
  u[2] = rho * qv[2];
  u[3] = rho / ((T(2) * qv[3]) * gm1) +
         (T(0.5) * rho) * (qv[1] * qv[1] + qv[2] * qv[2]);
}

// entropy variables from the flux variables and their logs, with no
// transcendentals (solvers/_shared.entropy_vars_from_flux): both face
// sides evaluate this same formula on the same payload
template <typename T>
__device__ __forceinline__ void evars_from_flux(const T* qv, T lrho, T lbeta,
                                                const Consts<T>& c, T v[4]) {
  const T s = ((-c.gm1) * lrho - lbeta) - T(0.6931471805599453);
  const T tb = (T(2) * c.gm1) * qv[3];
  v[0] = (c.gamma - s) - (T(0.5) * tb) * (qv[1] * qv[1] + qv[2] * qv[2]);
  v[1] = tb * qv[1];
  v[2] = tb * qv[2];
  v[3] = -tb;
}

// |u_n| + c with the normal momentum along the local scaled normal
template <typename T>
__device__ __forceinline__ T wavespeed_n(const T u[4], const T n[2], T isj,
                                         const Consts<T>& c) {
  const T un = ((u[1] * n[0] + u[2] * n[1]) * isj) / u[0];
  const T p = c.gm1 * (u[3] - ((T(0.5) * u[0]) * un) * un);
  return fabs(un) + sqrt((c.gamma * p) / u[0]);
}

// sigma_x, sigma_y = K(v) (grad_x, grad_y) in 2D (physics/viscous.py
// viscous_flux_nd, loop order kept)
template <typename T>
__device__ __forceinline__ void viscous_flux_2d(const T v[4], const T g[2][4],
                                                const ViscParams<T>& vp,
                                                T sig[2][4]) {
  const T ve = v[3];
  const T inv3 = T(1) / ((ve * ve) * ve);
  const T ve2i = (ve * ve) * inv3;
  const T w[2] = {v[1], v[2]};
  const T wvei[2] = {(w[0] * ve) * inv3, (w[1] * ve) * inv3};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    T smom[2] = {T(0), T(0)};
    T se = T(0);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T gw[2] = {g[b][1], g[b][2]};
      const T gve = g[b][3];
      if (a == b) {
        T kee = T(0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
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
    sig[a][1] = smom[0];
    sig[a][2] = smom[1];
    sig[a][3] = se;
  }
}

template <typename T>
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
        const T* __restrict__ lift, const int* __restrict__ itab,
        const double* __restrict__ ftab, T* __restrict__ flux_out,
        T* __restrict__ pen_out, T* __restrict__ tf_out,
        T* __restrict__ div_out, T* __restrict__ prod_out,
        T* __restrict__ vuq_out, long long K, ViscSizes sz, double gamma,
        ViscParams<T> vp, int dissipation, int with_penalty, int fold_tail,
        int has_bc) {
  const Consts<T> c(gamma);
  const int np = sz.np, nq = sz.nq, nfq = sz.nfq;
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_front = reinterpret_cast<T*>(smem_raw);
  T* s_vqlift = s_front + 3 * nq * nq;
  T* s_ef = s_vqlift + nq * nfq;
  T* s_drpq = s_ef + nfq * nq;
  T* s_lift = s_drpq + 2 * np * nq;
  T* s_vu = s_lift + np * nfq;     // [4 Nq][TE]
  T* s_flux = s_vu + 4 * nq * TE;  // [4 Nfq][TE]
  T* s_pen = s_flux + 4 * nfq * TE;
  T* s_dv = s_pen + 4 * nfq * TE;
  T* s_nxj = s_dv + 4 * nfq * TE;  // [2 Nfq][TE]
  T* s_sig = s_nxj + 2 * nfq * TE; // [2][4][Nq][TE]
  T* s_prod = s_sig + 8 * nq * TE; // [Nq][TE]
  auto S = [&](T* base, int row) -> T& { return base[row * TE + e]; };

  for (int i = tid; i < 3 * nq * nq; i += nthreads) s_front[i] = front[i];
  for (int i = tid; i < nq * nfq; i += nthreads) s_vqlift[i] = vqlift[i];
  for (int i = tid; i < nfq * nq; i += nthreads) s_ef[i] = ef[i];
  for (int i = tid; i < 2 * np * nq; i += nthreads) s_drpq[i] = drpq[i];
  if (fold_tail)
    for (int i = tid; i < np * nfq; i += nthreads) s_lift[i] = lift[i];
  for (int row = w; row < 4 * nq; row += NW) {
    // quiescent entropy state past K keeps 1/ve^3 finite
    const T quiescent = row / nq == 3 ? T(-1) : T(0);
    S(s_vu, row) = live ? vu[(long long)row * K + k] : quiescent;
  }
  T g[4] = {T(0), T(0), T(0), T(0)};  // geo[r*2 + x], affine
  T ij = T(0);
  if (live) {
#pragma unroll
    for (int r = 0; r < 4; ++r) g[r] = geo[(long long)r * K + k];
    ij = invj[k];
  }

  // ---- 1. face stage ----
  const int nreg = has_bc ? itab[0] : 0;
  for (int fp = w; fp < nfq; fp += NW) {
    const long long o = (long long)fp * K + k;
    const long long rs = (long long)nfq * K;  // row stride
    T qm[4] = {T(1), T(0), T(0), T(1)}, qp[4] = {T(1), T(0), T(0), T(1)};
    T lm[2] = {T(0), T(0)}, lp[2] = {T(0), T(0)};
    T n[2] = {T(0), T(0)};
    T sjv = T(1), isjv = T(1);
    if (live) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qm[r] = qmv[r * rs + o];
        qp[r] = nbr[r * rs + o];
      }
      lm[0] = qml[o];
      lm[1] = qml[rs + o];
      lp[0] = nbr[4 * rs + o];
      lp[1] = nbr[5 * rs + o];
      n[0] = nxj[o];
      n[1] = nxj[rs + o];
      sjv = sj[o];
      isjv = isj[o];
    }
    auto P = [&](int row) -> T { return live ? pool[row * rs + o] : T(0); };
    T uf[4], vuf[4], vup[4], up[4];
    flux_to_cons(qm, c.gm1, uf);
    evars_from_flux(qm, lm[0], lm[1], c, vuf);
    evars_from_flux(qp, lp[0], lp[1], c, vup);
    flux_to_cons(qp, c.gm1, up);  // pre-BC neighbour state, as the hooks
    T nhat[2] = {T(0), T(0)};
    if (has_bc) {
      nhat[0] = P(itab[1]);
      nhat[1] = P(itab[1] + 1);
      // inviscid ghosts (WallBC.inviscid), regions in order
      for (int r = 0; r < nreg; ++r) {
        const int* ri = itab + 4 + 8 * r;
        if (!(P(ri[1]) > T(0.5))) continue;
        if (ri[0] == kDirichlet) {
#pragma unroll
          for (int f = 0; f < 4; ++f) qp[f] = P(ri[6] + f);
          continue;
        }
        const T vn = qm[1] * nhat[0] + qm[2] * nhat[1];
        qp[0] = qm[0];
        qp[1] = qm[1] - (T(2) * vn) * nhat[0];
        qp[2] = qm[2] - (T(2) * vn) * nhat[1];
        qp[3] = qm[3];
      }
      // ghost states may change rho/beta: recompute the ghost logs
      lp[0] = log(qp[0]);
      lp[1] = log(qp[3]);
    }
    T qmv6[6] = {qm[0], qm[1], qm[2], qm[3], lm[0], lm[1]};
    T qpv6[6] = {qp[0], qp[1], qp[2], qp[3], lp[0], lp[1]};
    const EcPair2<T> pr = ec_pair2(qmv6, qpv6, c);
    T f0[4], f1[4], flux[4];
    ec_dir2(pr, 0, f0);
    ec_dir2(pr, 1, f1);
#pragma unroll
    for (int f = 0; f < 4; ++f) flux[f] = f0[f] * n[0] + f1[f] * n[1];
    if (dissipation) {
      const T lfc = (T(0.25) * fmax(wavespeed_n(uf, n, isjv, c),
                                    wavespeed_n(up, n, isjv, c))) * sjv;
#pragma unroll
      for (int f = 0; f < 4; ++f) flux[f] = flux[f] - lfc * (up[f] - uf[f]);
    }
    // entropy-variable ghosts (WallBC.entropy_vars), regions in order
    for (int r = 0; r < nreg; ++r) {
      const int* ri = itab + 4 + 8 * r;
      const double* rf = ftab + 4 * r;
      if (!(P(ri[1]) > T(0.5))) continue;
      const int kind = ri[0];
      if (kind == kDirichlet) {
#pragma unroll
        for (int f = 0; f < 4; ++f) vup[f] = P(ri[7] + f);
      } else if (kind == kSlip) {
        const T vn = vuf[1] * nhat[0] + vuf[2] * nhat[1];
        vup[1] = vuf[1] - (T(2) * vn) * nhat[0];
        vup[2] = vuf[2] - (T(2) * vn) * nhat[1];
        vup[3] = vuf[3];
      } else if (kind == kAdiabatic) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const T uw = ri[2 + d] >= 0 ? P(ri[2 + d]) : T(rf[d]);
          vup[1 + d] = T(2) * (uw * (-vuf[3])) - vuf[1 + d];
        }
        vup[3] = vuf[3];
      } else {  // isothermal: v_mom = u_wall / theta, v4 = -1 / theta
        const bool th_arr = ri[5] >= 0;
        const T th = th_arr ? P(ri[5]) : T(rf[3]);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          T two_uw_th;
          if (ri[2 + d] < 0 && !th_arr) {
            two_uw_th = T(2.0 * rf[d] / rf[3]);
          } else {
            const T num = ri[2 + d] >= 0 ? T(2) * P(ri[2 + d]) : T(2.0 * rf[d]);
            two_uw_th = num / th;
          }
          vup[1 + d] = two_uw_th - vuf[1 + d];
        }
        vup[3] = (th_arr ? T(-2) / th : T(-2.0 / rf[3])) - vuf[3];
      }
    }
    T dv[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) dv[f] = vup[f] - vuf[f];
    T pen[4] = {T(0), T(0), T(0), T(0)};
    if (with_penalty) {
      const T tau = T(-1) / (T(vp.re) * vuf[3]);
      pen[1] = tau * dv[1];
      pen[2] = tau * dv[2];
      pen[3] = tau * dv[3];
      // boundary energy row (WallBC.penalty_energy_rows)
      if (has_bc && itab[3] >= 0 && P(itab[2]) > T(0.5)) {
        const T base = (T(0.5) * (vup[1] + vuf[1])) * dv[1] +
                       (T(0.5) * (vup[2] + vuf[2])) * dv[2];
        const T num = P(itab[3]) > T(0.5) ? base
                                          : base + (T(0.5) * dv[3]) * dv[3];
        pen[3] = ((-tau) * num) / vuf[3];
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      S(s_flux, f * nfq + fp) = flux[f];
      S(s_pen, f * nfq + fp) = pen[f];
      S(s_dv, f * nfq + fp) = dv[f];
      if (live && !fold_tail) {
        flux_out[f * rs + o] = flux[f];
        if (with_penalty) pen_out[f * rs + o] = pen[f];
      }
    }
    S(s_nxj, fp) = n[0];
    S(s_nxj, nfq + fp) = n[1];
  }
  __syncthreads();

  // ---- 2. quadrature stage: front product, gradients, sigma ----
  for (int i = w; i < nq; i += NW) {
    T vq_[4] = {T(0), T(0), T(0), T(0)};
    T vqd[2][4] = {{T(0), T(0), T(0), T(0)}, {T(0), T(0), T(0), T(0)}};
    for (int j = 0; j < nq; ++j) {
      const T a0 = s_front[i * nq + j];
      const T a1 = s_front[(nq + i) * nq + j];
      const T a2 = s_front[(2 * nq + i) * nq + j];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const T vv = S(s_vu, f * nq + j);
        vq_[f] += a0 * vv;
        vqd[0][f] += a1 * vv;
        vqd[1][f] += a2 * vv;
      }
    }
    T surf[2][4] = {{T(0), T(0), T(0), T(0)}, {T(0), T(0), T(0), T(0)}};
    for (int fp = 0; fp < nfq; ++fp) {
      const T a = s_vqlift[i * nfq + fp];
      const T nx0 = S(s_nxj, fp), nx1 = S(s_nxj, nfq + fp);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const T hdv = T(0.5) * S(s_dv, f * nfq + fp);
        surf[0][f] += a * (hdv * nx0);
        surf[1][f] += a * (hdv * nx1);
      }
    }
    T grad[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        grad[x][f] =
            ((g[x] * vqd[0][f] + g[2 + x] * vqd[1][f]) + surf[x][f]) * ij;
    T sig[2][4];
    viscous_flux_2d(vq_, grad, vp, sig);
    const T wq = live ? wjq[(long long)i * K + k] : T(0);
    T pr = T(0);
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        S(s_sig, (x * 4 + f) * nq + i) = sig[x][f];
        pr += (wq * grad[x][f]) * sig[x][f];
      }
    S(s_prod, i) = pr;
    if (live) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        vuq_out[(long long)(f * nq + i) * K + k] = vq_[f];
    }
  }
  __syncthreads();
  if (!live) return;  // no barrier below

  // ---- 3. contracted traction t_f = sum_x (Ef sigma_x) nxj_x ----
  for (int fp = w; fp < nfq; fp += NW) {
    T s0[4] = {T(0), T(0), T(0), T(0)}, s1[4] = {T(0), T(0), T(0), T(0)};
    for (int i = 0; i < nq; ++i) {
      const T a = s_ef[fp * nq + i];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        s0[f] += a * S(s_sig, f * nq + i);
        s1[f] += a * S(s_sig, (4 + f) * nq + i);
      }
    }
    const T nx0 = S(s_nxj, fp), nx1 = S(s_nxj, nfq + fp);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      tf_out[(long long)(f * nfq + fp) * K + k] = s0[f] * nx0 + s1[f] * nx1;
  }

  // ---- 4. divergence, and with fold_tail the assembly ----
  for (int n = w; n < np; n += NW) {
    T dvg[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T t[4] = {T(0), T(0), T(0), T(0)};
      for (int i = 0; i < nq; ++i) {
        const T a = s_drpq[(r * np + n) * nq + i];
#pragma unroll
        for (int f = 0; f < 4; ++f)
          t[f] += a * (g[r * 2] * S(s_sig, f * nq + i) +
                       g[r * 2 + 1] * S(s_sig, (4 + f) * nq + i));
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) dvg[f] += t[f];
    }
    if (!fold_tail) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        div_out[(long long)(f * np + n) * K + k] = dvg[f];
      continue;
    }
    T lf[4] = {T(0), T(0), T(0), T(0)}, lp[4] = {T(0), T(0), T(0), T(0)};
    for (int fp = 0; fp < nfq; ++fp) {
      const T a = s_lift[n * nfq + fp];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        lf[f] += a * S(s_flux, f * nfq + fp);
        lp[f] += a * S(s_pen, f * nfq + fp);
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const long long o = (long long)(f * np + n) * K + k;
      T acc = -(phqf[o] + lf[f]) * ij + dvg[f] * ij;
      if (with_penalty) acc = acc + lp[f];
      div_out[o] = acc;
    }
  }
  if (w == 0) {
    T s = T(0);
    for (int i = 0; i < nq; ++i) s += S(s_prod, i);
    prod_out[k] = s;
  }
}

template <typename T>
int launch_surface_viscous(const void* const* in, void* const* out,
                           const int* itab, const double* ftab, long long K,
                           ViscSizes sz, double gamma, double mu, double lam,
                           double pr, double re, int dissipation,
                           int with_penalty, int fold_tail, int has_bc,
                           cudaStream_t stream) {
  const int te = tile_elements<T>(sz.fixed(), sz.per_elem());
  if (te == 0) return -1;
  const size_t smem = (sz.fixed() + sz.per_elem() * te) * sizeof(T);
  auto kern = cns_surface_viscous_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // gamma- and mu-derived constants in double, rounded once to T
  ViscParams<T> vp;
  vp.mu = T(mu);
  vp.lam = T(lam);
  vp.l2m = T(2.0 * mu + lam);
  vp.lpm = T(lam + mu);
  vp.gmu = T(gamma * mu);
  vp.pr = T(pr);
  vp.re = T(re);
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  const dim3 block(te, kViscThreads / te);
  const dim3 grid(unsigned((K + te - 1) / te));
  kern<<<grid, block, smem, stream>>>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), I(7), I(8), I(9), I(10),
      I(11), I(12), I(13), I(14), I(15), I(16), itab, ftab, O(0), O(1), O(2),
      O(3), O(4), O(5), K, sz, gamma, vp, dissipation, with_penalty,
      fold_tail, has_bc);
  return int(cudaGetLastError());
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  in[17] = (vu_q, qm, qm_log, nbr, nxj,
// sj, inv_sj, pool, geo, inv_j, wjq, front, vqlift, ef, drpq, ph_qf, lift);
// pool may be any pointer when has_bc = 0, ph_qf and lift when
// fold_tail = 0.  out[6] = (flux, pen, t_f, div or dq_part, prod, vuq);
// flux and pen are not written with fold_tail, pen not without
// with_penalty.  itab / ftab: the region table (device memory), read
// only when has_bc.  Returns cudaGetLastError() after the launch, -1 when
// the tile does not fit in shared memory, -2 for an unknown dtype.
extern "C" int esdg_cns_surface_viscous(
    int dtype, const void* const* in, void* const* out, const void* itab,
    const void* ftab, long long K, int np, int nq, int nfq, double gamma,
    double mu, double lam, double pr, double re, int dissipation,
    int with_penalty, int fold_tail, int has_bc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const esdg::ViscSizes sz{np, nq, nfq};
  const int* it = static_cast<const int*>(itab);
  const double* ft = static_cast<const double*>(ftab);
  if (dtype == 0)
    return esdg::launch_surface_viscous<float>(
        in, out, it, ft, K, sz, gamma, mu, lam, pr, re, dissipation,
        with_penalty, fold_tail, has_bc, st);
  if (dtype == 1)
    return esdg::launch_surface_viscous<double>(
        in, out, it, ft, K, sz, gamma, mu, lam, pr, re, dissipation,
        with_penalty, fold_tail, has_bc, st);
  return -2;
}
