// K7: the viscous mid-section of the affine CNS RHS alone, in 2D (tris,
// proj) and 3D (collocated hexes, no projection block), with the
// normal-contracted traction.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_viscous.py::
// _viscous_kernel (wrapper cns_viscous_pallas, body _viscous_body).  It
// runs after the separate surface stage (K8, cns_surface.cu), which hands
// it the BC-adjusted entropy jump dv.  Per element: the quadrature stage
// visc_quad_node (front product, gradients, sigma = K(v) grad(v), the
// production share), the contracted traction at the face nodes, the
// divergence at the Np nodes and the per-element production summed over
// the quadrature nodes in a fixed order (cns_stages.cuh, the same device
// code as K4's viscous half).
//
// What bounds it on an H100: the same dense products as K4's viscous
// half (2D tri N=3: HBM-bound, operators in shared memory; 3D hex N=3:
// operation-bound, operators read from global memory through the
// read-only path, per-element arrays in shared memory), plus the jump dv
// it reads instead of rebuilding it.
//
// Simple design, as K4: a block owns TE elements (threadIdx.x) and 256/TE
// workers (threadIdx.y); no atomics; lanes past K compute on a quiescent
// state and store nothing.
#include "cns_stages.cuh"

namespace esdg {

template <typename T, int DIM>
__global__ void __launch_bounds__(kViscThreads)
    cns_viscous_kernel(const T* __restrict__ vu, const T* __restrict__ dv,
                       const T* __restrict__ geo, const T* __restrict__ nxj,
                       const T* __restrict__ invj, const T* __restrict__ wjq,
                       const T* __restrict__ front,
                       const T* __restrict__ vqlift, const T* __restrict__ ef,
                       const T* __restrict__ drpq, T* __restrict__ tf_out,
                       T* __restrict__ div_out, T* __restrict__ prod_out,
                       T* __restrict__ vuq_out, long long K,
                       ViscSizes sz, ViscParams<T> vp) {
  constexpr int NF = DIM + 2;
  constexpr bool PROJ = kProj<DIM>, OPS_SMEM = kOpsSmem<DIM>;
  const int np = sz.np, nq = sz.nq, nfq = sz.nfq;
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;
  const TileRows<T> S{TE, e};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  ViscOps<T> op{front, vqlift, ef, drpq, nullptr};
  if constexpr (OPS_SMEM) {
    const int n_front = (int(PROJ) + DIM) * nq * nq;
    T* s_front = s;
    T* s_vqlift = s_front + n_front;
    T* s_ef = s_vqlift + nq * nfq;
    T* s_drpq = s_ef + nfq * nq;
    for (int i = tid; i < n_front; i += nthreads) s_front[i] = front[i];
    for (int i = tid; i < nq * nfq; i += nthreads) s_vqlift[i] = vqlift[i];
    for (int i = tid; i < nfq * nq; i += nthreads) s_ef[i] = ef[i];
    for (int i = tid; i < DIM * np * nq; i += nthreads) s_drpq[i] = drpq[i];
    op = ViscOps<T>{s_front, s_vqlift, s_ef, s_drpq, nullptr};
    s = s_drpq + DIM * np * nq;
  }
  T* s_vu = s;                        // [NF Nq][TE]
  T* s_dv = s_vu + NF * nq * TE;      // [NF Nfq][TE]
  T* s_nxj = s_dv + NF * nfq * TE;    // [DIM Nfq][TE]
  T* s_sig = s_nxj + DIM * nfq * TE;  // [DIM][NF][Nq][TE]
  T* s_prod = s_sig + DIM * NF * nq * TE;  // [Nq][TE]

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
    visc_quad_node<T, DIM>(i, nq, nfq, S, s_vu, s_dv, s_nxj, s_sig, s_prod,
                           op, g, ij, wq, vp, vuq_out, K, k, live);
  }
  __syncthreads();
  if (!live) return;  // no barrier below

  for (int fp = w; fp < nfq; fp += NW) {
    T t[NF];
    visc_traction_node<T, DIM>(fp, nq, nfq, S, s_sig, s_nxj, op, t);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      tf_out[(long long)(f * nfq + fp) * K + k] = t[f];
  }
  for (int nn = w; nn < np; nn += NW) {
    T dvg[NF];
    visc_div_node<T, DIM>(nn, np, nq, S, s_sig, op, g, dvg);
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

template <typename T, int DIM>
int launch_viscous(const void* const* in, void* const* out, long long K,
                   ViscSizes sz, double gamma, double mu, double lam,
                   double pr, cudaStream_t stream) {
  constexpr int NF = DIM + 2;
  constexpr bool PROJ = kProj<DIM>, OPS_SMEM = kOpsSmem<DIM>;
  const size_t nq = sz.nq, nfq = sz.nfq, np = sz.np;
  // operators: front [(PROJ + DIM) Nq][Nq], vqlift [Nq][Nfq], ef [Nfq][Nq],
  // drpq [DIM][Np][Nq]
  const size_t ops = (int(PROJ) + DIM) * nq * nq + nq * nfq + nfq * nq +
                     DIM * np * nq;
  // per element: vu [NF][Nq]; dv [NF][Nfq]; nxj [DIM][Nfq];
  // sigma [DIM][NF][Nq]; prod [Nq]
  const size_t per_elem = NF * nq + NF * nfq + DIM * nfq + DIM * NF * nq + nq;
  const size_t fixed = OPS_SMEM ? ops : 0;
  const int te = OPS_SMEM ? tile_elements<T>(fixed, per_elem)
                          : tile_elements_capped<T>(0, per_elem,
                                                    kTileBytesGlobalOps);
  if (te == 0) return -1;
  const size_t smem = (fixed + per_elem * te) * sizeof(T);
  auto kern = cns_viscous_kernel<T, DIM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const ViscParams<T> vp = make_visc_params<T>(gamma, mu, lam, pr, 1.0);
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  const dim3 block(te, kViscThreads / te);
  const dim3 grid(unsigned((K + te - 1) / te));
  kern<<<grid, block, smem, stream>>>(I(0), I(1), I(2), I(3), I(4), I(5),
                                      I(6), I(7), I(8), I(9), O(0), O(1),
                                      O(2), O(3), K, sz, vp);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_viscous(int dim, const void* const* in, void* const* out,
                     long long K, ViscSizes sz, double gamma, double mu,
                     double lam, double pr, cudaStream_t st) {
  if (dim == 2)
    return launch_viscous<T, 2>(in, out, K, sz, gamma, mu, lam, pr, st);
  if (dim == 3)
    return launch_viscous<T, 3>(in, out, K, sz, gamma, mu, lam, pr, st);
  return -3;
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64; dim 2 (proj, the tri form) or 3 (no
// projection block, the collocated-hex form).  in[10] = (vu_q, dv, geo,
// nxj, inv_j, wjq, front, vqlift, ef, drpq); out[4] = (t_f, div, prod,
// vuq), vuq not written at dim 3.  Returns cudaGetLastError() after the
// launch, -1 when the tile does not fit in shared memory, -2 for an
// unknown dtype, -3 for an unknown dim.
extern "C" int esdg_cns_viscous(int dtype, int dim, const void* const* in,
                                void* const* out, long long K, int np, int nq,
                                int nfq, double gamma, double mu, double lam,
                                double pr, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const esdg::ViscSizes sz{np, nq, nfq};
  if (dtype == 0)
    return esdg::dispatch_viscous<float>(dim, in, out, K, sz, gamma, mu, lam,
                                         pr, st);
  if (dtype == 1)
    return esdg::dispatch_viscous<double>(dim, in, out, K, sz, gamma, mu,
                                          lam, pr, st);
  return -2;
}
