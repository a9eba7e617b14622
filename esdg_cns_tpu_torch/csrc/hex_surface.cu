// K2: fused surface stage of the collocated-hex ES-DG Euler RHS.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_volume.py::_surface_kernel
// (wrapper euler_surface_pallas).  Per element and face point it computes
// the EC interface flux (Chandrashekar, logarithmic means) from the local
// traces and the gathered neighbour traces (rho, u, beta, log rho,
// log beta), contracted with the scaled normal; with dissipation, the LF
// penalty lfc = 0.25 max(lambda-, lambda+) sj with both sides'
// conservative states and wavespeeds rebuilt pointwise from the flux
// variables (p = rho / (2 beta)); then per element
//   dq = -(ph_qf + LIFT flux) (1/J)
// with the [Nq x Nfq] LIFT contraction in this kernel, over the six face
// points of each volume node's three lines (common.cuh's lift_lines: LIFT
// is zero elsewhere up to roundoff).
// Variants: DIAG (axis-aligned mesh) takes the compact one-row normal
// nxj [1, Nfq, K], derives sj = |nxj| and 1/sj in-kernel, takes the
// normal momentum from component d of face group d and inv_jac [1, K];
// the general variant takes nxj [3, Nfq, K], sj, 1/sj [Nfq, K] and
// inv_jac [Nq, K].
//
// What bounds it on this card: one two-point flux (five divisions, two
// logarithmic means) and two square roots per face point and 5 x 6
// LIFT multiply-adds per volume node; it streams traces and neighbour
// traces (2 x 88 MB in f32 at K=32768), the normal, ph_qf and the output
// (about 0.27 GB per RHS), and that HBM stream is its bound.
//
// Simple design: a block owns TE elements (threadIdx.x, so the K-last
// loads and stores coalesce) and 256 / TE workers; the workers first write
// the element's [5 x Nfq] interface flux to shared memory (123 KB per
// block in f64 at N=3), then each computes output nodes with the LIFT
// entries read through the read-only cache (the same address for all
// lanes of the element row).  TE is the largest of 32, 16, 8 whose tile
// fits in shared memory: in f32 32 up to N+1 = 7 and 16 at N+1 = 8; in
// f64 32 up to N+1 = 5, 16 at N+1 = 6 and 7 and 8 at N+1 = 8 (Nfq = 384).
// Lanes past K compute on a quiescent state and store
// nothing.  Folding the neighbour gather into this kernel (it could read
// the neighbour's traces from global memory directly) is later work.
#include "common.cuh"

namespace esdg {

constexpr int kSurfaceThreads = 256;

template <typename T, int N1>
struct SurfaceTile {
  static constexpr int NFQ = 6 * N1 * N1;
  static constexpr int TE = tile_elements<T>(0, size_t(5) * NFQ);
  static constexpr int NW = kSurfaceThreads / TE;
  static constexpr size_t SMEM = size_t(5) * NFQ * TE * sizeof(T);
  static_assert(SMEM <= kMaxSmem, "surface tile exceeds shared memory");
};

template <typename T>
__device__ __forceinline__ void conservative(const T* qv, T gm1, T u[5]) {
  // (rho, u, beta) -> (rho, m, E) with p = rho / (2 beta)
  const T rho = qv[0];
  const T u2norm = qv[1] * qv[1] + qv[2] * qv[2] + qv[3] * qv[3];
  u[0] = rho;
  u[1] = rho * qv[1];
  u[2] = rho * qv[2];
  u[3] = rho * qv[3];
  u[4] = rho / (T(2) * qv[4] * gm1) + T(0.5) * rho * u2norm;
}

template <typename T, int N1, bool DIAG>
__global__ void __launch_bounds__(kSurfaceThreads)
    hex_surface_kernel(const T* __restrict__ tr, const T* __restrict__ nbr,
                       const T* __restrict__ nxj, const T* __restrict__ sj,
                       const T* __restrict__ isj,
                       const T* __restrict__ inv_jac,
                       const T* __restrict__ lift,
                       const T* __restrict__ phqf, T* __restrict__ out,
                       long long K, double gamma, int dissipation) {
  using Tile = SurfaceTile<T, N1>;
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1, NFQ = Tile::NFQ;
  constexpr int TE = Tile::TE, NW = Tile::NW;
  const Consts<T> c(gamma);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sflux = reinterpret_cast<T*>(smem_raw);  // [5][NFQ][TE]
  const int e = threadIdx.x;
  const int w = threadIdx.y;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;

  for (int fp = w; fp < NFQ; fp += NW) {
    T qm[7] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0)};  // quiescent
    T qp[7] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0)};
    T n[3] = {T(1), T(0), T(0)};
    T sjv = T(1), isjv = T(1);
    const int d = fp / (2 * NFP);  // face group = normal direction
    if (live) {
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        qm[r] = tr[(long long)(r * NFQ + fp) * K + k];
        qp[r] = nbr[(long long)(r * NFQ + fp) * K + k];
      }
      if (DIAG) {
        n[0] = nxj[(long long)fp * K + k];
      } else {
#pragma unroll
        for (int x = 0; x < 3; ++x) n[x] = nxj[(long long)(x * NFQ + fp) * K + k];
        sjv = sj[(long long)fp * K + k];
        isjv = isj[(long long)fp * K + k];
      }
    }
    if (DIAG) {
      sjv = fabs(n[0]);  // = sqrt(nxj_d^2), exact
      isjv = T(1) / sjv;
    }
    const EcPairN<T, 3> p = ec_pair_n<T, 3>(qm, qp, c);
    T flux[5];
    if (DIAG) {
      T f[5];
      ec_dir_n<T, 3>(p, d, f);
#pragma unroll
      for (int i = 0; i < 5; ++i) flux[i] = f[i] * n[0];
    } else {
      T f0[5], f1[5], f2[5];
      ec_dir_n<T, 3>(p, 0, f0);
      ec_dir_n<T, 3>(p, 1, f1);
      ec_dir_n<T, 3>(p, 2, f2);
#pragma unroll
      for (int i = 0; i < 5; ++i)
        flux[i] = f0[i] * n[0] + f1[i] * n[1] + f2[i] * n[2];
    }
    if (dissipation) {
      T um[5], up[5];
      conservative(qm, c.gm1, um);
      conservative(qp, c.gm1, up);
      auto lam = [&](const T* u) {
        const T un = DIAG ? (pick<T, 3>(u + 1, d) * n[0]) * isjv
                          : (u[1] * n[0] + u[2] * n[1] + u[3] * n[2]) * isjv;
        const T pr = c.gm1 * (u[4] - (T(0.5) * un * un) / u[0]);
        return fabs(un / u[0]) + sqrt((c.gamma * pr) / u[0]);
      };
      const T lfc = (T(0.25) * fmax(lam(um), lam(up))) * sjv;
#pragma unroll
      for (int i = 0; i < 5; ++i) flux[i] = flux[i] - lfc * (up[i] - um[i]);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) sflux[(i * NFQ + fp) * TE + e] = flux[i];
  }
  __syncthreads();

  if (!live) return;  // no barrier below
  for (int i = w; i < NQ; i += NW) {
    T s[5] = {T(0), T(0), T(0), T(0), T(0)};
    lift_lines<T, N1>(
        lift, i,
        [&](int f, int fp) { return sflux[(f * NFQ + fp) * TE + e]; }, s);
    const T ij = DIAG ? inv_jac[k] : inv_jac[(long long)i * K + k];
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      const long long o = (long long)(f * NQ + i) * K + k;
      out[o] = -(phqf[o] + s[f]) * ij;
    }
  }
}

template <typename T, int N1, bool DIAG>
int launch_surface(const void* tr, const void* nbr, const void* nxj,
                   const void* sj, const void* isj, const void* inv_jac,
                   const void* lift, const void* phqf, void* out, long long K,
                   double gamma, int dissipation, cudaStream_t stream) {
  using Tile = SurfaceTile<T, N1>;
  auto kern = hex_surface_kernel<T, N1, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 block(Tile::TE, Tile::NW);
  const dim3 grid(unsigned((K + Tile::TE - 1) / Tile::TE));
  kern<<<grid, block, Tile::SMEM, stream>>>(
      static_cast<const T*>(tr), static_cast<const T*>(nbr),
      static_cast<const T*>(nxj), static_cast<const T*>(sj),
      static_cast<const T*>(isj), static_cast<const T*>(inv_jac),
      static_cast<const T*>(lift), static_cast<const T*>(phqf),
      static_cast<T*>(out), K, gamma, dissipation);
  return int(cudaGetLastError());
}

template <typename T, bool DIAG>
int dispatch_surface(int n1, const void* tr, const void* nbr,
                     const void* nxj, const void* sj, const void* isj,
                     const void* inv_jac, const void* lift, const void* phqf,
                     void* out, long long K, double gamma, int dissipation,
                     cudaStream_t stream) {
#define ESDG_SURFACE_CASE(N)                                              \
  case N:                                                                 \
    return launch_surface<T, N, DIAG>(tr, nbr, nxj, sj, isj, inv_jac,     \
                                      lift, phqf, out, K, gamma,          \
                                      dissipation, stream);
  switch (n1) {
    ESDG_SURFACE_CASE(2)
    ESDG_SURFACE_CASE(3)
    ESDG_SURFACE_CASE(4)
    ESDG_SURFACE_CASE(5)
    ESDG_SURFACE_CASE(6)
    ESDG_SURFACE_CASE(7)
    ESDG_SURFACE_CASE(8)
    default:
      return -1;
  }
#undef ESDG_SURFACE_CASE
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  In the diag variant sj and isj are
// not read (pass any pointer).  Returns cudaGetLastError() after the
// launch, -1 for an unsupported line length n1, -2 for an unknown dtype.
extern "C" int esdg_hex_surface(int dtype, int n1, int diag, int dissipation,
                                const void* tr, const void* nbr,
                                const void* nxj, const void* sj,
                                const void* isj, const void* inv_jac,
                                const void* lift, const void* phqf, void* out,
                                long long K, double gamma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return diag ? esdg::dispatch_surface<float, true>(
                      n1, tr, nbr, nxj, sj, isj, inv_jac, lift, phqf, out,
                      K, gamma, dissipation, st)
                : esdg::dispatch_surface<float, false>(
                      n1, tr, nbr, nxj, sj, isj, inv_jac, lift, phqf, out,
                      K, gamma, dissipation, st);
  }
  if (dtype == 1) {
    return diag ? esdg::dispatch_surface<double, true>(
                      n1, tr, nbr, nxj, sj, isj, inv_jac, lift, phqf, out,
                      K, gamma, dissipation, st)
                : esdg::dispatch_surface<double, false>(
                      n1, tr, nbr, nxj, sj, isj, inv_jac, lift, phqf, out,
                      K, gamma, dissipation, st);
  }
  return -2;
}
