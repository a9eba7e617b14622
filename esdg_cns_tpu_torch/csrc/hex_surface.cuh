// K2: fused surface stage of the collocated-hex ES-DG Euler RHS.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_volume.py::_surface_kernel
// (wrapper euler_surface_pallas).  Per element and face point it computes
// the EC interface flux (Chandrashekar, logarithmic means) from the local
// traces and the neighbour's (rho, u, beta, log rho, log beta),
// contracted with the scaled normal; with dissipation, the LF penalty
// lfc = 0.25 max(lambda-, lambda+) sj with both sides' conservative states
// and wavespeeds rebuilt pointwise from the flux variables
// (p = rho / (2 beta)); then per element
//   dq = -(ph_qf + LIFT flux) (1/J)
// with the [Nq x Nfq] LIFT contraction in this kernel, over the six face
// points of each volume node's three lines (common.cuh's lift_lines: LIFT
// is zero elsewhere up to roundoff).
//
// Forms (template flags):
//   DIAG   axis-aligned mesh: the compact one-row normal nxj [1, Nfq, K],
//          sj = |nxj| and 1/sj derived in-kernel, the normal momentum from
//          component d of face group d, inv_jac [1, K]; otherwise nxj
//          [3, Nfq, K], sj, 1/sj [Nfq, K] and inv_jac [Nq, K] (affine or
//          curved);
//   GRID   fully periodic uniform grid (kz, ky, kx), element
//          k = x + kx (y + ky z): the neighbour across face 2d is face
//          2d+1 of element k - s_d (face 2d+1: face 2d of k + s_d), at the
//          same face-local index, wrapped at the grid's ends, with
//          s = (1, kx, kx ky); the kernel reads its traces from the traces
//          array itself (the exchange's rolls, core/discretization.py's
//          grid_neighbours, leave the stage).  Otherwise it reads the
//          gathered neighbour traces nbr [7, Nfq, K];
//   SPLIT  the split volume path's three direction parts
//          part_d [5, Nq + 2 Nfp, K] (hex_fd_dir: the volume rows, then the
//          face rows of faces 2d and 2d+1) in place of ph_qf: the split
//          combine, ph_qf = 2 (1/wq) sum_d vol_d + 2 LIFT ((1/wf) face_d),
//          is linear, so its face term rides this kernel's LIFT:
//            dq = -(2 (1/wq) sum_d vol_d + LIFT (flux + 2 (1/wf) face))/J.
//
// What bounds it on this card: one two-point flux (five divisions, two
// logarithmic means) and two square roots per face point and 5 x 6
// LIFT multiply-adds per volume node; it streams the traces (the
// neighbours' are the same array in the GRID form), the normal, ph_qf or
// the three parts and the output, and that HBM stream is its bound.
//
// Every input is read through the read-only path (__ldg; the arguments
// travel in a struct, which carries no __restrict__), and the volume
// term's five values are loaded before the first store: at N+1 = 4 in
// f32 plain loads took 1.2x the time (PERF.md §6).
//
// Design: a block owns TE elements and THREADS threads; a thread maps
// t -> (element t % TE, point t / TE) (THREADS is a multiple of TE, so a
// thread keeps one element), once over the face points, writing the
// element's [5 x Nfq] interface flux to shared memory, and once over the
// volume nodes for the LIFT.  A warp's K-last loads and stores cover TE
// consecutive elements: TE values of 32 bytes, one sector, where the
// shared memory allows.  The tile per type and N+1 (surface_tile) was
// timed on the card against its neighbours (PERF.md §6).  Lanes past K
// compute on a quiescent state and store nothing.  This header holds the
// kernel; hex_surface.cu the entry with N+1 = 2..5, and
// hex_surface6/7/8.cu one larger line length each, so that nvcc builds
// them in parallel.
#pragma once

#include "common.cuh"

namespace esdg {

// K2's tile at each type and line length, timed on the card against its
// neighbours (probes/tiles.py; PERF.md §6): in f32 the widest element
// runs and the most threads won at every N+1 timed (4..8), at 32 warps an
// SM; in f64 (N+1 = 4 and 8 timed) 16 warps without spills beat 32 with
// them.  At N+1 = 2, 3 and f64 5..7 untimed, the neighbours'.
template <typename T, int N1>
constexpr TileShape surface_tile() {
  if (sizeof(T) == 4)
    return N1 <= 5   ? TileShape{32, 512, 2}
           : N1 <= 7 ? TileShape{32, 1024, 1}
                     : TileShape{16, 1024, 1};
  return N1 <= 5 ? TileShape{16, 256, 1} : TileShape{8, 512, 1};
}

// The kernel's pointers; unread ones may be null (DIAG: sj, isj; GRID:
// nbr; SPLIT: phqf; otherwise part, iw, iwf).
template <typename T>
struct SurfaceArgs {
  const T* tr;       // [7, Nfq, K]
  const T* nbr;      // [7, Nfq, K]
  const T* nxj;      // [1 | 3, Nfq, K]
  const T* sj;       // [Nfq, K]
  const T* isj;      // [Nfq, K]
  const T* inv_jac;  // [1 | Nq, K]
  const T* lift;     // [Nq, Nfq]
  const T* phqf;     // [5, Nq, K]
  const T* part[3];  // [5, Nq + 2 Nfp, K] each
  const T* iw;       // [Nq]
  const T* iwf;      // [Nfp]
  T* out;            // [5, Nq, K]
  int kx, ky, kz;    // the grid (GRID)
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

// The face point's interface flux: EC flux contracted with the normal,
// minus the LF penalty with dissipation.
template <typename T, bool DIAG>
__device__ __forceinline__ void interface_flux(const T qm[7], const T qp[7],
                                               const T n[3], T sjv, T isjv,
                                               int d, int dissipation,
                                               const Consts<T>& c,
                                               T flux[5]) {
  const EcPairN<T, 3> p = ec_pair_n<T, 3>(qm, qp, c);
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
}

template <typename T, int N1, int TE, int THREADS, int MIN_BLOCKS, bool DIAG,
          bool GRID, bool SPLIT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    hex_surface_kernel(const SurfaceArgs<T> a, long long K, double gamma,
                       int dissipation) {
  static_assert(THREADS % TE == 0, "a thread keeps one element");
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1, NFQ = 6 * NFP;
  constexpr int NP = NQ + 2 * NFP;  // rows of a split part
  const Consts<T> c(gamma);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sflux = reinterpret_cast<T*>(smem_raw);  // [5][NFQ][TE]
  const int e = threadIdx.x % TE;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;
  // the element's grid coordinates (GRID)
  int coord[3] = {0, 0, 0};
  if (GRID && live) {
    const int kk = int(k);
    coord[0] = kk % a.kx;
    coord[1] = (kk / a.kx) % a.ky;
    coord[2] = kk / (a.kx * a.ky);
  }

  for (int fp = threadIdx.x / TE; fp < NFQ; fp += THREADS / TE) {
    T qm[7] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0)};  // quiescent
    T qp[7] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0)};
    T n[3] = {T(1), T(0), T(0)};
    T sjv = T(1), isjv = T(1);
    const int face = fp / NFP;
    const int d = face >> 1;  // face group = normal direction
    if (live) {
      const T* src = a.nbr;
      long long kn = k;
      int fpn = fp;
      if (GRID) {
        // face 2d: face 2d+1 of k - s_d; face 2d+1: face 2d of k + s_d
        const int side = face & 1;
        const int cd = d == 0 ? coord[0] : (d == 1 ? coord[1] : coord[2]);
        const int period = d == 0 ? a.kx : (d == 1 ? a.ky : a.kz);
        const int stride = d == 0 ? 1 : (d == 1 ? a.kx : a.kx * a.ky);
        int shift = side ? stride : -stride;
        if (side ? cd == period - 1 : cd == 0)
          shift += side ? -period * stride : period * stride;
        kn = k + shift;
        fpn = side ? fp - NFP : fp + NFP;
        src = a.tr;
      }
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        qm[r] = __ldg(a.tr + (long long)(r * NFQ + fp) * K + k);
        qp[r] = __ldg(src + (long long)(r * NFQ + fpn) * K + kn);
      }
      if (DIAG) {
        n[0] = __ldg(a.nxj + (long long)fp * K + k);
      } else {
#pragma unroll
        for (int x = 0; x < 3; ++x)
          n[x] = __ldg(a.nxj + (long long)(x * NFQ + fp) * K + k);
        sjv = __ldg(a.sj + (long long)fp * K + k);
        isjv = __ldg(a.isj + (long long)fp * K + k);
      }
    }
    if (DIAG) {
      sjv = fabs(n[0]);  // = sqrt(nxj_d^2), exact
      isjv = T(1) / sjv;
    }
    T flux[5];
    interface_flux<T, DIAG>(qm, qp, n, sjv, isjv, d, dissipation, c, flux);
    if (SPLIT && live) {
      // + 2 (1/wf) (face rows of part d): the combine's face term
      const T* pd = d == 0 ? a.part[0] : (d == 1 ? a.part[1] : a.part[2]);
      const T w2 = T(2) * __ldg(a.iwf + fp % NFP);
      const int row = NQ + fp - 2 * d * NFP;
#pragma unroll
      for (int i = 0; i < 5; ++i)
        flux[i] += w2 * __ldg(pd + (long long)(i * NP + row) * K + k);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) sflux[(i * NFQ + fp) * TE + e] = flux[i];
  }
  __syncthreads();

  if (!live) return;  // no barrier below
  for (int i = threadIdx.x / TE; i < NQ; i += THREADS / TE) {
    T s[5] = {T(0), T(0), T(0), T(0), T(0)};
    lift_lines<T, N1>(
        a.lift, i,
        [&](int f, int fp) { return sflux[(f * NFQ + fp) * TE + e]; }, s);
    const T ij = __ldg(a.inv_jac + (DIAG ? k : (long long)i * K + k));
    // the volume term's five values, all loaded before the first store
    T vol[5];
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      if (SPLIT) {
        const long long o = (long long)(f * NP + i) * K + k;
        vol[f] = T(2) * __ldg(a.iw + i) *
                 ((__ldg(a.part[0] + o) + __ldg(a.part[1] + o)) +
                  __ldg(a.part[2] + o));
      } else {
        vol[f] = __ldg(a.phqf + (long long)(f * NQ + i) * K + k);
      }
    }
#pragma unroll
    for (int f = 0; f < 5; ++f)
      a.out[(long long)(f * NQ + i) * K + k] = -(vol[f] + s[f]) * ij;
  }
}

// One form at one tile: launches, or with occ fills its launch shape
// (common.cuh's launch_shape; occ[6] = MIN_BLOCKS).  Returns a CUDA error
// code.
template <typename T, int N1, bool DIAG, bool GRID, bool SPLIT, int TE,
          int THREADS, int MIN_BLOCKS>
int launch_surface_tile(const SurfaceArgs<T>& a, long long K, double gamma,
                        int dissipation, cudaStream_t stream, int* occ) {
  constexpr size_t SMEM = size_t(5) * 6 * N1 * N1 * TE * sizeof(T);
  static_assert(SMEM <= kMaxSmem, "surface tile exceeds shared memory");
  auto kern =
      hex_surface_kernel<T, N1, TE, THREADS, MIN_BLOCKS, DIAG, GRID, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr) {
    const int rc = launch_shape(kern, THREADS, SMEM, TE, occ);
    occ[6] = MIN_BLOCKS;
    return rc;
  }
  const dim3 grid(unsigned((K + TE - 1) / TE));
  kern<<<grid, THREADS, SMEM, stream>>>(a, K, gamma, dissipation);
  return int(cudaGetLastError());
}

template <typename T, int N1, bool DIAG, bool GRID, bool SPLIT>
int launch_surface(const SurfaceArgs<T>& a, long long K, double gamma,
                   int dissipation, cudaStream_t stream, int* occ) {
  constexpr TileShape t = surface_tile<T, N1>();
  return launch_surface_tile<T, N1, DIAG, GRID, SPLIT, t.te, t.threads,
                             t.min_blocks>(a, K, gamma, dissipation, stream,
                                           occ);
}

// One line length N1 of K2, every form of one type.
template <typename T, int N1>
int surface_forms(int diag, int grid, int split, const SurfaceArgs<T>& a,
                  long long K, double gamma, int dissipation,
                  cudaStream_t stream, int* occ) {
#define ESDG_SURFACE_FORM(D, G, S)                                         \
  if (diag == D && grid == G && split == S)                                \
    return launch_surface<T, N1, D, G, S>(a, K, gamma, dissipation, stream, \
                                          occ);
  ESDG_SURFACE_FORM(true, true, false)
  ESDG_SURFACE_FORM(true, true, true)
  ESDG_SURFACE_FORM(true, false, false)
  ESDG_SURFACE_FORM(true, false, true)
  ESDG_SURFACE_FORM(false, true, false)
  ESDG_SURFACE_FORM(false, true, true)
  ESDG_SURFACE_FORM(false, false, false)
  ESDG_SURFACE_FORM(false, false, true)
#undef ESDG_SURFACE_FORM
  return -3;
}

// The pointer array of the C entry (tr, nbr, nxj, sj, isj, inv_jac, lift,
// phqf, part0, part1, part2, iw, iwf, out) and the grid (kx, ky, kz) as
// the kernel's arguments; null ptrs (a shape query) give null pointers.
template <typename T>
SurfaceArgs<T> surface_args(const void* const* ptrs, const int* dims) {
  SurfaceArgs<T> a{};
  if (ptrs == nullptr) return a;
  auto p = [&](int i) { return static_cast<const T*>(ptrs[i]); };
  a.tr = p(0);
  a.nbr = p(1);
  a.nxj = p(2);
  a.sj = p(3);
  a.isj = p(4);
  a.inv_jac = p(5);
  a.lift = p(6);
  a.phqf = p(7);
  for (int d = 0; d < 3; ++d) a.part[d] = p(8 + d);
  a.iw = p(11);
  a.iwf = p(12);
  a.out = const_cast<T*>(p(13));
  a.kx = dims[0];
  a.ky = dims[1];
  a.kz = dims[2];
  return a;
}

// One line length N1 of K2 for both types; returns as esdg_hex_surface.
// hex_surface.cu instantiates N1 = 2..5, hex_surface<N1>.cu the larger.
template <int N1>
int surface_order(int dtype, int diag, int grid, int split,
                  const void* const* ptrs, const int* dims, long long K,
                  double gamma, int dissipation, cudaStream_t stream,
                  int* occ) {
  if (dtype == 0)
    return surface_forms<float, N1>(diag, grid, split,
                                    surface_args<float>(ptrs, dims), K, gamma,
                                    dissipation, stream, occ);
  if (dtype == 1)
    return surface_forms<double, N1>(diag, grid, split,
                                     surface_args<double>(ptrs, dims), K,
                                     gamma, dissipation, stream, occ);
  return -2;
}

#define ESDG_SURFACE_ORDER_ARGS                                             \
  int, int, int, int, const void* const*, const int*, long long, double,   \
      int, cudaStream_t, int*

}  // namespace esdg
