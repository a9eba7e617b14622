// Shared device code of the kernels: the Chandrashekar entropy-
// conservative two-point flux with the stable logarithmic mean, in the
// evaluation order of esdg_cns_tpu/physics/euler.py (ec_flux_fields,
// _logmean_parts), in 1, 2 and 3 dimensions.
//
// Built without --use_fast_math: log, exp, pow, sqrt and division are the
// IEEE/libdevice versions, which the entropy identities need.
//
// Two rewrites lighten the pair body that K1, K3, K5 and the split and
// line kernels share (the function is unchanged; the roundoff is not):
//   * the series term v / 448 of each logarithmic mean is v * (1/448),
//     the reciprocal rounded once from double: two of the pair's seven
//     IEEE divisions, each about 14.5 FMA issue slots on the H100 (PERF.md
//     §6, row 12), and with them the divider's slow path that a zero v
//     (equal states: a fluid at rest) takes;
//   * the metric-contracted flux sum_x g_x F_x is formed from the
//     contracted velocity vn = sum_x g_x u_x (ec_contract): 5 + DIM
//     multiply-adds for the whole sum where forming each directional
//     flux and contracting took 5 DIM + 5 (DIM - 1) more.  It is the same
//     sum in another order, symmetric in (L, R) as the flux is, so the
//     entropy identities hold to roundoff.
// Their effect on each kernel's time is in PERF.md §6.
#pragma once

#include <cuda_runtime.h>

namespace esdg {

constexpr size_t kMaxSmem = 232448;  // 227 KB usable per block on sm_90

// the line lengths the split volume path builds: N = 1..7
#define ESDG_SPLIT_N1(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// Scalar constants derived from gamma in double and rounded once to T,
// as the reference does with its Python-float constants.
template <typename T>
struct Consts {
  T gamma, gm1, gamma_p1, inv_gm1, half_over_gm1, cutoff;
  __host__ __device__ explicit Consts(double g)
      : gamma(T(g)),
        gm1(T(g - 1.0)),
        gamma_p1(T(g + 1.0)),
        inv_gm1(T(1.0 / (g - 1.0))),
        half_over_gm1(T(0.5 / (g - 1.0))),
        // series/exact switch of the logarithmic mean: (1e-2)^2 in f64,
        // (1e-1)^2 in f32
        cutoff(sizeof(T) == 8 ? T(1e-2 * 1e-2) : T(1e-1 * 1e-1)) {}
};

// (numerator, denominator) of the logarithmic mean; the select happens
// before the single division, so aL == aR never forms 0/0.
template <typename T>
__device__ __forceinline__ void logmean_parts(T al, T ar, T logl, T logr,
                                              T cutoff, T& num, T& den) {
  const T da = ar - al;
  const T aavg = T(0.5) * (ar + al);
  const T v = (da * da) / (aavg * aavg);
  const bool series = v < cutoff;
  const T poly =
      T(1.0) + v * (T(1.0 / 12.0) + v * (T(1.0 / 80.0) + v * T(1.0 / 448.0)));
  num = series ? aavg : da;
  den = series ? poly : (logr - logl);
}

// The EC flux of the pair (L, R) in DIM dimensions; one point is held as
// T v[DIM + 4] = (rho, u_1..DIM, beta, log rho, log beta), the row order
// of the trace arrays.  ec_pair_n forms the direction-independent part,
// ec_dir_n the flux along one direction.
template <typename T, int DIM>
struct EcPairN {
  T rholog, pa, e_plus_p, velavg[DIM];
};

template <typename T, int DIM>
__device__ __forceinline__ EcPairN<T, DIM> ec_pair_n(const T* L, const T* R,
                                                     const Consts<T>& c) {
  EcPairN<T, DIM> p;
  T num, den;
  logmean_parts(L[0], R[0], L[DIM + 2], R[DIM + 2], c.cutoff, num, den);
  p.rholog = num / den;
  // beta's logarithmic mean enters only through its reciprocal
  logmean_parts(L[DIM + 1], R[DIM + 1], L[DIM + 3], R[DIM + 3], c.cutoff,
                num, den);
  const T inv_betalog = den / num;
  const T rhoavg = T(0.5) * (L[0] + R[0]);
#pragma unroll
  for (int j = 0; j < DIM; ++j) p.velavg[j] = T(0.5) * (L[1 + j] + R[1 + j]);
  T vel_dot = L[1] * R[1];
#pragma unroll
  for (int j = 1; j < DIM; ++j) vel_dot = vel_dot + L[1 + j] * R[1 + j];
  p.pa = rhoavg / (L[DIM + 1] + R[DIM + 1]);
  p.e_plus_p = (p.rholog * inv_betalog) * c.half_over_gm1 + p.pa +
               T(0.5) * p.rholog * vel_dot;
  return p;
}

// v[d] by selects, so a d known only at run time indexes no register
// array (which would put it in local memory)
template <typename T, int DIM>
__device__ __forceinline__ T pick(const T* v, int d) {
  T x = v[0];
#pragma unroll
  for (int j = 1; j < DIM; ++j) x = (j == d) ? v[j] : x;
  return x;
}

// EC flux along direction d: f = (f_rho, f_m1..DIM, f_E)
template <typename T, int DIM>
__device__ __forceinline__ void ec_dir_n(const EcPairN<T, DIM>& p, int d,
                                         T* f) {
  const T vd = pick<T, DIM>(p.velavg, d);
  const T f1 = p.rholog * vd;
  f[0] = f1;
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    f[1 + j] = (j == d) ? f1 * p.velavg[j] + p.pa : f1 * p.velavg[j];
  f[DIM + 1] = p.e_plus_p * vd;
}

// sum_x g[x] F_x of one pair in DIM dimensions: with vn = sum_x g_x u_x,
// (rholog vn, rholog vn u_j + g_j pa, (e + p) vn).
template <typename T, int DIM>
__device__ __forceinline__ void ec_contract(const EcPairN<T, DIM>& p,
                                            const T* g, T* out) {
  T vn = g[0] * p.velavg[0];
#pragma unroll
  for (int x = 1; x < DIM; ++x) vn = vn + g[x] * p.velavg[x];
  const T f1 = p.rholog * vn;
  out[0] = f1;
#pragma unroll
  for (int j = 0; j < DIM; ++j) out[1 + j] = f1 * p.velavg[j] + g[j] * p.pa;
  out[DIM + 1] = p.e_plus_p * vn;
}

// Metric-contracted 3D EC flux sum_x g[x] F_x(L, R).  DIAG: axis-aligned
// mesh, only direction d's flux with the single metric term g[0].
template <typename T, bool DIAG>
__device__ __forceinline__ void contracted_flux(const T* L, const T* R,
                                                int d, const T g[3],
                                                const Consts<T>& c,
                                                T out[5]) {
  const EcPairN<T, 3> p = ec_pair_n<T, 3>(L, R, c);
  if (DIAG) {
    T f[5];
    ec_dir_n<T, 3>(p, d, f);
#pragma unroll
    for (int i = 0; i < 5; ++i) out[i] = g[0] * f[i];
  } else {
    ec_contract<T, 3>(p, g, out);
  }
}

// The node lines of the Gauss-collocated hex, volume node
// i = a0 + N1 a1 + N1^2 a2: line L of direction d holds the volume nodes
// line_base(d, L) + a line_stride(d), a = 0..N1-1, and pierces face point
// L of faces 2d and 2d+1 (face point (2d + side) N1^2 + L).  Ef and LIFT
// touch nothing else: row fp of Ef and column fp of LIFT are zero off the
// line of face point fp, up to the roundoff of the 1D interpolation.
template <int N1>
__device__ __forceinline__ int line_stride(int d) {
  return d == 0 ? 1 : (d == 1 ? N1 : N1 * N1);
}
template <int N1>
__device__ __forceinline__ int line_base(int d, int L) {
  return d == 0 ? N1 * L : (d == 1 ? (L % N1) + N1 * N1 * (L / N1) : L);
}
// the line of direction d through volume node i
template <int N1>
__device__ __forceinline__ int node_line(int d, int i) {
  return d == 0 ? i / N1
                : (d == 1 ? (i % N1) + N1 * (i / (N1 * N1)) : i % (N1 * N1));
}

// s[f] += sum_j Ef[fp, j] v(f, j) over the N1 volume nodes of face point
// fp's line: Ef v at one face point (ef [Nfq, Nq]).
template <typename T, int N1, typename V>
__device__ __forceinline__ void ef_line(const T* __restrict__ ef, int fp,
                                        V v, T s[5]) {
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1;
  const int d = fp / (2 * NFP), L = fp % NFP;
  const int base = line_base<N1>(d, L), stride = line_stride<N1>(d);
  const T* erow = ef + fp * NQ;
#pragma unroll
  for (int a = 0; a < N1; ++a) {
    const int j = base + a * stride;
    const T e = __ldg(erow + j);
#pragma unroll
    for (int f = 0; f < 5; ++f) s[f] += e * v(f, j);
  }
}

// s[f] += sum_fp LIFT[i, fp] x(f, fp) over the six face points of volume
// node i's three lines: LIFT x at one volume node (lift [Nq, Nfq]).
template <typename T, int N1, typename X>
__device__ __forceinline__ void lift_lines(const T* __restrict__ lift, int i,
                                           X x, T s[5]) {
  constexpr int NFP = N1 * N1, NFQ = 6 * NFP;
  const T* lrow = lift + i * NFQ;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int L = node_line<N1>(d, i);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int fp = (2 * d + side) * NFP + L;
      const T a = __ldg(lrow + fp);
#pragma unroll
      for (int f = 0; f < 5; ++f) s[f] += a * x(f, fp);
    }
  }
}

// A kernel's launch shape on this card (the kernels' occ argument, when
// not null, receives it instead of a launch):
// {resident blocks per SM, threads per block, dynamic shared memory bytes,
// registers per thread, local (spill) bytes per thread, elements per
// block, a flag of the kernel's own (0 here)}.
template <typename Kern>
int launch_shape(Kern kern, int threads, size_t smem, int te, int* occ) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, threads, smem);
  if (err != cudaSuccess) return int(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return int(err);
  occ[0] = blocks;
  occ[1] = threads;
  occ[2] = int(smem);
  occ[3] = attr.numRegs;
  occ[4] = int(attr.localSizeBytes);
  occ[5] = te;
  occ[6] = 0;
  return 0;
}

// A kernel's tile: {elements a block, threads a block, blocks resident an
// SM asked of __launch_bounds__ (its register cap)}
struct TileShape {
  int te, threads, min_blocks;
};

// Largest tile of elements (32, 16, 8, 4, 2 or 1) whose shared memory,
// fixed + per_elem * te values of T, fits in a block.
template <typename T>
constexpr int tile_elements(size_t fixed, size_t per_elem) {
  for (int te = 32; te >= 1; te /= 2)
    if ((fixed + per_elem * te) * sizeof(T) <= kMaxSmem) return te;
  return 0;
}

}  // namespace esdg
