// Shared device code of the kernels: the Chandrashekar entropy-
// conservative two-point flux with the stable logarithmic mean, in the
// evaluation order of esdg_cns_tpu/physics/euler.py (ec_flux_fields,
// _logmean_parts), in 1, 2 and 3 dimensions.
//
// Built without --use_fast_math: log, exp, pow, sqrt and division are the
// IEEE/libdevice versions, which the entropy identities need.
#pragma once

#include <cuda_runtime.h>

namespace esdg {

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
      T(1.0) + v * (T(1.0 / 12.0) + v * (T(1.0 / 80.0) + v / T(448.0)));
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

// EC flux along direction d: f = (f_rho, f_m1..DIM, f_E)
template <typename T, int DIM>
__device__ __forceinline__ void ec_dir_n(const EcPairN<T, DIM>& p, int d,
                                         T* f) {
  const T f1 = p.rholog * p.velavg[d];
  f[0] = f1;
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    f[1 + j] = (j == d) ? f1 * p.velavg[j] + p.pa : f1 * p.velavg[j];
  f[DIM + 1] = p.e_plus_p * p.velavg[d];
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
    T f0[5], f1[5], f2[5];
    ec_dir_n<T, 3>(p, 0, f0);
    ec_dir_n<T, 3>(p, 1, f1);
    ec_dir_n<T, 3>(p, 2, f2);
#pragma unroll
    for (int i = 0; i < 5; ++i)
      out[i] = g[0] * f0[i] + g[1] * f1[i] + g[2] * f2[i];
  }
}

// Largest tile of elements (32, 16, 8, 4, 2 or 1) whose shared memory,
// fixed + per_elem * te values of T, fits in a block.
template <typename T>
inline int tile_elements(size_t fixed, size_t per_elem) {
  constexpr size_t kMax = 232448;  // 227 KB usable per block on sm_90
  for (int te = 32; te >= 1; te /= 2)
    if ((fixed + per_elem * te) * sizeof(T) <= kMax) return te;
  return 0;
}

}  // namespace esdg
