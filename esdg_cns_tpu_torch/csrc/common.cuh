// Shared device code of the hex Euler kernels: the Chandrashekar
// entropy-conservative two-point flux with the stable logarithmic mean,
// in the evaluation order of esdg_cns_tpu/physics/euler.py
// (ec_flux_fields, _logmean_parts).
//
// Flux variables of one point are held as T v[7] =
//   (rho, u1, u2, u3, beta, log rho, log beta),
// the row order of the trace arrays.
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

// Direction-independent part of the EC flux of the pair (L, R).
template <typename T>
struct EcPair {
  T rholog, pa, e_plus_p, velavg[3];
};

template <typename T>
__device__ __forceinline__ EcPair<T> ec_pair(const T* L, const T* R,
                                             const Consts<T>& c) {
  EcPair<T> p;
  T num, den;
  logmean_parts(L[0], R[0], L[5], R[5], c.cutoff, num, den);
  p.rholog = num / den;
  // beta's logarithmic mean enters only through its reciprocal
  logmean_parts(L[4], R[4], L[6], R[6], c.cutoff, num, den);
  const T inv_betalog = den / num;
  const T rhoavg = T(0.5) * (L[0] + R[0]);
#pragma unroll
  for (int j = 0; j < 3; ++j) p.velavg[j] = T(0.5) * (L[1 + j] + R[1 + j]);
  const T vel_dot = L[1] * R[1] + L[2] * R[2] + L[3] * R[3];
  p.pa = rhoavg / (L[4] + R[4]);
  p.e_plus_p = (p.rholog * inv_betalog) * c.half_over_gm1 + p.pa +
               T(0.5) * p.rholog * vel_dot;
  return p;
}

// EC flux along direction d: f = (f_rho, f_m1, f_m2, f_m3, f_E).
template <typename T>
__device__ __forceinline__ void ec_dir(const EcPair<T>& p, int d, T f[5]) {
  const T f1 = p.rholog * p.velavg[d];
  f[0] = f1;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    f[1 + j] = (j == d) ? f1 * p.velavg[j] + p.pa : f1 * p.velavg[j];
  f[4] = p.e_plus_p * p.velavg[d];
}

// Metric-contracted EC flux sum_x g[x] F_x(L, R).  DIAG: axis-aligned
// mesh, only direction d's flux with the single metric term g[0].
template <typename T, bool DIAG>
__device__ __forceinline__ void contracted_flux(const T* L, const T* R,
                                                int d, const T g[3],
                                                const Consts<T>& c,
                                                T out[5]) {
  const EcPair<T> p = ec_pair(L, R, c);
  if (DIAG) {
    T f[5];
    ec_dir(p, d, f);
#pragma unroll
    for (int i = 0; i < 5; ++i) out[i] = g[0] * f[i];
  } else {
    T f0[5], f1[5], f2[5];
    ec_dir(p, 0, f0);
    ec_dir(p, 1, f1);
    ec_dir(p, 2, f2);
#pragma unroll
    for (int i = 0; i < 5; ++i)
      out[i] = g[0] * f0[i] + g[1] * f1[i] + g[2] * f2[i];
  }
}

// The same flux in 2D (the CNS tri kernels): one point is held as
// T v[6] = (rho, u1, u2, beta, log rho, log beta).
template <typename T>
struct EcPair2 {
  T rholog, pa, e_plus_p, velavg[2];
};

template <typename T>
__device__ __forceinline__ EcPair2<T> ec_pair2(const T* L, const T* R,
                                               const Consts<T>& c) {
  EcPair2<T> p;
  T num, den;
  logmean_parts(L[0], R[0], L[4], R[4], c.cutoff, num, den);
  p.rholog = num / den;
  logmean_parts(L[3], R[3], L[5], R[5], c.cutoff, num, den);
  const T inv_betalog = den / num;
  const T rhoavg = T(0.5) * (L[0] + R[0]);
  p.velavg[0] = T(0.5) * (L[1] + R[1]);
  p.velavg[1] = T(0.5) * (L[2] + R[2]);
  const T vel_dot = L[1] * R[1] + L[2] * R[2];
  p.pa = rhoavg / (L[3] + R[3]);
  p.e_plus_p = (p.rholog * inv_betalog) * c.half_over_gm1 + p.pa +
               T(0.5) * p.rholog * vel_dot;
  return p;
}

// 2D EC flux along direction d: f = (f_rho, f_m1, f_m2, f_E).
template <typename T>
__device__ __forceinline__ void ec_dir2(const EcPair2<T>& p, int d, T f[4]) {
  const T f1 = p.rholog * p.velavg[d];
  f[0] = f1;
  f[1] = (d == 0) ? f1 * p.velavg[0] + p.pa : f1 * p.velavg[0];
  f[2] = (d == 1) ? f1 * p.velavg[1] + p.pa : f1 * p.velavg[1];
  f[3] = p.e_plus_p * p.velavg[d];
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
