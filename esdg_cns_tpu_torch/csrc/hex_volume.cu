// K1's entry point, with the line lengths N+1 = 2..4 instantiated here;
// the kernel is hex_volume.cuh, N+1 = 5, 6, 7, 8 are hex_volume5/6/7/8.cu.
#include "hex_volume.cuh"

namespace esdg {
#define ESDG_VOLUME_EXTERN(N)                                        \
  extern template int volume_order<N, false>(ESDG_VOLUME_ORDER_ARGS); \
  extern template int volume_order<N, true>(ESDG_VOLUME_ORDER_ARGS);
ESDG_VOLUME_EXTERN(5)
ESDG_VOLUME_EXTERN(6)
ESDG_VOLUME_EXTERN(7)
ESDG_VOLUME_EXTERN(8)
#undef ESDG_VOLUME_EXTERN
}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  geo [9, 1, K] (affine) or [9, Nh, K]
// (curved = 1).  with_v: the form that also stores v(U) into vout
// [5, Nq, K].  Returns cudaGetLastError() after the launch, -1 for an
// unsupported line length n1, -2 for an unknown dtype, -3 for diag on a
// curved metric.
static int hex_volume(int dtype, int n1, int diag, int curved, int with_v,
                      const void* q, const void* geo, const void* cvol,
                      const void* cface, const void* iw, const void* iwf,
                      const void* ef, const void* lift, void* out,
                      void* traces, void* vout, long long K, double gamma,
                      void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -2;
  if (diag && curved) return -3;
#define ESDG_VOLUME_CASE(N)                                                 \
  case N:                                                                   \
    return with_v ? esdg::volume_order<N, true>(                            \
                        dtype, diag, curved, q, geo, cvol, cface, iw, iwf,  \
                        ef, lift, out, traces, vout, K, gamma, st, occ)     \
                  : esdg::volume_order<N, false>(                           \
                        dtype, diag, curved, q, geo, cvol, cface, iw, iwf,  \
                        ef, lift, out, traces, vout, K, gamma, st, occ);
  switch (n1) {
    ESDG_VOLUME_CASE(2)
    ESDG_VOLUME_CASE(3)
    ESDG_VOLUME_CASE(4)
    ESDG_VOLUME_CASE(5)
    ESDG_VOLUME_CASE(6)
    ESDG_VOLUME_CASE(7)
    ESDG_VOLUME_CASE(8)
    default:
      return -1;
  }
#undef ESDG_VOLUME_CASE
}

// vout: v(U) [5, Nq, K], or null for none (the form without the store).
extern "C" int esdg_hex_volume(int dtype, int n1, int diag, int curved,
                               const void* q, const void* geo,
                               const void* cvol, const void* cface,
                               const void* iw, const void* iwf,
                               const void* ef, const void* lift, void* out,
                               void* traces, void* vout, long long K,
                               double gamma, void* stream) {
  return hex_volume(dtype, n1, diag, curved, vout != nullptr, q, geo, cvol,
                    cface, iw, iwf, ef, lift, out, traces, vout, K, gamma,
                    stream, nullptr);
}

// The launch shape of one form (common.cuh's launch_shape: occ[7] =
// resident blocks per SM, threads per block, shared memory bytes,
// registers, local bytes per thread, elements per block, 0); returns as
// esdg_hex_volume.
extern "C" int esdg_hex_volume_shape(int dtype, int n1, int diag, int curved,
                                     int with_v, int* occ) {
  return hex_volume(dtype, n1, diag, curved, with_v, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, 0, 1.4, nullptr, occ);
}
