// The split volume path of the collocated-hex ES-DG Euler RHS: a
// projection kernel (hex_project.cuh), one flux-differencing kernel per
// direction (hex_split.cuh, instantiated in hex_fd_dir0..2.cu) and a
// combine, in place of K1's all-in-one volume kernel: the TPU package's
// 'split' volume modes, which its 'auto' takes at N = 7.  This file holds
// the entry points of both kernels and the projection's tiles.
//
// hex_project_kernel replaces _proj_kernel (row 3) of
// esdg_cns_tpu/ops/pallas_volume.py, behind euler_volume_split_pallas:
// the entropy projection of hex_project.cuh (shared with K1) writes the
// flux variables qh [5, Nh, K] = (rho, u1, u2, u3, beta), qlog [2, Nh, K]
// = (log rho, log beta) at all Nh = Nq + Nfq points and the 7-row face
// traces [7, Nfq, K] (K1's trace contract).  The combine (the three
// volume parts summed, 2 (1/wq) acc, the 1/wf face scaling and
// 2 LIFT qf_face) is plain tensor code for euler_volume_split's callers,
// as the TPU package leaves it to XLA; the fused Euler RHS hands the
// three parts to K2 instead, which folds the combine into its LIFT
// (hex_surface.cuh, SPLIT).
//
// What bounds it on this card: at N=7, K=4096 it reads q (42 MB in f32)
// and writes qh and qlog (103 MB) and the traces (44 MB); Ef v over each
// face point's line is 5 x 384 x 8 multiply-adds per element, and v(U),
// U(v_f) a few logarithms, powers and divisions per point, so the HBM
// stream is its bound.
//
// Design: K1's mapping.  A block of THREADS threads owns TE elements and
// maps t -> (element t % TE, point t / TE): v(U) at the volume nodes of
// the tile, [5][Nq][TE], is its only shared memory (hex_project.cuh's
// entropy_project).  The old tile, 16 elements a block of 16 x 16
// workers, held one block, 8 warps, an SM at N+1 = 8 in f32; this one,
// 16 elements and 1024 threads, holds 32.  A warp's K-last loads and
// stores cover TE consecutive elements: 64 bytes and more in f32.  On
// the card narrower runs cost most: 16-byte runs (TE = 4) took 3.7-5.4x
// the time of the best tile at N+1 = 5..8, at the same warps.  The tile
// per type and N+1 (project_tile) was timed against its neighbours
// (PERF.md §6).  Lanes past K compute on the quiescent state and store
// nothing.
#include "hex_project.cuh"
#include "hex_split.cuh"

namespace esdg {

// The projection's tile at each type and line length, timed on the card
// against its neighbours (probes/tiles.py; PERF.md §6): at N+1 = 5..8 in
// f32 and 8 in f64; the others untimed, the neighbours'.
template <typename T, int N1>
constexpr TileShape project_tile() {
  if (sizeof(T) == 4)
    return N1 <= 3   ? TileShape{32, 256, 1}
           : N1 <= 5 ? TileShape{16, 512, 1}
           : N1 <= 7 ? TileShape{32, 1024, 1}
                     : TileShape{16, 1024, 1};
  return N1 <= 3   ? TileShape{16, 256, 1}
         : N1 <= 5 ? TileShape{16, 1024, 1}
                   : TileShape{8, 1024, 1};
}

template <typename T, int N1>
int launch_project(const void* q, const void* ef, void* qh, void* qlog,
                   void* traces, long long K, double gamma,
                   cudaStream_t stream, int* occ) {
  constexpr TileShape t = project_tile<T, N1>();
  return launch_project_tile<T, N1, t.te, t.threads, t.min_blocks>(
      q, ef, qh, qlog, traces, K, gamma, stream, occ);
}

template <typename T>
int dispatch_project(int n1, const void* q, const void* ef, void* qh,
                     void* qlog, void* traces, long long K, double gamma,
                     cudaStream_t stream, int* occ) {
#define ESDG_PROJ_CASE(N)                                                  \
  case N:                                                                  \
    return launch_project<T, N>(q, ef, qh, qlog, traces, K, gamma, stream, \
                                occ);
  switch (n1) {
    ESDG_SPLIT_N1(ESDG_PROJ_CASE)
    default:
      return -1;
  }
#undef ESDG_PROJ_CASE
}

extern template int fd_dir_direction<0>(ESDG_FD_DIRECTION_ARGS);
extern template int fd_dir_direction<1>(ESDG_FD_DIRECTION_ARGS);
extern template int fd_dir_direction<2>(ESDG_FD_DIRECTION_ARGS);

}  // namespace esdg

static int hex_project(int dtype, int n1, const void* q, const void* ef,
                       void* qh, void* qlog, void* traces, long long K,
                       double gamma, void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::dispatch_project<float>(n1, q, ef, qh, qlog, traces, K,
                                         gamma, st, occ);
  if (dtype == 1)
    return esdg::dispatch_project<double>(n1, q, ef, qh, qlog, traces, K,
                                          gamma, st, occ);
  return -2;
}

// dtype: 0 = float32, 1 = float64.  Returns cudaGetLastError() after the
// launch, -1 for an unsupported line length n1, -2 for an unknown dtype.
extern "C" int esdg_hex_project(int dtype, int n1, const void* q,
                                const void* ef, void* qh, void* qlog,
                                void* traces, long long K, double gamma,
                                void* stream) {
  return hex_project(dtype, n1, q, ef, qh, qlog, traces, K, gamma, stream,
                     nullptr);
}

// The projection's launch shape at line length n1 (common.cuh's
// launch_shape: occ[7]); returns as esdg_hex_project.
extern "C" int esdg_hex_project_shape(int dtype, int n1, int* occ) {
  return hex_project(dtype, n1, nullptr, nullptr, nullptr, nullptr, nullptr,
                     0, 1.4, nullptr, occ);
}

static int hex_fd_dir(int dtype, int n1, int d, int diag, const void* qh,
                      const void* qlog, const void* geo, const void* cvol,
                      const void* cface, void* out, long long K,
                      double gamma, void* stream, int* occ) {
  auto direction = d == 0   ? esdg::fd_dir_direction<0>
                   : d == 1 ? esdg::fd_dir_direction<1>
                   : d == 2 ? esdg::fd_dir_direction<2>
                            : nullptr;
  if (direction == nullptr) return -4;
  return direction(dtype, n1, diag, qh, qlog, geo, cvol, cface, out, K,
                   gamma, static_cast<cudaStream_t>(stream), occ);
}

// One direction d (0, 1, 2) of the split fd; geo [9, 1, K] affine.  diag
// takes one metric term (axis-aligned mesh); dense the dense form (row
// 4b), which is the general form with each pair once (hex_split.cuh).
// Returns cudaGetLastError() after the launch, -1 for an unsupported n1,
// -2 for an unknown dtype, -3 for diag with dense, -4 for a direction
// outside 0..2.
extern "C" int esdg_hex_fd_dir(int dtype, int n1, int d, int diag, int dense,
                               const void* qh, const void* qlog,
                               const void* geo, const void* cvol,
                               const void* cface, void* out, long long K,
                               double gamma, void* stream) {
  if (diag && dense) return -3;
  return hex_fd_dir(dtype, n1, d, diag, qh, qlog, geo, cvol, cface, out, K,
                    gamma, stream, nullptr);
}

// The split fd's launch shape in direction d at line length n1, diag or
// general (the dense form's) (common.cuh's launch_shape: occ[7]); returns
// as esdg_hex_fd_dir.
extern "C" int esdg_hex_fd_dir_shape(int dtype, int n1, int d, int diag,
                                     int* occ) {
  return hex_fd_dir(dtype, n1, d, diag, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, 0, 1.4, nullptr, occ);
}
