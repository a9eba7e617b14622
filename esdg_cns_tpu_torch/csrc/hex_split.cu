// The split volume path of the collocated-hex ES-DG Euler RHS: a
// projection kernel (this file), one flux-differencing kernel per
// direction (hex_split.cuh, instantiated in hex_fd_dir0..2.cu) and a plain
// combine, in place of K1's all-in-one volume kernel: the TPU package's
// 'split' volume modes, which its 'auto' takes at N = 7.  This file holds
// the entry points of both kernels.
//
// hex_project_kernel replaces _proj_kernel (row 3) of
// esdg_cns_tpu/ops/pallas_volume.py, behind euler_volume_split_pallas:
// the entropy projection of hex_project.cuh (shared with K1) writes the
// flux variables qh [5, Nh, K] = (rho, u1, u2, u3, beta), qlog [2, Nh, K]
// = (log rho, log beta) at all Nh = Nq + Nfq points and the 7-row face
// traces [7, Nfq, K] (K1's trace contract).  The combine (the three
// volume parts summed, 2 (1/wq) acc, the 1/wf face scaling and
// 2 LIFT qf_face) is plain tensor code, as the TPU package leaves it to
// XLA.
//
// What bounds it on this card: at N=7, K=4096 it reads q (42 MB in f32)
// and writes qh, qlog and the traces (103 MB); Ef v over each face
// point's line is 5 x 384 x 8 multiply-adds per element, and v(U), U(v_f)
// a few logarithms, powers and divisions per point, so the HBM stream is
// its bound.
//
// Simple design: a block owns TE elements (threadIdx.x, so the K-last
// loads and stores coalesce; 32, 16 or 8 so that v at the volume nodes,
// [5][Nq][TE], fits in shared memory) and 256 / TE workers.  Lanes past K
// compute on the quiescent state and store nothing.
#include "hex_project.cuh"
#include "hex_split.cuh"

namespace esdg {

constexpr int kProjThreads = 256;

template <typename T, int N1>
struct ProjTile {
  static constexpr int NQ = N1 * N1 * N1;
  static constexpr int NFQ = 6 * N1 * N1;
  static constexpr int NH = NQ + NFQ;
  static constexpr int TE = tile_elements<T>(0, size_t(5) * NQ);
  static constexpr int NW = kProjThreads / TE;
  static constexpr size_t SMEM = size_t(5) * NQ * TE * sizeof(T);
  static_assert(SMEM <= kMaxSmem, "projection tile exceeds shared memory");
};

template <typename T, int N1>
__global__ void __launch_bounds__(kProjThreads)
    hex_project_kernel(const T* __restrict__ q, const T* __restrict__ ef,
                       T* __restrict__ qh, T* __restrict__ qlog,
                       T* __restrict__ traces, long long K, double gamma) {
  using Tile = ProjTile<T, N1>;
  constexpr int NH = Tile::NH, TE = Tile::TE, NW = Tile::NW;
  const Consts<T> c(gamma);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vbuf = reinterpret_cast<T*>(smem_raw);  // [5][NQ][TE]
  const long long k = (long long)blockIdx.x * TE + threadIdx.x;
  const bool live = k < K;
  entropy_project<T, N1, TE, NW>(
      q, ef, vbuf, traces, K, k, live, c, [&](int r, int node, T v) {
        if (!live) return;
        if (r < 5)
          qh[((long long)r * NH + node) * K + k] = v;
        else
          qlog[((long long)(r - 5) * NH + node) * K + k] = v;
      });
}

template <typename T, int N1>
int launch_project(const void* q, const void* ef, void* qh, void* qlog,
                   void* traces, long long K, double gamma,
                   cudaStream_t stream) {
  using Tile = ProjTile<T, N1>;
  auto kern = hex_project_kernel<T, N1>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 block(Tile::TE, Tile::NW);
  const dim3 grid(unsigned((K + Tile::TE - 1) / Tile::TE));
  kern<<<grid, block, Tile::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ef),
      static_cast<T*>(qh), static_cast<T*>(qlog), static_cast<T*>(traces), K,
      gamma);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_project(int n1, const void* q, const void* ef, void* qh,
                     void* qlog, void* traces, long long K, double gamma,
                     cudaStream_t stream) {
#define ESDG_PROJ_CASE(N) \
  case N:                 \
    return launch_project<T, N>(q, ef, qh, qlog, traces, K, gamma, stream);
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

// dtype: 0 = float32, 1 = float64.  Returns cudaGetLastError() after the
// launch, -1 for an unsupported line length n1, -2 for an unknown dtype.
extern "C" int esdg_hex_project(int dtype, int n1, const void* q,
                                const void* ef, void* qh, void* qlog,
                                void* traces, long long K, double gamma,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::dispatch_project<float>(n1, q, ef, qh, qlog, traces, K,
                                         gamma, st);
  if (dtype == 1)
    return esdg::dispatch_project<double>(n1, q, ef, qh, qlog, traces, K,
                                          gamma, st);
  return -2;
}

// One direction d (0, 1, 2) of the split fd; geo [9, 1, K] affine.  diag
// takes one metric term (axis-aligned mesh); dense the dense form, which
// always contracts all three.  Returns cudaGetLastError() after the
// launch, -1 for an unsupported n1, -2 for an unknown dtype, -3 for diag
// with dense, -4 for a direction outside 0..2.
extern "C" int esdg_hex_fd_dir(int dtype, int n1, int d, int diag, int dense,
                               const void* qh, const void* qlog,
                               const void* geo, const void* cvol,
                               const void* cface, void* out, long long K,
                               double gamma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (diag && dense) return -3;
  auto direction = d == 0   ? esdg::fd_dir_direction<0>
                   : d == 1 ? esdg::fd_dir_direction<1>
                   : d == 2 ? esdg::fd_dir_direction<2>
                            : nullptr;
  if (direction == nullptr) return -4;
  return direction(dtype, n1, diag, dense, qh, qlog, geo, cvol, cface, out,
                   K, gamma, st);
}
