// The per-direction flux-differencing kernel of the split volume path of
// the collocated-hex ES-DG Euler RHS (entry esdg_hex_fd_dir in
// hex_split.cu, beside the projection kernel): the kernel, its launch and
// the dispatch of one direction over the types and line lengths built.
//
// Replaces the TPU kernels of esdg_cns_tpu/ops/pallas_volume.py behind
// euler_volume_split_pallas: _fd_dir_kernel and _fd_dir_pad8_kernel
// (row 4a, one math in two TPU layouts; DIAG: one metric term, else the
// 3-term affine contraction) and, DENSE, _fd_dir_dense_kernel and
// _fd_dir_dense_chunked_kernel (row 4b: every node against all N+1 nodes
// of its line, always the 3-term contraction).  Direction D of the
// line-sparse EC flux differencing (line_fd.cuh's line_pairs, the loop K1
// and the standalone line kernel run): out [5, Nq + 2 Nfp, K] holds the
// volume rows, then the face rows of faces 2D and 2D+1, NOT scaled by
// 1/wf.
//
// The direction is a template parameter, and hex_fd_dir0.cu,
// hex_fd_dir1.cu and hex_fd_dir2.cu instantiate one direction each so that
// nvcc builds the 3 x 42 kernels in parallel (130 s as one source).  A
// form with the direction as a kernel argument (one instantiation for all
// three) ran the triangular fd at N=7, k1d=16 in f32 at 0.2579, 0.2651 and
// 0.2768 ms against 0.1670, 0.1920 and 0.1968 ms for this one, in one call
// on an H100 80GB HBM3 at 700.00 W (chip_smoke.py on both trees, phase
// 21), at about the same 150-155 registers: the run-time strides and
// offsets of the line cost more than the build time they save.
//
// What bounds it on this card: at N=7, K=4096 one direction evaluates
// 64 lines x (28 vol-vol + 16 vol-face) = 2816 two-point fluxes per
// element, each with five divisions and a select-guarded logarithmic
// mean.  It reads its direction's points of qh and qlog (73 MB in f32)
// and writes 52 MB; counted at the FP32 peak with a division or logarithm
// as one operation the pairs take less time than that stream, so
// chip_smoke.py's bound is the stream's.
//
// Simple design: one thread owns one (element, line) of direction D:
// threadIdx.x runs over 32 elements, threadIdx.y over 8 lines,
// blockIdx.y over the line groups.  Every volume node lies on exactly one
// line of a direction and every face point of faces 2D, 2D+1 on exactly
// one line, so the thread reads its line's N+1 + 2 points straight from
// global memory (coalesced across the elements), keeps the line and its
// sums in registers and writes its own output rows: no shared memory, no
// atomics, no barrier; this is what lets the split path run at N+1 = 8,
// where K1's shared tile does not fit.  At N+1 = 8 a line in registers is
// 8 x 7 flux variables and 8 x 5 sums (in f64 192 registers before
// temporaries): ptxas' spill report is in the build log.  Lanes past K
// read the last element and store nothing.  Summation order differs from
// the plain version: f32 agrees to ~1e-6 of max|out|, f64 to ~1e-14.
#pragma once

#include "line_fd.cuh"

namespace esdg {

constexpr int kFdElems = 32;  // threadIdx.x: elements
constexpr int kFdLines = 8;   // threadIdx.y: lines of one direction

template <typename T, int N1, int D, bool DIAG, bool DENSE>
__global__ void __launch_bounds__(kFdElems * kFdLines)
    hex_fd_dir_kernel(const T* __restrict__ qh, const T* __restrict__ qlog,
                      const T* __restrict__ geo, const T* __restrict__ cvol,
                      const T* __restrict__ cface, T* __restrict__ out,
                      long long K, double gamma) {
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1, NH = NQ + 6 * NFP;
  constexpr int NROW = NQ + 2 * NFP;
  const Consts<T> c(gamma);
  const long long k = (long long)blockIdx.x * kFdElems + threadIdx.x;
  const int L = blockIdx.y * kFdLines + threadIdx.y;
  if (L >= NFP) return;  // no barrier in this kernel
  const bool live = k < K;
  const long long kk = live ? k : K - 1;  // lanes past K: any valid state
  T g[3] = {T(0), T(0), T(0)};
  if (DIAG) {
    g[0] = geo[(long long)(D * 3 + D) * K + kk];
  } else {
#pragma unroll
    for (int x = 0; x < 3; ++x) g[x] = geo[(long long)(D * 3 + x) * K + kk];
  }
  auto load = [&](int r, int node) -> T {
    return r < 5 ? qh[((long long)r * NH + node) * K + kk]
                 : qlog[((long long)(r - 5) * NH + node) * K + kk];
  };
  const int base = line_base<N1>(D, L);
  auto vload = [&](int r, int a) -> T {
    return load(r, base + a * line_stride<N1>(D));
  };
  auto fload = [&](int r, int side) -> T {
    return load(r, NQ + (2 * D + side) * NFP + L);
  };
  auto gload = [&](int, int) -> T { return T(0); };  // affine only
  auto vol_out = [&](int f, int, int node, T s) {
    if (live) out[((long long)f * NROW + node) * K + k] = s;
  };
  auto face_out = [&](int f, int side, T s) {
    if (live) out[((long long)f * NROW + NQ + side * NFP + L) * K + k] = s;
  };
  line_pairs<T, N1, DIAG, false, DENSE, true>(D, L, g, cvol, cface, c, vload,
                                              fload, gload, vol_out,
                                              face_out);
}

template <typename T, int N1, int D, bool DIAG, bool DENSE>
int launch_fd_dir(const void* qh, const void* qlog, const void* geo,
                  const void* cvol, const void* cface, void* out, long long K,
                  double gamma, cudaStream_t stream) {
  constexpr int NFP = N1 * N1;
  auto kern = hex_fd_dir_kernel<T, N1, D, DIAG, DENSE>;
  const dim3 block(kFdElems, kFdLines);
  const dim3 grid(unsigned((K + kFdElems - 1) / kFdElems),
                  unsigned((NFP + kFdLines - 1) / kFdLines));
  kern<<<grid, block, 0, stream>>>(
      static_cast<const T*>(qh), static_cast<const T*>(qlog),
      static_cast<const T*>(geo), static_cast<const T*>(cvol),
      static_cast<const T*>(cface), static_cast<T*>(out), K, gamma);
  return int(cudaGetLastError());
}

template <int D, typename T, int N1>
int fd_dir_form(int diag, int dense, const void* qh, const void* qlog,
                const void* geo, const void* cvol, const void* cface,
                void* out, long long K, double gamma, cudaStream_t stream) {
  if (dense)
    return launch_fd_dir<T, N1, D, false, true>(qh, qlog, geo, cvol, cface,
                                                out, K, gamma, stream);
  if (diag)
    return launch_fd_dir<T, N1, D, true, false>(qh, qlog, geo, cvol, cface,
                                                out, K, gamma, stream);
  return launch_fd_dir<T, N1, D, false, false>(qh, qlog, geo, cvol, cface,
                                               out, K, gamma, stream);
}

// Direction D of the split fd for every type and line length built;
// instantiated once per direction in hex_fd_dir<D>.cu, so the three
// build in parallel.  Returns as esdg_hex_fd_dir.
template <int D>
int fd_dir_direction(int dtype, int n1, int diag, int dense, const void* qh,
                     const void* qlog, const void* geo, const void* cvol,
                     const void* cface, void* out, long long K, double gamma,
                     cudaStream_t stream) {
#define ESDG_FD_CASE(T, N)                                                \
  case N:                                                                 \
    return fd_dir_form<D, T, N>(diag, dense, qh, qlog, geo, cvol, cface,  \
                                out, K, gamma, stream);
#define ESDG_FD_F32(N) ESDG_FD_CASE(float, N)
#define ESDG_FD_F64(N) ESDG_FD_CASE(double, N)
  if (dtype == 0) {
    switch (n1) {
      ESDG_SPLIT_N1(ESDG_FD_F32)
      default:
        return -1;
    }
  }
  if (dtype == 1) {
    switch (n1) {
      ESDG_SPLIT_N1(ESDG_FD_F64)
      default:
        return -1;
    }
  }
#undef ESDG_FD_F64
#undef ESDG_FD_F32
#undef ESDG_FD_CASE
  return -2;
}

#define ESDG_FD_DIRECTION_ARGS                                            \
  int, int, int, int, const void*, const void*, const void*, const void*, \
      const void*, void*, long long, double, cudaStream_t

}  // namespace esdg
