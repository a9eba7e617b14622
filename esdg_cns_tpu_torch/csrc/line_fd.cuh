// The line-sparse skew EC flux differencing of collocated hex elements,
// shared by K1 (hex_volume.cu), the standalone line kernel (hex_lines.cu)
// and the split path's per-direction kernels (hex_split.cuh).  It replaces
// the copies of one loop in the TPU package: the fd mid-section of
// esdg_cns_tpu/ops/pallas_volume.py::_volume_kernel, the per-direction
// kernels _fd_dir_kernel / _fd_dir_dense_kernel of the same file and
// esdg_cns_tpu/ops/tensor_product_fd.py::_hex_lines_kernel, whose pair
// bookkeeping must agree.
//
// line_pairs is the work of one node line of one direction d: it loads
// the line's N+1 volume points and its two face points (T v[7] = (rho,
// u1, u2, u3, beta, log rho, log beta)) through the caller's loader,
// evaluates every vol-vol pair ONCE (a < a', the triangular form: node a'
// receives the negated contribution, exact because S1 is skew and the
// flux symmetric) or, DENSE, every node against all N+1 nodes of its line
// (cvol's diagonal is zero), and every vol-face pair, keeps the line's
// sums in registers and hands them to the caller: the volume sums of its
// N+1 nodes and the face rows (the skew negatives of the vol-face
// couplings) of its two face points.  Every volume node lies on exactly
// one line of a direction and every face point of faces 2d, 2d+1 on
// exactly one, so no two threads write one value.
//
// line_fd runs the lines of all three directions over a shared-memory tile:
// a block owns TE elements (threadIdx.x, so the K-last loads and stores
// coalesce) and NW = 256 / TE workers (threadIdx.y); the element's flux
// variables at its Nh = Nq + Nfq points and a [5 x Nq] accumulator live in
// shared memory, and the directions are separated by barriers.
//
// Metric forms: DIAG (axis-aligned affine mesh) one metric term per
// direction; otherwise the 3-term contraction sum_x g_x F_x, with g the
// element's affine metric (geo [9, 1, K]) or, when CURVED (geo [9, Nh, K]),
// the pairwise average 0.5 (g_a + g_b) of the two points' metrics
// (pallas_volume.py:210-211 and :232-233).  On curved meshes the thread of
// line L of direction d loads rows 3d..3d+2 of geo at its N+1 volume points
// and its two face points straight from global memory into registers: each
// metric value the function needs is read once, by one thread.
#pragma once

#include "common.cuh"

namespace esdg {

constexpr int kVolumeThreads = 256;

// The tile of K1 and row 10: the largest of at most 16 elements whose
// shared memory fits (common.cuh's tile_elements), so N+1 <= 5 keep the
// 16 or 8 elements they were measured with; N+1 = 6..8 take 8, 4 or 2.
template <typename T, int N1>
struct VolumeTile {
  static constexpr int NQ = N1 * N1 * N1;
  static constexpr int NFP = N1 * N1;
  static constexpr int NFQ = 6 * NFP;
  static constexpr int NH = NQ + NFQ;
  static constexpr int TE_FIT = tile_elements<T>(0, size_t(7 * NH + 5 * NQ));
  static constexpr int TE = TE_FIT < 16 ? TE_FIT : 16;
  static constexpr int NW = kVolumeThreads / TE;
  // 7 x Nh flux variables and a 5 x Nq accumulator per element
  static constexpr size_t SMEM = size_t(7 * NH + 5 * NQ) * TE * sizeof(T);
  static_assert(SMEM <= kMaxSmem, "volume tile exceeds shared memory");
};

// Line L of direction d.  load(r, node) returns row r of the flux
// variables at hybridized point node (volume nodes 0..NQ-1, then face
// point fid of face node L at NQ + fid NFP + L); gload(row, node) the
// curved metric (read only when CURVED); g[3] is the affine metric of the
// direction (g[0] alone when DIAG).  vol_out(f, node, s) receives the
// line's sum for volume node node, face_out(f, side, s) the face row of
// face point (2d + side, L); cvol [3 N1][NQ] and cface [6][NQ] are
// ops/tensor_product_fd._hex_line_coeffs.
template <typename T, int N1, bool DIAG, bool CURVED, bool DENSE,
          typename Load, typename GLoad, typename VolOut, typename FaceOut>
__device__ __forceinline__ void line_pairs(int d, int L, const T g[3],
                                           const T* __restrict__ cvol,
                                           const T* __restrict__ cface,
                                           const Consts<T>& c, Load load,
                                           GLoad gload, VolOut vol_out,
                                           FaceOut face_out) {
  static_assert(!(DIAG && CURVED), "the diag form is for affine meshes");
  static_assert(!(DENSE && (DIAG || CURVED)),
                "the dense form takes the affine 3-term contraction");
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1;
  const int stride = line_stride<N1>(d);
  const int base = line_base<N1>(d, L);
  T qv[N1][7];
  T al[N1][5];
  T gv[CURVED ? N1 : 1][3];  // the line's volume metrics (curved)
#pragma unroll
  for (int a = 0; a < N1; ++a) {
#pragma unroll
    for (int r = 0; r < 7; ++r) qv[a][r] = load(r, base + a * stride);
#pragma unroll
    for (int f = 0; f < 5; ++f) al[a][f] = T(0);
    if constexpr (CURVED) {
#pragma unroll
      for (int x = 0; x < 3; ++x) gv[a][x] = gload(d * 3 + x, base + a * stride);
    }
  }
  if constexpr (DENSE) {
    // every node against every node of its line: node a gets cvol*F(a, ap)
#pragma unroll
    for (int a = 0; a < N1; ++a) {
#pragma unroll
      for (int ap = 0; ap < N1; ++ap) {
        T fr[5];
        contracted_flux<T, false>(qv[a], qv[ap], d, g, c, fr);
        const T cf = __ldg(cvol + (d * N1 + ap) * NQ + base + a * stride);
#pragma unroll
        for (int f = 0; f < 5; ++f) al[a][f] += cf * fr[f];
      }
    }
  } else {
    // vol-vol pairs, each once: node a gets cvol*F, node ap its negative
#pragma unroll
    for (int ap = 1; ap < N1; ++ap) {
#pragma unroll
      for (int a = 0; a < ap; ++a) {
        T fr[5];
        if constexpr (CURVED) {
          T gp[3];
#pragma unroll
          for (int x = 0; x < 3; ++x) gp[x] = T(0.5) * (gv[a][x] + gv[ap][x]);
          contracted_flux<T, false>(qv[a], qv[ap], d, gp, c, fr);
        } else {
          contracted_flux<T, DIAG>(qv[a], qv[ap], d, g, c, fr);
        }
        const T cf = __ldg(cvol + (d * N1 + ap) * NQ + base + a * stride);
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          const T wv = cf * fr[f];
          al[a][f] += wv;
          al[ap][f] -= wv;
        }
      }
    }
  }
  // vol-face pairs of the two faces the line pierces
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int fid = 2 * d + side;
    const int frow = NQ + fid * NFP + L;
    T qf[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) qf[r] = load(r, frow);
    T gf[3];
    if constexpr (CURVED) {
#pragma unroll
      for (int x = 0; x < 3; ++x) gf[x] = gload(d * 3 + x, frow);
    }
    T fs[5] = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int a = 0; a < N1; ++a) {
      T fr[5];
      if constexpr (CURVED) {
        T gp[3];
#pragma unroll
        for (int x = 0; x < 3; ++x) gp[x] = T(0.5) * (gv[a][x] + gf[x]);
        contracted_flux<T, false>(qv[a], qf, d, gp, c, fr);
      } else {
        contracted_flux<T, DIAG>(qv[a], qf, d, g, c, fr);
      }
      const T cf = __ldg(cface + fid * NQ + base + a * stride);
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        const T wv = cf * fr[f];
        al[a][f] += wv;
        fs[f] -= wv;
      }
    }
#pragma unroll
    for (int f = 0; f < 5; ++f) face_out(f, side, fs[f]);
  }
#pragma unroll
  for (int a = 0; a < N1; ++a) {
#pragma unroll
    for (int f = 0; f < 5; ++f) vol_out(f, base + a * stride, al[a][f]);
  }
}

// sh [7][NH][TE]: the tile's flux variables; acc [5][NQ][TE], zeroed by
// the caller, receives the volume rows.  On return (after a barrier) rows
// 0..4 of each face point of sh hold its face row, scaled by iwf[L] (the
// 1/wf of face node L) unless iwf is null.  Every thread of the block
// calls it.
template <typename T, int N1, bool DIAG, bool CURVED>
__device__ __forceinline__ void line_fd(T* sh, T* acc,
                                        const T* __restrict__ geo,
                                        const T* __restrict__ cvol,
                                        const T* __restrict__ cface,
                                        const T* __restrict__ iwf,
                                        long long K, long long k, bool live,
                                        const Consts<T>& c) {
  using Tile = VolumeTile<T, N1>;
  constexpr int NQ = Tile::NQ, NFP = Tile::NFP, NH = Tile::NH;
  constexpr int TE = Tile::TE, NW = Tile::NW;
  const int e = threadIdx.x;
  const int w = threadIdx.y;
  auto SH = [&](int r, int node) -> T& { return sh[(r * NH + node) * TE + e]; };
  auto ACC = [&](int f, int node) -> T& { return acc[(f * NQ + node) * TE + e]; };
  auto load = [&](int r, int node) -> T { return SH(r, node); };
  // row `row` of the curved metric at hybridized point `node`
  auto gload = [&](int row, int node) -> T {
    return live ? geo[((long long)row * NH + node) * K + k]
                : (row % 4 == 0 ? T(1) : T(0));
  };
  auto vol_out = [&](int f, int node, T s) { ACC(f, node) += s; };

#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T g[3] = {T(1), T(0), T(0)};  // the affine metric (lanes past K: any)
    if (!CURVED && live) {
      if (DIAG) {
        g[0] = geo[(long long)(d * 3 + d) * K + k];
      } else {
#pragma unroll
        for (int x = 0; x < 3; ++x) g[x] = geo[(long long)(d * 3 + x) * K + k];
      }
    }
    for (int L = w; L < NFP; L += NW) {
      // the face row over this point's face values: no other thread reads
      // face point (fid, L)
      auto face_out = [&](int f, int side, T s) {
        const T scale = iwf != nullptr ? iwf[L] : T(1);
        SH(f, NQ + (2 * d + side) * NFP + L) = scale * s;
      };
      line_pairs<T, N1, DIAG, CURVED, false>(d, L, g, cvol, cface, c, load,
                                             gload, vol_out, face_out);
    }
    __syncthreads();  // the next direction's lines cross these nodes
  }
}

}  // namespace esdg
