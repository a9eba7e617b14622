// The line-sparse skew EC flux differencing of collocated hex elements,
// shared by K1 (hex_volume.cu), the standalone line kernel (hex_lines.cu)
// and the fd section (fd_section.cuh); the split path's per-direction
// kernel (hex_split.cuh) mostly spreads a line's pairs over its nodes'
// threads instead, and runs line_pairs in its one-thread-a-line tiles.
// It replaces the copies of one loop in the TPU package: the fd
// mid-section of esdg_cns_tpu/ops/pallas_volume.py::_volume_kernel and
// esdg_cns_tpu/ops/tensor_product_fd.py::_hex_lines_kernel, whose pair
// bookkeeping must agree.
//
// line_pairs is the work of one node line of one direction d: it reads
// the line's N+1 volume points and its two face points (T v[7] = (rho,
// u1, u2, u3, beta, log rho, log beta)) through the caller's loader,
// evaluates every vol-vol pair ONCE (a < a', the triangular form: node a'
// receives the negated contribution, exact because S1 is skew and the
// flux symmetric) and every vol-face pair, keeps the line's sums in
// registers and hands them to the caller: the volume sums of its N+1
// nodes and the face rows (the skew negatives of the vol-face couplings)
// of its two face points.  Every volume node lies on exactly one line of
// a direction and every face point of faces 2d, 2d+1 on exactly one, so
// no two threads of one direction write one value.  HOLD keeps the
// line's points in registers (K1 at N+1 = 8); otherwise each pair reads
// both its points again from the caller's shared tile (7 (N+1) fewer
// registers).
//
// line_fd runs the lines of all three directions of a tile of TE elements
// AT ONCE: one thread per (element, direction, line), 3 (N+1)^2 threads
// per element (VolumeTile).  The element's flux variables at its Nh = Nq
// + Nfq points sit in shared memory, 7 Nh values (padded, below); there is
// no separate accumulator.  Each face row goes into rows 0..4 of its own
// face point's slot as soon as its pairs are done (no other line reads
// that point).  Once every line's pairs are done (a barrier) the volume
// rows of the tile are dead, and the line sums go into rows 0..4 of them:
// direction 0 stores, then direction 1 adds, then direction 2 (a barrier
// between each; the lines of different directions cross).  So a
// thread holds one line's sums, every thread is busy in the pair phase at
// every N, and the tile needs no [5, Nq] accumulator: in f32 5,600 B an
// element at N+1 = 4 with the padding below, 14,112 B at N+1 = 6 (a tile
// with the accumulator took 5,760 and 16,416, and held one block of 8
// elements an SM at N+1 = 6).
//
// Bank conflicts: the lines of direction 0 start N+1 nodes apart, so at
// even N+1 the threads of one warp read one bank group; slot() pads every
// (N+1)-th value of the tile at even N+1 (PAD), which spreads them.
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

// K1's block at each type and line length: TE elements, one thread per
// (element, line task), and at least MIN_BLOCKS blocks resident on an SM
// (__launch_bounds__: the register cap that lets them; a sub-partition's
// 16,384 registers over its share of the warps).  f32: 36, 35, 36 warps
// an SM at N+1 = 2, 3, 4 (56 registers), 19 at 5 and 7 (96), 28 at 6
// (72), 12 at 8 (the line held, 168); f64 about half.  The f32 choices
// and f64's at N+1 = 4, 5, 6 were timed on the card against their
// neighbours (PERF.md §6): wider tiles read and write whole sectors of
// the K-last arrays, and beat narrower ones at the same warps.
template <typename T, int N1>
constexpr int volume_te() {
  return sizeof(T) == 4 ? (N1 <= 2 ? 16 : N1 <= 5 ? 8 : N1 <= 7 ? 4 : 2)
                        : (N1 <= 2 ? 16 : N1 == 3 ? 8 : N1 <= 6 ? 4 : 1);
}
template <typename T, int N1>
constexpr int volume_min_blocks() {
  return sizeof(T) == 4 ? (N1 == 2 ? 6 : N1 == 3 ? 5 : N1 == 4 ? 3
                           : N1 == 6 ? 2 : 1)
                        : (N1 == 2 || N1 == 7   ? 3
                           : N1 == 5 || N1 == 6 ? 1
                                                : 2);
}

// HOLD (line_pairs): the line's points in registers where the cap leaves
// room for them
template <typename T, int N1>
constexpr bool volume_hold() {
  return sizeof(T) == 4 && N1 == 8;
}

template <typename T, int N1>
struct VolumeTile {
  static constexpr int NQ = N1 * N1 * N1;
  static constexpr int NFP = N1 * N1;
  static constexpr int NFQ = 6 * NFP;
  static constexpr int NH = NQ + NFQ;
  static constexpr int NT = 3 * NFP;  // line tasks of an element
  static constexpr int TE = volume_te<T, N1>();
  static constexpr int THREADS = TE * NT;
  static constexpr int MIN_BLOCKS = volume_min_blocks<T, N1>();
  static constexpr bool HOLD = volume_hold<T, N1>();
  static constexpr bool PAD = N1 % 2 == 0;
  // the padded slots of one row (NH is a multiple of N1) and of the
  // element's 7 rows
  static constexpr int ROW = PAD ? NH + NH / N1 : NH;
  static constexpr int SLOTS = 7 * ROW;
  static constexpr size_t SMEM = size_t(SLOTS) * TE * sizeof(T);
  static_assert(THREADS <= 1024, "volume block exceeds 1024 threads");
  static_assert(SMEM <= kMaxSmem, "volume tile exceeds shared memory");
  static_assert(5 * NQ <= 7 * NFQ, "v(U) does not fit in the face slots");
  // the padded slot of hybridized point node in a row
  __host__ __device__ static constexpr int pslot(int node) {
    return PAD ? node + node / N1 : node;
  }
  // the tile slot of row r (0..6) at hybridized point node
  __host__ __device__ static constexpr int slot(int r, int node) {
    return r * ROW + pslot(node);
  }
  // pslot(line_base + a line_stride) = pslot(line_base) + a pstride(d)
  __host__ __device__ static constexpr int pstride(int d) {
    return PAD ? (d == 0 ? 1 : d == 1 ? N1 + 1 : N1 * N1 + N1)
               : (d == 0 ? 1 : d == 1 ? N1 : N1 * N1);
  }
};

// Line L of direction d.  vload(r, a) returns row r of the flux variables
// at the line's a-th volume node (node line_base + a line_stride), fload(r,
// side) at its face point on face 2d + side (hybridized point NQ + (2d +
// side) NFP + L); gload(row, node) the curved metric at hybridized point
// node (read only when CURVED); g[3] is the affine metric of the direction
// (g[0] alone when DIAG).  vol_out(f, a, node, s) receives the line's sum
// for its a-th volume node node, face_out(f, side, s) the face row of
// face point (2d + side, L); cvol [3 N1][NQ] and cface [6][NQ] are
// ops/tensor_product_fd._hex_line_coeffs.  A pair's coefficient multiplies
// its metric terms before the flux is contracted (one product where
// scaling the five flux components took five).
template <typename T, int N1, bool DIAG, bool CURVED, bool HOLD,
          typename VLoad, typename FLoad, typename GLoad, typename VolOut,
          typename FaceOut>
__device__ __forceinline__ void line_pairs(int d, int L, const T g[3],
                                           const T* __restrict__ cvol,
                                           const T* __restrict__ cface,
                                           const Consts<T>& c, VLoad vload,
                                           FLoad fload, GLoad gload,
                                           VolOut vol_out, FaceOut face_out) {
  static_assert(!(DIAG && CURVED), "the diag form is for affine meshes");
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1;
  const int stride = line_stride<N1>(d);
  const int base = line_base<N1>(d, L);
  // the coefficients of the line: cvol[d N1 + ap][base + a stride] and
  // cface[2d + side][base + a stride]
  const T* __restrict__ cv = cvol + d * N1 * NQ + base;
  const T* __restrict__ cfc = cface + 2 * d * NQ + base;
  T qv[HOLD ? N1 : 1][7];
  T al[N1][5];
  T gv[CURVED ? N1 : 1][3];  // the line's volume metrics (curved)
#pragma unroll
  for (int a = 0; a < N1; ++a) {
    if constexpr (HOLD) {
#pragma unroll
      for (int r = 0; r < 7; ++r) qv[a][r] = vload(r, a);
    }
#pragma unroll
    for (int f = 0; f < 5; ++f) al[a][f] = T(0);
    if constexpr (CURVED) {
#pragma unroll
      for (int x = 0; x < 3; ++x)
        gv[a][x] = gload(d * 3 + x, base + a * stride);
    }
  }
  // node a of the line: from registers (HOLD) or read again
  auto point = [&](int a, T v[7]) {
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      if constexpr (HOLD) {
        v[r] = qv[a][r];
      } else {
        v[r] = vload(r, a);
      }
    }
  };
  // the pair's metric terms times its coefficient cf
  auto scaled = [&](T cf, T gs[3]) {
#pragma unroll
    for (int x = 0; x < (DIAG ? 1 : 3); ++x) gs[x] = g[x] * cf;
  };
  // vol-vol pairs, each once: node a gets cvol*F, node ap its negative
#pragma unroll
  for (int ap = 1; ap < N1; ++ap) {
#pragma unroll
    for (int a = 0; a < ap; ++a) {
      T Lv[7], R[7];
      point(a, Lv);
      point(ap, R);
      const T cf = __ldg(cv + ap * NQ + a * stride);
      T gs[3], fr[5];
      if constexpr (CURVED) {
        const T half_cf = T(0.5) * cf;
#pragma unroll
        for (int x = 0; x < 3; ++x) gs[x] = (gv[a][x] + gv[ap][x]) * half_cf;
      } else {
        scaled(cf, gs);
      }
      contracted_flux<T, DIAG>(Lv, R, d, gs, c, fr);
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        al[a][f] += fr[f];
        al[ap][f] -= fr[f];
      }
    }
  }
  // vol-face pairs of the two faces the line pierces
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int frow = NQ + (2 * d + side) * NFP + L;
    T gf[3];
    if constexpr (CURVED) {
#pragma unroll
      for (int x = 0; x < 3; ++x) gf[x] = gload(d * 3 + x, frow);
    }
    T fs[5] = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int a = 0; a < N1; ++a) {
      T Lv[7], qf[7];
      point(a, Lv);
#pragma unroll
      for (int r = 0; r < 7; ++r) qf[r] = fload(r, side);
      const T cf = __ldg(cfc + side * NQ + a * stride);
      T gs[3], fr[5];
      if constexpr (CURVED) {
        const T half_cf = T(0.5) * cf;
#pragma unroll
        for (int x = 0; x < 3; ++x) gs[x] = (gv[a][x] + gf[x]) * half_cf;
      } else {
        scaled(cf, gs);
      }
      contracted_flux<T, DIAG>(Lv, qf, d, gs, c, fr);
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        al[a][f] += fr[f];
        fs[f] -= fr[f];
      }
    }
#pragma unroll
    for (int f = 0; f < 5; ++f) face_out(f, side, fs[f]);
  }
#pragma unroll
  for (int a = 0; a < N1; ++a) {
#pragma unroll
    for (int f = 0; f < 5; ++f) vol_out(f, a, base + a * stride, al[a][f]);
  }
}

// The tile's flux-differencing section.  sh: the block's tile, value
// (r, node) of element e at sh[Tile::slot(r, node) * TE + e], filled by
// the caller (a barrier before the call).  On return (after a barrier)
// rows 0..4 of each volume node hold its volume sum and rows 0..4 of
// each face point its face row, scaled by iwf[L] (the 1/wf of face node
// L) unless iwf is null; rows 5, 6 are spent.  k0: the block's first
// element.  Every thread of the block calls it.
template <typename T, int N1, bool DIAG, bool CURVED>
__device__ __forceinline__ void line_fd(T* sh, const T* __restrict__ geo,
                                        const T* __restrict__ cvol,
                                        const T* __restrict__ cface,
                                        const T* __restrict__ iwf,
                                        long long K, long long k0,
                                        const Consts<T>& c) {
  using Tile = VolumeTile<T, N1>;
  constexpr int NQ = Tile::NQ, NFP = Tile::NFP, NH = Tile::NH;
  constexpr int TE = Tile::TE, ROW = Tile::ROW;
  const int e = threadIdx.x % TE;     // element of the tile
  const int task = threadIdx.x / TE;  // line task of the element
  const int d = task / NFP;           // its direction
  const int L = task % NFP;           // its line
  const long long k = k0 + e;
  const bool live = k < K;
  // the line's points: row r of its a-th volume node at vp[(a pstride(d)
  // + r ROW) TE], of its face point on side at fp[side][r ROW TE]
  T* const vp = sh + Tile::pslot(line_base<N1>(d, L)) * TE + e;
  const int vstep = Tile::pstride(d) * TE;
  T* const fp0 = sh + Tile::pslot(NQ + 2 * d * NFP + L) * TE + e;
  T* const fp1 = sh + Tile::pslot(NQ + (2 * d + 1) * NFP + L) * TE + e;
  // volatile: the pair loop reads a point again rather than keep it
  auto vload = [&](int r, int a) -> T {
    return *static_cast<volatile T*>(vp + a * vstep + r * ROW * TE);
  };
  auto fload = [&](int r, int side) -> T {
    return *static_cast<volatile T*>((side ? fp1 : fp0) + r * ROW * TE);
  };
  // row `row` of the curved metric at hybridized point `node`
  auto gload = [&](int row, int node) -> T {
    return live ? geo[((long long)row * NH + node) * K + k]
                : (row % 4 == 0 ? T(1) : T(0));
  };
  T g[3] = {T(1), T(0), T(0)};  // the affine metric (lanes past K: any)
  if (!CURVED && live) {
    if (DIAG) {
      g[0] = geo[(long long)(d * 3 + d) * K + k];
    } else {
#pragma unroll
      for (int x = 0; x < 3; ++x) g[x] = geo[(long long)(d * 3 + x) * K + k];
    }
  }
  // a face row goes into its face point's slot at once: the line's pairs
  // are the only reader of that point
  const T scale = iwf != nullptr ? iwf[L] : T(1);
  T vs[N1][5];
  line_pairs<T, N1, DIAG, CURVED, Tile::HOLD>(
      d, L, g, cvol, cface, c, vload, fload, gload,
      [&](int f, int a, int, T s) { vs[a][f] = s; },
      [&](int f, int side, T s) {
        (side ? fp1 : fp0)[f * ROW * TE] = scale * s;
      });
  __syncthreads();  // every line has read the tile's volume points
  // the volume sums, one direction after the other: their lines cross
#pragma unroll
  for (int dd = 0; dd < 3; ++dd) {
    if (d == dd) {
#pragma unroll
      for (int a = 0; a < N1; ++a) {
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          T& s = vp[a * vstep + f * ROW * TE];
          s = dd == 0 ? vs[a][f] : s + vs[a][f];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace esdg
