// The per-direction flux-differencing kernel of the split volume path of
// the collocated-hex ES-DG Euler RHS (entry esdg_hex_fd_dir in
// hex_split.cu, beside the projection kernel): the kernel, its launch and
// the dispatch of one direction over the types and line lengths built.
//
// Replaces the TPU kernels of esdg_cns_tpu/ops/pallas_volume.py behind
// euler_volume_split_pallas: _fd_dir_kernel and _fd_dir_pad8_kernel
// (row 4a, one math in two TPU layouts; DIAG: one metric term, else the
// 3-term affine contraction) and _fd_dir_dense_kernel and
// _fd_dir_dense_chunked_kernel (row 4b: every node against all N+1 nodes
// of its line, always the 3-term contraction).  Direction D of the
// line-sparse EC flux differencing: out [5, Nq + 2 Nfp, K] holds the
// volume rows, then the face rows of faces 2D and 2D+1, NOT scaled by
// 1/wf.  Row 4b's dense loop is a TPU layout (it "trades ~2x more pair
// evaluations for fully aligned lowering"): cvol's line block is skew
// with a zero diagonal and the flux symmetric, so the dense form is the
// general form with every pair once, and runs it (hex_fd_dir_dense).
//
// The direction is a template parameter, and hex_fd_dir0.cu,
// hex_fd_dir1.cu and hex_fd_dir2.cu instantiate one direction each so that
// nvcc builds them in parallel.  A form with the direction as a kernel
// argument ran the fd at N=7 35-54% slower (run-time strides and offsets;
// an H100 80GB HBM3 at 700.00 W, PERF.md §6).
//
// What bounds it on this card: at N=7, K=4096 one direction evaluates
// 64 lines x (28 vol-vol + 16 vol-face) = 2816 two-point fluxes per
// element, each with five IEEE divisions (about 14.5 FMA issue slots
// each) and a select-guarded logarithmic mean, about 130 slots a pair
// with one metric term; it reads its direction's points of qh and qlog
// (73 MB in f32) and writes 52 MB.  Priced at the card's measured issue
// costs the pairs take longer than that stream (chip_smoke.py's priced
// bound), so the kernel is bound by issue, and by latency where too few
// warps are resident to hide the divider's chain.  On the card its times
// came out near the stream's time plus the pairs' (PERF.md §6): a
// persistent form that copied the next tile while computing one
// (cp.async) ran slower at every N+1, as did two elements a thread.
//
// Design (FdTile, per type and N+1; PERF.md §6 has the sweep that chose
// them, probes/tiles.py):
//   kFdPairs: the line's pairs spread over its N+1 nodes.  A block holds
//     TE elements (the lanes: every global load and store covers TE
//     consecutive elements of a K-last array) x LINES lines of direction
//     D x N+1 threads a line, thread a owning volume node a.  Each thread
//     reads its node's 7 flux variables into registers and into shared
//     memory (threads 0 and 1 also the line's face points), then the
//     vol-vol pairs run in floor((N+1)/2) rounds of a fixed circulant
//     schedule: in round r thread a evaluates pair (a, a' = a + r mod
//     N+1), keeps s F and hands -s F to node a' through shared memory (one
//     barrier a round, two alternating buffers), s the triangular form's
//     coefficient of the pair, negated when a > a'.  Every unordered pair
//     appears once (at even N+1 the last round, distance (N+1)/2, runs on
//     threads a < (N+1)/2 alone), so each node gets what the triangular
//     form gives it, for any table (fd_section's random ones too), in
//     another order.  Then each thread evaluates its two vol-face pairs
//     and writes its face partials; after a barrier the face rows are
//     summed over the line's nodes in node order.  Every sum is formed
//     in a fixed order: no atomics, the same bits every run.  A thread
//     holds one point, one partner and five sums (53-61 registers in
//     f32: 32-36 warps an SM) where one thread a line held 7 (N+1) +
//     5 (N+1) values (147 registers at N+1 = 8: 8 warps an SM).  The
//     schedule is mirrored in ops/fused_volume.fd_pair_schedule.
//   kFdStaged: one thread a line (line_fd.cuh's line_pairs, the
//     triangular loop), its points written once to shared memory and read
//     again by every pair (the K1 way: f32 at N+1 = 6).
// Lanes past K compute on the last element (a live state: a zero state
// takes the f32 divider's slow path) and store nothing; lines past N+1^2
// compute on the last line and store nothing, so every thread reaches
// every barrier.  Summation order differs from the plain version: f32
// agrees to ~1e-6 of max|out|, f64 to ~1e-14.
#pragma once

#include "line_fd.cuh"

namespace esdg {

enum FdMode : int { kFdPairs = 0, kFdStaged = 1 };

// A split fd tile: the mode, TE elements a block, LINES lines a block and
// at least MIN_BLOCKS blocks resident an SM (__launch_bounds__' register
// cap)
struct FdTile {
  int mode, te, lines, min_blocks;
};

template <typename T, int N1, int MODE, int TE, int LINES>
struct FdLayout {
  static constexpr int NP = N1 + 2;  // a line's points: N1 nodes, 2 faces
  static constexpr int THREADS = TE * LINES * (MODE == kFdPairs ? N1 : 1);
  // shared memory, in values of T: the points [7][LINES][NP][TE], then
  // (pairs) the exchange [2][5][LINES][N1][TE] and the face partials
  // [2][5][LINES][N1][TE]
  static constexpr int PTS = 7 * LINES * NP * TE;
  static constexpr int EX = MODE == kFdPairs ? 10 * LINES * N1 * TE : 0;
  static constexpr size_t SMEM = size_t(PTS + 2 * EX) * sizeof(T);
  static_assert(THREADS <= 1024, "split fd block exceeds 1024 threads");
  static_assert(SMEM <= kMaxSmem, "split fd tile exceeds shared memory");
};

template <typename T, int N1, int D, bool DIAG, int MODE, int TE, int LINES,
          int MIN_BLOCKS>
__global__ void __launch_bounds__(FdLayout<T, N1, MODE, TE, LINES>::THREADS,
                                  MIN_BLOCKS)
    hex_fd_dir_kernel(const T* __restrict__ qh, const T* __restrict__ qlog,
                      const T* __restrict__ geo, const T* __restrict__ cvol,
                      const T* __restrict__ cface, T* __restrict__ out,
                      long long K, double gamma) {
  using Lay = FdLayout<T, N1, MODE, TE, LINES>;
  constexpr int NQ = N1 * N1 * N1, NFP = N1 * N1, NH = NQ + 6 * NFP;
  constexpr int NROW = NQ + 2 * NFP, NP = Lay::NP;
  constexpr int STRIDE = D == 0 ? 1 : (D == 1 ? N1 : N1 * N1);
  const Consts<T> c(gamma);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int e = threadIdx.x % TE;
  const int task = threadIdx.x / TE;
  const int lb = MODE == kFdPairs ? task / N1 : task;  // line of the block
  const int L0 = blockIdx.y * LINES + lb;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K && L0 < NFP;
  const long long kk = k < K ? k : K - 1;  // lanes past K: a live element
  const int L = L0 < NFP ? L0 : NFP - 1;   // lines past NFP: the last one
  const int base = line_base<N1>(D, L);
  T g[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int x = 0; x < (DIAG ? 1 : 3); ++x)
    g[x] = __ldg(geo + (long long)(D * 3 + (DIAG ? D : x)) * K + kk);
  auto load = [&](int r, int node) -> T {
    return r < 5 ? __ldg(qh + ((long long)r * NH + node) * K + kk)
                 : __ldg(qlog + ((long long)(r - 5) * NH + node) * K + kk);
  };
  // row r of the line's point p (node p < N1, else face point p - N1)
  auto pt = [&](int r, int p) -> T& {
    return sh[((r * LINES + lb) * NP + p) * TE + e];
  };
  auto face_node = [&](int side) { return NQ + (2 * D + side) * NFP + L; };
  auto vol_row = [&](int f, int node) -> T& {
    return out[((long long)f * NROW + node) * K + k];
  };
  auto face_row = [&](int f, int side) -> T& {
    return out[((long long)f * NROW + NQ + side * NFP + L) * K + k];
  };
  auto scaled = [&](T cf, T gs[3]) {
#pragma unroll
    for (int x = 0; x < (DIAG ? 1 : 3); ++x) gs[x] = g[x] * cf;
  };

  if constexpr (MODE == kFdPairs) {
    const int a = task % N1;  // this thread's node of the line
    const int node = base + a * STRIDE;
    T v[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      v[r] = load(r, node);
      pt(r, a) = v[r];
    }
    if (a < 2) {
#pragma unroll
      for (int r = 0; r < 7; ++r) pt(r, N1 + a) = load(r, face_node(a));
    }
    __syncthreads();
    // ex(buf, f, node): the negative a partner hands node `node`;
    // fx(side, f, a): node a's face partial
    T* const ex_base = sh + Lay::PTS;
    auto ex = [&](int buf, int f, int nd) -> T& {
      return ex_base[(((buf * 5 + f) * LINES + lb) * N1 + nd) * TE + e];
    };
    auto fx = [&](int side, int f, int nd) -> T& {
      return ex_base[Lay::EX +
                     (((side * 5 + f) * LINES + lb) * N1 + nd) * TE + e];
    };
    // the pair {lo, hi} (lo < hi) takes the triangular form's coefficient
    // cvol[D N1 + hi][base + lo STRIDE]: +c for node lo, -c for node hi
    // (cvol's skew line block makes it c(lo, hi) = -c(hi, lo))
    const T* __restrict__ cv = cvol + D * N1 * NQ + base;
    T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int r = 1; r <= N1 / 2; ++r) {
      const bool half = 2 * r == N1;  // even N1's last round
      if (!half || a < r) {
        const int ap = (a + r) % N1;
        const bool lo = a < ap;
        const T cf = __ldg(cv + (lo ? ap : a) * NQ + (lo ? a : ap) * STRIDE);
        T R[7], gs[3], fr[5];
#pragma unroll
        for (int q = 0; q < 7; ++q) R[q] = pt(q, ap);
        scaled(lo ? cf : -cf, gs);
        contracted_flux<T, DIAG>(v, R, D, gs, c, fr);
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          acc[f] += fr[f];
          ex(r & 1, f, a) = -fr[f];
        }
      }
      __syncthreads();
      const int from = (a + N1 - r) % N1;  // the node whose pair hit a
      if (!half || from < r) {
#pragma unroll
        for (int f = 0; f < 5; ++f) acc[f] += ex(r & 1, f, from);
      }
    }
    const T* __restrict__ cf = cface + 2 * D * NQ + node;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      T R[7], gs[3], fr[5];
#pragma unroll
      for (int q = 0; q < 7; ++q) R[q] = pt(q, N1 + side);
      scaled(__ldg(cf + side * NQ), gs);
      contracted_flux<T, DIAG>(v, R, D, gs, c, fr);
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        acc[f] += fr[f];
        fx(side, f, a) = -fr[f];
      }
    }
    __syncthreads();
    if (!live) return;  // no barrier below
#pragma unroll
    for (int f = 0; f < 5; ++f) vol_row(f, node) = acc[f];
    for (int s = a; s < 10; s += N1) {  // the face rows, in node order
      const int side = s / 5, f = s % 5;
      T sum = fx(side, f, 0);
#pragma unroll
      for (int nd = 1; nd < N1; ++nd) sum += fx(side, f, nd);
      face_row(f, side) = sum;
    }
  } else {
    // the thread's own points: it reads back only what it wrote
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int nd = p < N1 ? base + p * STRIDE : face_node(p - N1);
#pragma unroll
      for (int r = 0; r < 7; ++r) pt(r, p) = load(r, nd);
    }
    auto vload = [&](int r, int a) -> T {
      return *static_cast<volatile T*>(&pt(r, a));
    };
    auto fload = [&](int r, int side) -> T {
      return *static_cast<volatile T*>(&pt(r, N1 + side));
    };
    auto gload = [&](int, int) -> T { return T(0); };  // affine only
    line_pairs<T, N1, DIAG, false, false>(
        D, L, g, cvol, cface, c, vload, fload, gload,
        [&](int f, int, int nd, T s) {
          if (live) vol_row(f, nd) = s;
        },
        [&](int f, int side, T s) {
          if (live) face_row(f, side) = s;
        });
  }
}

// One direction at one tile: launches, or with occ fills its launch
// shape (common.cuh's launch_shape; occ[6] = MIN_BLOCKS).  Returns a CUDA
// error code.
template <typename T, int N1, int D, bool DIAG, int MODE, int TE, int LINES,
          int MIN_BLOCKS>
int launch_fd_dir_tile(const void* qh, const void* qlog, const void* geo,
                       const void* cvol, const void* cface, void* out,
                       long long K, double gamma, cudaStream_t stream,
                       int* occ) {
  using Lay = FdLayout<T, N1, MODE, TE, LINES>;
  constexpr int NFP = N1 * N1;
  auto kern = hex_fd_dir_kernel<T, N1, D, DIAG, MODE, TE, LINES, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Lay::SMEM));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr) {
    const int rc = launch_shape(kern, Lay::THREADS, Lay::SMEM, TE, occ);
    occ[6] = MIN_BLOCKS;
    return rc;
  }
  const dim3 grid(unsigned((K + TE - 1) / TE),
                  unsigned((NFP + LINES - 1) / LINES));
  kern<<<grid, Lay::THREADS, Lay::SMEM, stream>>>(
      static_cast<const T*>(qh), static_cast<const T*>(qlog),
      static_cast<const T*>(geo), static_cast<const T*>(cvol),
      static_cast<const T*>(cface), static_cast<T*>(out), K, gamma);
  return int(cudaGetLastError());
}

// The tile at each type and line length, timed on the card against its
// neighbours and the parent tree's kernel (probes/tiles.py FD_CASES, each
// direction at the paths' shapes; PERF.md §6): f32 at N+1 = 5..8 (diag;
// general at 6 and 8; dense, the general kernel, at 5 and 8), f64 at 8;
// the others untimed, the neighbours'.  The pairs tiles ran at 53-61
// registers and 32-36 warps an SM in f32.  At N+1 = 6 the one-thread-a-line
// tile with its points in shared memory (90-96 registers, 20 warps) ran
// both metric forms 2-5% ahead of them, as fast as the parent's line in
// registers (124-128 registers, 16 warps); at N+1 = 8 that line took 147.
template <typename T, int N1>
constexpr FdTile fd_tile() {
  if (sizeof(T) == 8) return FdTile{kFdPairs, 32, 1, 3};
  if (N1 == 6) return FdTile{kFdStaged, 32, 4, 3};
  return N1 == 8 ? FdTile{kFdPairs, 16, 1, 8} : FdTile{kFdPairs, 32, 1, 4};
}

template <int D, typename T, int N1>
int fd_dir_form(int diag, const void* qh, const void* qlog, const void* geo,
                const void* cvol, const void* cface, void* out, long long K,
                double gamma, cudaStream_t stream, int* occ) {
  constexpr FdTile t = fd_tile<T, N1>();
  if (diag)
    return launch_fd_dir_tile<T, N1, D, true, t.mode, t.te, t.lines,
                              t.min_blocks>(qh, qlog, geo, cvol, cface, out,
                                            K, gamma, stream, occ);
  return launch_fd_dir_tile<T, N1, D, false, t.mode, t.te, t.lines,
                            t.min_blocks>(qh, qlog, geo, cvol, cface, out, K,
                                          gamma, stream, occ);
}

// Direction D of the split fd for every type and line length built;
// instantiated once per direction in hex_fd_dir<D>.cu, so the three
// build in parallel.  Returns as esdg_hex_fd_dir.
template <int D>
int fd_dir_direction(int dtype, int n1, int diag, const void* qh,
                     const void* qlog, const void* geo, const void* cvol,
                     const void* cface, void* out, long long K, double gamma,
                     cudaStream_t stream, int* occ) {
#define ESDG_FD_CASE(T, N)                                                 \
  case N:                                                                  \
    return fd_dir_form<D, T, N>(diag, qh, qlog, geo, cvol, cface, out, K,  \
                                gamma, stream, occ);
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

#define ESDG_FD_DIRECTION_ARGS                                              \
  int, int, int, const void*, const void*, const void*, const void*,        \
      const void*, void*, long long, double, cudaStream_t, int*

}  // namespace esdg
