// The tail of the merged CNS RHS on collocated hexes, after K4's
// fold_tail form: the traction exchange, the wall rule, the LIFT of the
// traction jump and the 1/J scaling, in one pass,
//   dq = dq_part + LIFT (0.5 (t_pn - t_f)) (1/J),
// written in place into dq_part.
//
// Replaces no TPU kernel: the TPU package's tail
// (esdg_cns_tpu/solvers/cns_fused.py) is jnp, fused by XLA, while the
// same lines in PyTorch are an index_select (the exchange), a where per
// wall region, the jump, a dense GEMM for the LIFT, the 1/J scaling and
// the add, each one more pass over [5, Nfq, K] or [5, Nq, K].
//
// The neighbour's traction t_pn at each face point follows a per-point
// code (ops/cns_tail.py's traction_rule, built once with the RHS from the
// wall regions in WallBC.stress_normal's order):
//   code >= 0   interior: t_pn = -t_f[:, code], code being the
//               neighbour's flat index node * K + element (map_p);
//   code == -1  natural (a boundary face of no region, an isothermal wall,
//               a Dirichlet region without ghost stresses): t_pn = t_f,
//               so the jump is zero;
//   code <= -2  adiabatic: the momentum passes and the energy row is
//               -t_f[E] + 2 u_wall . t_f[mom], with 2 u_wall the row
//               -2 - code of the table wall [R, 3].
//
// What bounds it on this card: bytes.  Per element it reads the traction
// (5 x Nfq), the code (Nfq ints), the neighbours' traction (the same
// array, mostly from L2: a neighbour lies in the same or a nearby tile),
// dq_part (5 x Nq) and 1/J, and writes dq (5 x Nq); 5 x 6 LIFT
// multiply-adds per volume node are its only arithmetic.
//
// Design: K2's skeleton and tile (hex_surface.cuh's surface_tile): a
// block owns TE elements, a thread maps t -> (element t % TE, point
// t / TE), so a warp's K-last loads and stores cover TE consecutive
// elements.  A first loop over the face points computes each jump once
// into shared memory [5][Nfq][TE] (natural points read nothing); a
// second loop over the volume nodes contracts LIFT over the six face
// points of each node's three lines (common.cuh's lift_lines), reads
// dq_part (plain loads: the kernel writes it) and stores dq.  Lanes past
// K store nothing.
#include "hex_surface.cuh"

namespace esdg {

template <typename T>
struct TailArgs {
  T* dq;              // [5, Nq, K]: dq_part in, dq out
  const T* tf;        // [5, Nfq, K]
  const int* code;    // [Nfq, K]
  const T* wall;      // [R, 3]: 2 u_wall per adiabatic row
  const T* lift;      // [Nq, Nfq]
  const T* inv_j;     // [1, K]
};

template <typename T, int N1, int TE, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    cns_tail_kernel(const TailArgs<T> a, long long K) {
  static_assert(THREADS % TE == 0, "a thread keeps one element");
  constexpr int NQ = N1 * N1 * N1, NFQ = 6 * N1 * N1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sjump = reinterpret_cast<T*>(smem_raw);  // [5][NFQ][TE]
  const int e = threadIdx.x % TE;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;
  const long long plane = (long long)NFQ * K;  // one field of t_f

  for (int fp = threadIdx.x / TE; fp < NFQ; fp += THREADS / TE) {
    T jump[5] = {T(0), T(0), T(0), T(0), T(0)};
    if (live) {
      const long long o = (long long)fp * K + k;
      const int c = __ldg(a.code + o);
      if (c >= 0) {
        T own[5], nbr[5];
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          own[f] = __ldg(a.tf + f * plane + o);
          nbr[f] = __ldg(a.tf + f * plane + c);
        }
#pragma unroll
        for (int f = 0; f < 5; ++f) jump[f] = T(0.5) * (-nbr[f] - own[f]);
      } else if (c <= -2) {
        const T* w = a.wall + 3 * (-2 - c);
        const T en = __ldg(a.tf + 4 * plane + o);
        const T work = (__ldg(w) * __ldg(a.tf + plane + o) +
                        __ldg(w + 1) * __ldg(a.tf + 2 * plane + o)) +
                       __ldg(w + 2) * __ldg(a.tf + 3 * plane + o);
        jump[4] = T(0.5) * ((-en + work) - en);
      }
    }
#pragma unroll
    for (int f = 0; f < 5; ++f) sjump[(f * NFQ + fp) * TE + e] = jump[f];
  }
  __syncthreads();

  if (!live) return;  // no barrier below
  const T ij = __ldg(a.inv_j + k);
  for (int i = threadIdx.x / TE; i < NQ; i += THREADS / TE) {
    T s[5] = {T(0), T(0), T(0), T(0), T(0)};
    lift_lines<T, N1>(
        a.lift, i,
        [&](int f, int fp) { return sjump[(f * NFQ + fp) * TE + e]; }, s);
    T part[5];
#pragma unroll
    for (int f = 0; f < 5; ++f)
      part[f] = a.dq[(long long)(f * NQ + i) * K + k];
#pragma unroll
    for (int f = 0; f < 5; ++f)
      a.dq[(long long)(f * NQ + i) * K + k] = part[f] + s[f] * ij;
  }
}

// One type and line length: launches, or with occ fills its launch shape
// (common.cuh's launch_shape; occ[6] = MIN_BLOCKS).  Returns a CUDA error
// code.
template <typename T, int N1>
int launch_tail(const TailArgs<T>& a, long long K, cudaStream_t stream,
                int* occ) {
  constexpr TileShape t = surface_tile<T, N1>();
  constexpr size_t SMEM = size_t(5) * 6 * N1 * N1 * t.te * sizeof(T);
  static_assert(SMEM <= kMaxSmem, "tail tile exceeds shared memory");
  auto kern = cns_tail_kernel<T, N1, t.te, t.threads, t.min_blocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr) {
    const int rc = launch_shape(kern, t.threads, SMEM, t.te, occ);
    occ[6] = t.min_blocks;
    return rc;
  }
  const dim3 grid(unsigned((K + t.te - 1) / t.te));
  kern<<<grid, t.threads, SMEM, stream>>>(a, K);
  return int(cudaGetLastError());
}

template <typename T>
TailArgs<T> tail_args(const void* const* ptrs) {
  TailArgs<T> a{};
  if (ptrs == nullptr) return a;
  auto p = [&](int i) { return static_cast<const T*>(ptrs[i]); };
  a.dq = const_cast<T*>(p(0));
  a.tf = p(1);
  a.code = static_cast<const int*>(ptrs[2]);
  a.wall = p(3);
  a.lift = p(4);
  a.inv_j = p(5);
  return a;
}

template <typename T>
int tail_type(int n1, const void* const* ptrs, long long K,
              cudaStream_t stream, int* occ) {
  const TailArgs<T> a = tail_args<T>(ptrs);
#define ESDG_TAIL_CASE(N) \
  case N:                 \
    return launch_tail<T, N>(a, K, stream, occ);
  switch (n1) {
    ESDG_TAIL_CASE(2)
    ESDG_TAIL_CASE(3)
    ESDG_TAIL_CASE(4)
    ESDG_TAIL_CASE(5)
    ESDG_TAIL_CASE(6)
    ESDG_TAIL_CASE(7)
    ESDG_TAIL_CASE(8)
    default:
      return -1;
  }
#undef ESDG_TAIL_CASE
}

}  // namespace esdg

static int cns_tail(int dtype, int n1, const void* const* ptrs, long long K,
                    void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return esdg::tail_type<float>(n1, ptrs, K, st, occ);
  if (dtype == 1) return esdg::tail_type<double>(n1, ptrs, K, st, occ);
  return -2;
}

// dtype: 0 = float32, 1 = float64; n1 = N+1 (2..8).  ptrs: void*[6] = dq
// (dq_part, overwritten by dq), t_f, code (int32), wall, lift, inv_j
// (TailArgs).  Returns cudaGetLastError() after the launch, -1 for an
// unsupported line length, -2 for an unknown dtype.
extern "C" int esdg_cns_tail(int dtype, int n1, const void* const* ptrs,
                             long long K, void* stream) {
  return cns_tail(dtype, n1, ptrs, K, stream, nullptr);
}

// The launch shape at one type and line length (common.cuh's
// launch_shape: occ[7]); returns as esdg_cns_tail.
extern "C" int esdg_cns_tail_shape(int dtype, int n1, int* occ) {
  return cns_tail(dtype, n1, nullptr, 0, nullptr, occ);
}
