// Throughput probes of the card's f32 arithmetic: the FMA peak and the
// cost of each other operation the kernels use, in FMA issue slots.
//
// Replaces the TPU study kernels of examples/vpu_peak.py (the `kernel`
// closure of main, :62: two FMA chains per element) and
// examples/vpu_divide.py (:53) / examples/vpu_transcendental.py (:78) (four
// chains per element of one fixed-point map per kind).  Each kernel
// computes exactly the JAX function: the same constants (a double
// expression rounded once to float, as JAX rounds a Python float against
// an f32 array), the same chains, step count and output.  The probes are
// f32, as the TPU ones are.
//
//   esdg_probe_peak:  a = x, b = 0.5 x + 1; iters/2 steps of
//                     a <- a 0.999998 + x, b <- b 0.999999 + x, each one
//                     fmaf; out = (a + b) 1e-3.
//   esdg_probe_chain: chains a_i = x (0.5 + 0.1 i) + 1, i = 0..3; iters/4
//                     steps of the kind's map (chain_step below) with
//                     c_i = 0.25 + 0.0625 i; out = (a_0 + a_1 + a_2 + a_3)
//                     0.25.
//
// The division, log, exp and sqrt of the chains are the port's own device
// code: the operators and the overloads of common.cuh's templates at
// T = float, built under the same flags (kernels.py COMPILE_FLAGS, no
// --use_fast_math), so `/` is the IEEE division and log, exp, sqrt are
// libdevice's, and the prices measured here are the prices those kernels
// pay.  rsqrt is rsqrtf (the special-function unit's approximation); no
// kernel of the port calls it.
//
// What bounds them: operations.  Per element the peak probe does iters
// FMAs (512 at the defaults: 1024 flops) against 8 bytes of I/O, 128
// flops a byte where the card's f32 ridge is 67e12 / 3.35e12 = 20; the
// chains do iters steps of one map.  So each reads the issue rate of its
// operation.  To reach the pipe's throughput the design raises the work
// in flight, never the chains per element (that would change the
// function): the grid is sized to the blocks the SMs hold at once (the
// occupancy calculator's count per SM times the SMs), every thread walks
// the elements in a grid-stride loop, and the step loop is unrolled so
// that its counter and branch add about 2% to the issue stream
// (kPeakUnroll, chain_unroll; unrolled 16 times, the peak probe read
// 54.6 TFLOP/s and the fma chain 57.1 on an H100 80GB HBM3 at 700.00 W,
// chip_smoke.py phase 31).
// Each resident warp carries 2 (peak) or 4 (chains) independent
// dependency chains; with 64 warps an SM that is far more than the four
// cycles of FMA latency need.  A peak probe reading under half of the
// data sheet's 67 TFLOP/s measures latency, not throughput:
// chip_smoke.py refuses it.
#include <cuda_runtime.h>

namespace esdg {

constexpr int kProbeThreads = 256;
constexpr int kProbeChains = 4;
// steps per pass of the unrolled step loop: 128 FMAs a pass in the peak
// probe, so the pass's counter and branch are 2% of its issue stream
constexpr int kPeakUnroll = 64;

// the kinds of the chain probe, in the order of the wrapper's KINDS
enum ProbeKind : int {
  kFma = 0, kMul, kAdd, kDiv, kLog, kExp, kRsqrt, kSqrt, kNumKinds
};

// The constant of chain i's map (examples/vpu_transcendental.py _STEPS),
// from c = 0.25 + 0.0625 i: formed in double and rounded once to float, as
// the TPU kernel's weak-typed Python floats are; computed before the step
// loop, so the loop holds the kind's operations alone.
template <int KIND>
__host__ __device__ constexpr float chain_const(double c) {
  if constexpr (KIND == kMul) {
    return float(0.97 + 0.001 * c);
  } else if constexpr (KIND == kLog) {
    return float(2.0 + c * 0.01);
  } else if constexpr (KIND == kExp) {
    return float(0.5 + c * 0.01);
  } else if constexpr (KIND == kSqrt) {
    return float(c * 0.1);
  } else {
    return float(c);
  }
}

// Steps per pass of a chain kernel's unrolled loop: 128 one-slot
// operations a pass for fma, mul and add; 16 steps (64 operations of 6 to
// 25 slots) for the others, whose loop overhead is then far below 1%.
template <int KIND>
__host__ __device__ constexpr int chain_unroll() {
  return KIND == kFma || KIND == kMul || KIND == kAdd ? 32 : 16;
}

// One step of a chain; k is chain_const's value.
template <int KIND>
__device__ __forceinline__ float chain_step(float a, float x, float k) {
  if constexpr (KIND == kFma) {
    return fma(a, 0.97f, k);
  } else if constexpr (KIND == kMul) {
    return a * k;
  } else if constexpr (KIND == kAdd) {
    return a + k;
  } else if constexpr (KIND == kDiv) {
    return x / (a + k);
  } else if constexpr (KIND == kLog) {
    return log(a) + k;
  } else if constexpr (KIND == kExp) {
    return exp(-a) + k;
  } else if constexpr (KIND == kRsqrt) {
    return rsqrtf(a + k);
  } else {
    return sqrt((a + 2.0f) + k);
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    probe_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n, int steps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float xv = x[i];
    float a = xv;
    float b = xv * 0.5f + 1.0f;
    auto step = [&]() {
      a = fmaf(a, 0.999998f, xv);
      b = fmaf(b, 0.999999f, xv);
    };
    int s = 0;
    for (; s + kPeakUnroll <= steps; s += kPeakUnroll) {
#pragma unroll
      for (int u = 0; u < kPeakUnroll; ++u) step();
    }
    for (; s < steps; ++s) step();
    out[i] = (a + b) * 1e-3f;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kProbeThreads)
    probe_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                       long long n, int steps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float xv = x[i];
    float ch[kProbeChains], k[kProbeChains];
#pragma unroll
    for (int j = 0; j < kProbeChains; ++j) {
      ch[j] = xv * float(0.5 + 0.1 * j) + 1.0f;
      k[j] = chain_const<KIND>(0.25 + 0.0625 * j);
    }
    auto step = [&]() {
#pragma unroll
      for (int j = 0; j < kProbeChains; ++j)
        ch[j] = chain_step<KIND>(ch[j], xv, k[j]);
    };
    constexpr int U = chain_unroll<KIND>();
    int s = 0;
    for (; s + U <= steps; s += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) step();
    }
    for (; s < steps; ++s) step();
    float acc = ch[0];
#pragma unroll
    for (int j = 1; j < kProbeChains; ++j) acc = acc + ch[j];
    out[i] = acc * 0.25f;
  }
}

// Blocks the SMs hold at once for kern, at most what n elements need.
template <typename Kern>
int probe_grid(Kern kern, long long n, unsigned& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kProbeThreads, 0);
  if (err != cudaSuccess) return int(err);
  const long long need = (n + kProbeThreads - 1) / kProbeThreads;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  grid = unsigned(need < full ? need : full);
  return 0;
}

template <int KIND>
int launch_chain(const void* x, void* out, long long n, int steps,
                 cudaStream_t stream) {
  auto kern = probe_chain_kernel<KIND>;
  unsigned grid = 0;
  const int rc = probe_grid(kern, n, grid);
  if (rc != 0) return rc;
  kern<<<grid, kProbeThreads, 0, stream>>>(static_cast<const float*>(x),
                                           static_cast<float*>(out), n,
                                           steps);
  return int(cudaGetLastError());
}

}  // namespace esdg

// x, out [n] float32.  iters: the TPU probe's ITERS (iters / 2 steps of
// each chain).  Returns cudaGetLastError() after the launch.
extern "C" int esdg_probe_peak(const void* x, void* out, long long n,
                               int iters, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kern = esdg::probe_peak_kernel;
  unsigned grid = 0;
  const int rc = esdg::probe_grid(kern, n, grid);
  if (rc != 0) return rc;
  kern<<<grid, esdg::kProbeThreads, 0, st>>>(static_cast<const float*>(x),
                                             static_cast<float*>(out), n,
                                             iters / 2);
  return int(cudaGetLastError());
}

// kind: 0 fma, 1 mul, 2 add, 3 div, 4 log, 5 exp, 6 rsqrt, 7 sqrt; one
// kernel instantiation per kind, so no kind branches inside the loop.
// x, out [n] float32; iters / 4 steps of each of the four chains.
// Returns cudaGetLastError() after the launch, -1 for an unknown kind.
extern "C" int esdg_probe_chain(int kind, const void* x, void* out,
                                long long n, int iters, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = iters / esdg::kProbeChains;
#define ESDG_PROBE_CASE(KIND) \
  case esdg::KIND:              \
    return esdg::launch_chain<esdg::KIND>(x, out, n, steps, st);
  switch (kind) {
    ESDG_PROBE_CASE(kFma)
    ESDG_PROBE_CASE(kMul)
    ESDG_PROBE_CASE(kAdd)
    ESDG_PROBE_CASE(kDiv)
    ESDG_PROBE_CASE(kLog)
    ESDG_PROBE_CASE(kExp)
    ESDG_PROBE_CASE(kRsqrt)
    ESDG_PROBE_CASE(kSqrt)
    default:
      return -1;
  }
#undef ESDG_PROBE_CASE
}
