// Per-unit carbon-deficit timeline (paper section 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/carbon_cost.py::_kernel
// (launched by deficit_timeline, public through repro.kernels.ops
// .carbon_cost). It computes what repro's deficit_timeline computes: for
// every time unit t in [0, T), with t taken as an f32,
//
//   out[t] = max(sum_i w_i * [s_i <= t < e_i] - g[t], 0)
//
// compared in f32, so fractional, negative or past-the-horizon starts and
// ends behave as in the reference, and a zero-length task adds nothing. The
// TPU kernel padded N and T to 512-wide tiles; this one takes any N >= 1 and
// T and writes [T] directly.
//
// Bound on this card: the function needs each input read once and the
// output written once, (3 N + 2 T) * 4 bytes (about 58 KB at N = 4304,
// T = 776, some 17 ns at 3.35 TB/s), and O(N + T) operations in a
// difference-array form. Neither sets this kernel's time: each thread's
// serial walk over all N tasks does (about 0.046 ms at N = 4304, T = 776 on
// an H100 80GB HBM3 at 700 W, some 21 cycles per task).
//
// Design: simple and exact first. One thread owns one time unit and keeps
// an f32 register accumulator; a block of kBlock consecutive units stages
// the task arrays through shared memory in chunks of kBlock tasks with
// coalesced loads, and every thread walks each chunk in ascending task
// order. No atomics, so the summation order is fixed; with integer inputs
// whose sums stay below 2^24 every order is exact and the result equals the
// dense plain version bit for bit. The dense N x T walk does far more work
// than the bound, and at T = 776 it launches only ceil(T / kBlock) blocks on
// 132 SMs; a split of the task axis with a fixed-order second pass, or a
// difference array plus a scan, is the redesign that closes that gap.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock) deficit_timeline_kernel(
    const float* __restrict__ starts,  // [N]
    const float* __restrict__ ends,    // [N]
    const float* __restrict__ works,   // [N]
    const float* __restrict__ g,       // [T]
    float* __restrict__ out,           // [T]
    int N, int T) {
  __shared__ float s_sh[kBlock];
  __shared__ float e_sh[kBlock];
  __shared__ float w_sh[kBlock];
  const int u = blockIdx.x * kBlock + threadIdx.x;
  const float t = (float)u;
  float acc = 0.0f;
  for (int base = 0; base < N; base += kBlock) {
    const int i = base + threadIdx.x;
    if (i < N) {
      s_sh[threadIdx.x] = starts[i];
      e_sh[threadIdx.x] = ends[i];
      w_sh[threadIdx.x] = works[i];
    }
    __syncthreads();
    const int n = min(kBlock, N - base);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float active = (s_sh[j] <= t && t < e_sh[j]) ? 1.0f : 0.0f;
      acc += w_sh[j] * active;
    }
    __syncthreads();
  }
  if (u < T) {
    const float d = acc - g[u];
    out[u] = d < 0.0f ? 0.0f : d;      // NaN passes through, as in torch
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// The caller allocates `out` and checks shapes, dtypes and contiguity.
extern "C" int deficit_timeline_launch(const float* starts, const float* ends,
                                       const float* works, const float* g,
                                       float* out, int N, int T,
                                       void* stream) {
  if (T <= 0) return 0;
  const unsigned grid = (unsigned)((T + kBlock - 1) / kBlock);
  deficit_timeline_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      starts, ends, works, g, out, N, T);
  return (int)cudaGetLastError();
}
