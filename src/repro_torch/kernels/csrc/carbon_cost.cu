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
// TPU kernel padded N and T to 512-wide tiles and walked the dense task x
// unit product; this one takes any N >= 0 and T < 2^24 and writes [T].
//
// Bound on this card: bytes. The function needs each input read once and
// the output written once, (3 N + 2 T) * 4 bytes (about 58 KB at N = 4304,
// T = 776: 17 ns at 3.35 TB/s; 0.12 us at N = 30000, T = 4096), and O(N + T)
// operations. The kernel of the first port walked the dense N x T product,
// one thread per unit looping over all N tasks: 0.0461 ms at N = 4304,
// T = 776 and 0.3134 ms at N = 30000, T = 4096, 0.04% of the bound. This
// design takes 0.0078 ms and 0.0185 ms (0.22% and 0.63%; profiler device
// times from chip_ab.py, both kernels in one run, NVIDIA H100 80GB HBM3,
// 700 W). Beside a launch's fixed cost, what sets that time is one SM per
// tile loading all N tasks and issuing their 64-bit shared-memory atomics.
//
// Design: a difference array and a scan, O(N + T). For an integer unit t <
// 2^24, s <= t < e (in f32) holds exactly when t lies in [ceil(s), ceil(e)).
// One CTA owns a tile of kTile units (the plan's T = 776 is one CTA). It
// reads all N tasks with coalesced loads, kBatch per thread in flight, and
// scatters +w at ceil(s) and -w at ceil(e) into an f64 difference array in
// shared memory, both ends clamped to the tile in float before they become
// ints (so +-inf and 1e30 are safe); a task active at the tile's first unit
// lands on index 0, which is the tile's carry-in. A block-wide scan then
// gives each unit its sum, rounded to f32 once, and the unit writes
// max(acc - g, 0). No pass crosses blocks. Works that are f32 values summed
// in f64 are exact in any order while their exponent spread fits the 53-bit
// mantissa (integer works always do), so the shared-memory atomics leave the
// result deterministic and, on integer inputs whose sums stay below 2^24,
// bitwise equal to the dense f32 sum. With ends given as durations the
// kernel forms e = s + d itself with __fadd_rn, the reference's f32 add.
//
// Non-finite works follow the dense form exactly: w * [active] is NaN where
// an infinite work is inactive (inf * 0) and +-inf where it is active, and a
// NaN work is NaN everywhere. So infinite works skip the f64 array and are
// counted per unit instead (+inf in the low and -inf in the high 32 bits of
// a u64 difference array, scanned with wrapping adds, only when a call has
// any); a unit where fewer of them are active than exist is NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 1024;   // units per CTA, one per thread
constexpr int kBatch = 4;     // tasks per thread loaded before any is used

// Inclusive scan of v over the block (kTile threads); `part` holds one
// value per warp. Ends with a barrier, so `part` may be reused.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T x = part[lane];                    // kTile / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    part[lane] = x;
  }
  __syncthreads();
  if (warp > 0) v += part[warp - 1];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kTile) deficit_timeline_kernel(
    const float* __restrict__ starts,  // [N]
    const float* __restrict__ second,  // [N] ends, or durations if durs
    const float* __restrict__ works,   // [N]
    const float* __restrict__ g,       // [T]
    float* __restrict__ out,           // [T]
    int N, int T, int durs) {
  __shared__ double diff[kTile];
  __shared__ unsigned long long count[kTile];
  __shared__ double part_f[32];
  __shared__ unsigned long long part_u[32];
  __shared__ int n_inf;

  const int t0 = blockIdx.x * kTile;
  const int len = min(kTile, T - t0);
  const float t0f = (float)t0, t1f = (float)(t0 + len);
  diff[threadIdx.x] = 0.0;
  count[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) n_inf = 0;
  __syncthreads();

  int nan_work = 0, my_inf = 0;
  for (int base = 0; base < N; base += kBatch * kTile) {
    float s[kBatch], x[kBatch], w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kTile + threadIdx.x;
      const bool in = i < N;
      s[j] = in ? starts[i] : 0.0f;
      x[j] = in ? second[i] : 0.0f;
      w[j] = in ? works[i] : 0.0f;     // a zero work adds nothing
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float wj = w[j];
      if (wj == 0.0f) continue;
      if (isnan(wj)) { nan_work = 1; continue; }
      const bool inf = isinf(wj);
      my_inf += inf;
      const float e = durs ? __fadd_rn(s[j], x[j]) : x[j];
      if (isnan(s[j]) || isnan(e)) continue;          // never active
      const float lo = fminf(fmaxf(ceilf(s[j]), t0f), t1f);
      const float hi = fminf(fmaxf(ceilf(e), t0f), t1f);
      if (!(lo < hi)) continue;                       // not in this tile
      const int a = (int)lo - t0, b = (int)hi - t0;
      if (!inf) {
        atomicAdd(&diff[a], (double)wj);
        if (b < len) atomicAdd(&diff[b], -(double)wj);
      } else {
        const unsigned long long one = wj > 0.0f ? 1ull : 1ull << 32;
        atomicAdd(&count[a], one);
        if (b < len) atomicAdd(&count[b], 0ull - one);
      }
    }
  }
  if (my_inf) atomicAdd(&n_inf, my_inf);
  const int any_nan = __syncthreads_or(nan_work);   // also ends the scatter

  const int inf_total = n_inf;
  float acc = (float)block_scan(diff[threadIdx.x], part_f);
  if (inf_total > 0) {                 // block-uniform: every CTA reads all N
    const unsigned long long c = block_scan(count[threadIdx.x], part_u);
    const unsigned pos = (unsigned)(c & 0xffffffffull);
    const unsigned neg = (unsigned)(c >> 32);
    if (pos) acc += CUDART_INF_F;
    if (neg) acc -= CUDART_INF_F;
    if (pos + neg < (unsigned)inf_total) acc = CUDART_NAN_F;
  }
  if (any_nan) acc = CUDART_NAN_F;
  if (threadIdx.x < len) {
    const int u = t0 + threadIdx.x;
    const float d = acc - g[u];
    out[u] = d < 0.0f ? 0.0f : d;      // NaN passes through, as in torch
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// `second` holds the ends, or the durations when `durs` is nonzero. The
// caller allocates `out`, checks shapes, dtypes and contiguity, and keeps
// T below 2^24 so that every unit is exact in f32.
extern "C" int deficit_timeline_launch(const float* starts,
                                       const float* second,
                                       const float* works, const float* g,
                                       float* out, int N, int T, int durs,
                                       void* stream) {
  if (T <= 0) return 0;
  const unsigned grid = (unsigned)((T + kTile - 1) / kTile);
  deficit_timeline_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      starts, second, works, g, out, N, T, durs);
  return (int)cudaGetLastError();
}
