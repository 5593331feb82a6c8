// Local-search gain sweep (paper section 5.3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gain_scan.py::_gain_kernel
// (launched by _kernel_call, dispatched by gains_windows_auto). It computes
// what repro's gain_scan_batched computes: for batch row r, candidate i and
// shift delta in [-mu, mu], the exact carbon gain of moving task i of row r
// by delta against that row's remaining-budget timeline rem[r, :]:
//
//   released(x) = min(max(-x, 0), w)             on the vacated units
//   incurred(x) = min(max(w - max(x, 0), 0), w)  on the newly occupied units
//   gain(delta) = sum released - sum incurred;   illegal shifts -> -1e30
//
// A shift is legal when lo_rel <= delta <= hi_rel, delta != 0 and w > 0.
// Timeline reads outside [0, Tp) read 0, as repro's gather_windows pads.
//
// Bound on this card: memory. Per launch the kernel must write
// R * Np * (2 mu + 1) * 4 bytes of gains and read about R * Np * 16 bytes of
// per-candidate inputs (start, lo_rel, hi_rel, plus the shared dur/work) and
// the R * Tp timeline: at R = 32, Np = 4352, Tp = 1024, mu = 10 about 14 MB,
// 0.00404 ms at 3.35 TB/s (0.0147 ms at mu = 42), with a handful of
// operations per byte. The TPU kernel read two pre-gathered [R * Np, 128]
// f32 windows per candidate (about 70 MB each at that size).
//
// The first port (one thread per candidate, 1-D grid, mu a runtime value)
// read each candidate's 4 mu timeline units straight from global memory.
// Neighbouring threads hold unrelated starts, so each warp-wide load touched
// up to 32 cache lines, one L1 wavefront each: 0.0139 ms at mu = 10 (29%
// of the bound) and 0.0505 ms at mu = 42 (29%). This design takes
// 0.0065 ms (62%) and 0.0297 ms (49.5%) (profiler device times from
// chip_ab.py, both kernels in one run, NVIDIA H100 80GB HBM3, 700 W).
//
// Design: the gather comes from shared memory. A 2-D grid of candidate
// chunks x rows: each CTA stages its row of rem (Tp f32, 4 KB at the climb's
// Tp = 1024) into shared memory with coalesced 16-byte loads, and each of
// its kBlock threads owns one candidate of that row and walks the 2 mu shifts
// with running sums over the windows [s - mu, s + mu) and [e - mu, e + mu):
// at shift +k the vacated unit s + k - 1 (k <= d) and the unit that leaves
// the incurred lag (k > d) are the same unit, and so at -k are e - k and
// s - k + d, so every step reads two units. A random shared-memory gather
// costs a few bank conflicts where the global one cost a cache line per
// thread. A row longer than kStageMax units is read from global memory by
// the same code (a template flag), never by the plain version. mu is a
// template constant for the values the climb and the tests use (the loops
// unroll and the loads hoist); other values take the same code with mu at
// run time. Each thread parks its 2 mu + 1 gains in shared memory (the odd
// stride keeps the writes free of bank conflicts), and the CTA then stores
// its contiguous slice of the output with coalesced writes. Every summand
// is an integer below 2^24, so the f32 sums are exact in any order and the
// result equals the four-prefix-sum plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;       // candidates per CTA, one per thread
constexpr int kStageMax = 8192;   // longest row staged in shared memory
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float rem_at(const float* row, int t, int tp) {
  return (unsigned)t < (unsigned)tp ? row[t] : 0.0f;
}

__device__ __forceinline__ float released(float x, float w) {
  return fminf(fmaxf(-x, 0.0f), w);
}

__device__ __forceinline__ float incurred(float x, float w) {
  return fminf(fmaxf(w - fmaxf(x, 0.0f), 0.0f), w);
}

// kMu > 0: mu is kMu; kMu == 0: mu is mu_rt. kStaged: the row is read from
// shared memory (Tp <= kStageMax), else from global memory.
template <int kMu, bool kStaged>
__global__ void __launch_bounds__(kBlock) gain_scan_kernel(
    const float* __restrict__ rem,     // [R, Tp]
    const int* __restrict__ start,     // [R, Np]
    const int* __restrict__ dur,       // [Np]
    const float* __restrict__ work,    // [Np]
    const float* __restrict__ lo_rel,  // [R, Np]
    const float* __restrict__ hi_rel,  // [R, Np]
    float* __restrict__ out,           // [R, Np, 2 mu + 1]
    int Np, int Tp, int mu_rt) {
  extern __shared__ __align__(16) float smem[];  // [row], [kBlock, 2 mu + 1]
  const int mu = kMu > 0 ? kMu : mu_rt;
  const int D = 2 * mu + 1;
  const int r = blockIdx.y;
  const int i0 = blockIdx.x * kBlock;
  const int i = i0 + threadIdx.x;
  const float* grow = rem + (long long)r * Tp;
  const float* row = grow;
  float* tile = smem;
  if (kStaged) {
    if ((Tp & 3) == 0 && (reinterpret_cast<uintptr_t>(grow) & 15) == 0) {
      const float4* src = reinterpret_cast<const float4*>(grow);
      float4* dst = reinterpret_cast<float4*>(smem);
      for (int j = threadIdx.x; j < Tp / 4; j += kBlock) dst[j] = src[j];
    } else {
      for (int j = threadIdx.x; j < Tp; j += kBlock) smem[j] = grow[j];
    }
    row = smem;
    tile = smem + ((Tp + 3) & ~3);
    __syncthreads();
  }
  float* mine = tile + threadIdx.x * D;

  if (i < Np) {
    const long long c = (long long)r * Np + i;
    const int s = start[c];
    const int d = dur[i];
    const int e = s + d;
    const float w = work[i];
    const float lo = lo_rel[c];
    const float hi = hi_rel[c];
    const bool has_work = w > 0.0f;
    mine[mu] = kNeg;                   // delta = 0 is never a move

    // delta = +k: vacate [s, s + ln), occupy [e + k - ln, e + k),
    // ln = min(k, d). rel = sum of released over the first ln units from s;
    // inc = IE(k) - IE(k - ln) with IE(m) the incurred sum over [e, e + m).
    // Unit s + k - 1 is vacated while k <= d and leaves IE's lag after.
    float rel = 0.0f, ie = 0.0f, ie_lag = 0.0f;
#pragma unroll
    for (int k = 1; k <= mu; ++k) {
      const float x = rem_at(row, s + k - 1, Tp);
      const float y = rem_at(row, e + k - 1, Tp);
      if (k <= d) rel += released(x, w); else ie_lag += incurred(x, w);
      ie += incurred(y, w);
      const float kf = (float)k;
      const bool legal = has_work && lo <= kf && kf <= hi;
      mine[mu + k] = legal ? rel - (ie - ie_lag) : kNeg;
    }
    // delta = -k: vacate [e - ln, e), occupy [s - k, s - k + ln).
    // rel = sum of released over the last ln units before e;
    // inc = IS(k) - IS(k - ln) with IS(m) the incurred sum over [s - m, s).
    // Unit e - k is vacated while k <= d and leaves IS's lag after.
    rel = 0.0f;
    float is = 0.0f, is_lag = 0.0f;
#pragma unroll
    for (int k = 1; k <= mu; ++k) {
      const float x = rem_at(row, e - k, Tp);
      const float y = rem_at(row, s - k, Tp);
      if (k <= d) rel += released(x, w); else is_lag += incurred(x, w);
      is += incurred(y, w);
      const float kf = -(float)k;
      const bool legal = has_work && lo <= kf && kf <= hi;
      mine[mu - k] = legal ? rel - (is - is_lag) : kNeg;
    }
  }
  __syncthreads();

  // the CTA's candidates are consecutive in one row, so its output is one
  // contiguous slice: store it with coalesced writes
  const int n_here = min(kBlock, Np - i0);
  float* dst = out + ((long long)r * Np + i0) * D;
  for (int j = threadIdx.x; j < n_here * D; j += kBlock) dst[j] = tile[j];
}

template <int kMu, bool kStaged>
int launch(const float* rem, const int* start, const int* dur,
           const float* work, const float* lo_rel, const float* hi_rel,
           float* out, int R, int Np, int Tp, int mu, cudaStream_t stream) {
  const int row = kStaged ? ((Tp + 3) & ~3) : 0;
  const size_t smem = (size_t)(row + kBlock * (2 * mu + 1)) * sizeof(float);
  auto kernel = gain_scan_kernel<kMu, kStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((Np + kBlock - 1) / kBlock), (unsigned)R);
  kernel<<<grid, kBlock, smem, stream>>>(rem, start, dur, work, lo_rel,
                                         hi_rel, out, Np, Tp, mu);
  return (int)cudaGetLastError();
}

template <int kMu>
int launch_mu(const float* rem, const int* start, const int* dur,
              const float* work, const float* lo_rel, const float* hi_rel,
              float* out, int R, int Np, int Tp, int mu,
              cudaStream_t stream) {
  return Tp <= kStageMax
      ? launch<kMu, true>(rem, start, dur, work, lo_rel, hi_rel, out, R, Np,
                          Tp, mu, stream)
      : launch<kMu, false>(rem, start, dur, work, lo_rel, hi_rel, out, R,
                           Np, Tp, mu, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue for more rows than a grid's y extent holds. The
// caller allocates `out` and checks shapes, dtypes, contiguity and
// 1 <= mu <= 42. mu = 1, 10 and 42 are compiled in (the loops unrolled);
// other values run the same code with mu at run time.
extern "C" int gain_scan_launch(const float* rem, const int* start,
                                const int* dur, const float* work,
                                const float* lo_rel, const float* hi_rel,
                                float* out, int R, int Np, int Tp, int mu,
                                void* stream) {
  if (R == 0 || Np == 0) return 0;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mu) {
    case 1:
      return launch_mu<1>(rem, start, dur, work, lo_rel, hi_rel, out, R, Np,
                          Tp, mu, st);
    case 10:
      return launch_mu<10>(rem, start, dur, work, lo_rel, hi_rel, out, R,
                           Np, Tp, mu, st);
    case 42:
      return launch_mu<42>(rem, start, dur, work, lo_rel, hi_rel, out, R,
                           Np, Tp, mu, st);
    default:
      return launch_mu<0>(rem, start, dur, work, lo_rel, hi_rel, out, R, Np,
                          Tp, mu, st);
  }
}
