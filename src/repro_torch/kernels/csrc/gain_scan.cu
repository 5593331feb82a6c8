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
// per-candidate inputs (start, lo_rel, hi_rel, plus the shared dur/work);
// at R = 32, Np = 4352, mu = 10 that is about 14 MB per climb round, and a
// handful of operations per byte. The TPU kernel read two pre-gathered
// [R * Np, 128] f32 windows per candidate (about 70 MB each at that size).
//
// Design: the gather is fused. One thread owns one candidate and walks the
// 2 mu shifts with running sums, reading only the 4 mu timeline units it
// needs straight from rem (which stays in L1/L2: R * Tp * 4 bytes), so no
// window tensor is ever written. Each thread parks its 2 mu + 1 gains in
// shared memory (the stride 2 mu + 1 is odd, so the writes are free of bank
// conflicts), and the block then stores its contiguous slice of the output
// with coalesced writes. Every summand is an integer below 2^24, so the f32
// sums are exact in any order and the result equals the four-prefix-sum
// plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float rem_at(const float* __restrict__ row, int t,
                                        int tp) {
  return (t >= 0 && t < tp) ? row[t] : 0.0f;
}

__device__ __forceinline__ float released(float x, float w) {
  return fminf(fmaxf(-x, 0.0f), w);
}

__device__ __forceinline__ float incurred(float x, float w) {
  return fminf(fmaxf(w - fmaxf(x, 0.0f), 0.0f), w);
}

__global__ void __launch_bounds__(kBlock) gain_scan_kernel(
    const float* __restrict__ rem,     // [R, Tp]
    const int* __restrict__ start,     // [R, Np]
    const int* __restrict__ dur,       // [Np]
    const float* __restrict__ work,    // [Np]
    const float* __restrict__ lo_rel,  // [R, Np]
    const float* __restrict__ hi_rel,  // [R, Np]
    float* __restrict__ out,           // [R, Np, 2 mu + 1]
    int R, int Np, int Tp, int mu) {
  extern __shared__ float tile[];      // [kBlock, 2 mu + 1]
  const int D = 2 * mu + 1;
  const long long total = (long long)R * Np;
  const long long base = (long long)blockIdx.x * kBlock;
  const long long c = base + threadIdx.x;
  float* mine = tile + threadIdx.x * D;

  if (c < total) {
    const int r = (int)(c / Np);
    const int i = (int)(c - (long long)r * Np);
    const float* row = rem + (long long)r * Tp;
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
    float rel = 0.0f, ie = 0.0f, ie_lag = 0.0f;
    for (int k = 1; k <= mu; ++k) {
      if (k <= d) rel += released(rem_at(row, s + k - 1, Tp), w);
      ie += incurred(rem_at(row, e + k - 1, Tp), w);
      if (k > d) ie_lag += incurred(rem_at(row, e + k - d - 1, Tp), w);
      const float kf = (float)k;
      const bool legal = has_work && lo <= kf && kf <= hi;
      mine[mu + k] = legal ? rel - (ie - ie_lag) : kNeg;
    }
    // delta = -k: vacate [e - ln, e), occupy [s - k, s - k + ln).
    // rel = sum of released over the last ln units before e;
    // inc = IS(k) - IS(k - ln) with IS(m) the incurred sum over [s - m, s).
    rel = 0.0f;
    float is = 0.0f, is_lag = 0.0f;
    for (int k = 1; k <= mu; ++k) {
      if (k <= d) rel += released(rem_at(row, e - k, Tp), w);
      is += incurred(rem_at(row, s - k, Tp), w);
      if (k > d) is_lag += incurred(rem_at(row, s - k + d, Tp), w);
      const float kf = -(float)k;
      const bool legal = has_work && lo <= kf && kf <= hi;
      mine[mu - k] = legal ? rel - (is - is_lag) : kNeg;
    }
  }
  __syncthreads();

  // the block's candidates are consecutive, so its output is one
  // contiguous slice: store it with coalesced writes
  const long long left = total - base;
  const int n_here = left < kBlock ? (int)left : kBlock;
  float* dst = out + base * D;
  for (int j = threadIdx.x; j < n_here * D; j += kBlock) dst[j] = tile[j];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// The caller allocates `out` and checks shapes, dtypes and contiguity.
extern "C" int gain_scan_launch(const float* rem, const int* start,
                                const int* dur, const float* work,
                                const float* lo_rel, const float* hi_rel,
                                float* out, int R, int Np, int Tp, int mu,
                                void* stream) {
  const long long total = (long long)R * Np;
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + kBlock - 1) / kBlock);
  const size_t smem = (size_t)kBlock * (2 * mu + 1) * sizeof(float);
  gain_scan_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      rem, start, dur, work, lo_rel, hi_rel, out, R, Np, Tp, mu);
  return (int)cudaGetLastError();
}
