// The §5.2 greedy's placement scan for Hopper (sm_90a).
//
// Replaces the XLA loop src/repro/core/greedy_jax.py::_placement_step under
// lax.scan (the dense scan at :320, the chunked blocked scan at :423); it is
// no Pallas kernel in the reference, but in eager PyTorch the scan costs
// some 35 launches a placement step. For each row r (one (instance,
// profile, variant) schedule) and each step t of the launch, v = order[r, t]:
//
//   feas  = mask[:Tp] & (est[v] <= u <= lst[v])
//   s     = the FIRST u maximising (feas ? rem[u] : -BIG), if any u is
//           feasible, else est[v]
//   rem[u] -= work[v] on [s, s + dur[v])
//   mask[clamp(s, 0, Tp)] |= (s <= Tp);  mask[min(e, Tp)] |= (e <= Tp)
//   est = max(est, s + lp[v, :]);  lst = min(lst, s - lp[:, v])
//   start[v] = s
//
// all in int32, as the reference and the port's plain version compute it.
// lp's row v and column v come from lp and its contiguous transpose lp_t
// (dense form: [I, Np, Np], looked up by the row's instance and v), or, in
// the blocked form, from the chunk's streamed rows/cols ([V, B, Np], looked
// up by the row's variant and the step's place in the chunk). One step body
// serves both forms, so the blocked form cannot drift from the dense one.
//
// Bound on this card: per launch the function must read its instance's lp
// once (Np^2 int32: 75.8 MB at Np = 4352, 0.023 ms at 3.35 TB/s; row v and
// column v over all v are lp once, and lp_t is only the port's layout for
// coalesced column reads) and do R Np (Tp + 2 Np) int32 operations
// (0.020 ms at R = 32, Tp = 1024 at the f32 CUDA-core rate): memory, on
// paper. The steps of a row depend on each other, so a row is Np serial
// steps, each with two block barriers and a dependent read of lp's row and
// column (2 Np int32, which L2 does not hold across 32 rows: 151.5 MB a
// row) after the argmax: the kernel is latency-bound, far from that bound.
//
// Design, simple first: one CTA per row, the step loop inside the block (it
// replaces lax.scan's sequential axis). The row's rem [Tp], mask [Tp + 1],
// est and lst [Np] live in dynamic shared memory (40.0 KB at Np = 4352,
// Tp = 1024); where they do not fit, est and lst (and, past that, rem and
// mask) are read and written in device memory instead by the same code. The
// argmax is a block reduction over 64-bit keys (value high, the complement
// of the index low), so the lower index wins ties, as jnp.argmax and
// torch.argmax take the first max. At R = 32 rows a launch one CTA a row
// fills 32 of the 132 SMs; splitting a row over a cluster is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = INT_MAX / 4;     // greedy_scan._BIG

__device__ __forceinline__ long long argmax_key(int val, int idx) {
  return (long long)val * 4294967296LL
      + (long long)(0xFFFFFFFFu - (unsigned)idx);
}

__device__ __forceinline__ int key_index(long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFLL));
}

__global__ void __launch_bounds__(kThreads) greedy_scan_kernel(
    int* g_rem,                      // [R, Tp]       state, in place
    unsigned char* g_mask,           // [R, Tp + 1]   state, in place
    int* g_est,                      // [R, Np]       state, in place
    int* g_lst,                      // [R, Np]       state, in place
    int* __restrict__ start,         // [R, Np]       written at each v
    const int* __restrict__ order,   // [R, Np]       placement orders
    const int* __restrict__ dur,     // [I, Np]
    const int* __restrict__ work,    // [I, Np]
    const int* __restrict__ inst_of, // [R]           row -> instance
    const int* __restrict__ lp,      // [S, lp_rows, Np]  lp rows
    const int* __restrict__ lp_t,    // [S, lp_rows, Np]  lp columns
    const int* __restrict__ lp_of,   // [R]           row -> lp source
    int lp_rows, int by_task, int Np, int Tp, int t0, int t1,
    int stage_time, int stage_tasks) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* red_key = reinterpret_cast<long long*>(smem);
  int* red_any = reinterpret_cast<int*>(red_key + kWarps);
  unsigned char* cursor = reinterpret_cast<unsigned char*>(red_any + kWarps);

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int* rem = g_rem + (long long)r * Tp;
  unsigned char* mask = g_mask + (long long)r * (Tp + 1);
  int* est = g_est + (long long)r * Np;
  int* lst = g_lst + (long long)r * Np;
  if (stage_tasks) {
    int* s_est = reinterpret_cast<int*>(cursor);
    int* s_lst = s_est + Np;
    for (int u = tid; u < Np; u += kThreads) {
      s_est[u] = est[u];
      s_lst[u] = lst[u];
    }
    est = s_est;
    lst = s_lst;
    cursor = reinterpret_cast<unsigned char*>(s_lst + Np);
  }
  if (stage_time) {
    int* s_rem = reinterpret_cast<int*>(cursor);
    unsigned char* s_mask = reinterpret_cast<unsigned char*>(s_rem + Tp);
    for (int u = tid; u < Tp; u += kThreads) s_rem[u] = rem[u];
    for (int u = tid; u <= Tp; u += kThreads) s_mask[u] = mask[u];
    rem = s_rem;
    mask = s_mask;
  }
  __syncthreads();

  const int inst = inst_of[r];
  const long long src = (long long)lp_of[r] * lp_rows;
  const int* order_r = order + (long long)r * Np;
  int* start_r = start + (long long)r * Np;
  const int* dur_i = dur + (long long)inst * Np;
  const int* work_i = work + (long long)inst * Np;

  for (int t = t0; t < t1; ++t) {
    const int v = order_r[t];
    const int ev = est[v];
    const int lv = lst[v];
    // first argmax of (feas ? rem : -BIG) over all Tp units, and whether
    // any unit is feasible
    long long best = LLONG_MIN;
    int found = 0;
    for (int u = tid; u < Tp; u += kThreads) {
      const bool f = mask[u] && u >= ev && u <= lv;
      const long long key = argmax_key(f ? rem[u] : -kBig, u);
      best = key > best ? key : best;
      found |= f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_xor_sync(0xFFFFFFFFu, best, o);
      best = other > best ? other : best;
    }
    found = __any_sync(0xFFFFFFFFu, found);
    if (lane == 0) {
      red_key[warp] = best;
      red_any[warp] = found;
    }
    __syncthreads();
    best = red_key[0];
    found = red_any[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      best = red_key[w] > best ? red_key[w] : best;
      found |= red_any[w];
    }
    const int s = found ? key_index(best) : ev;
    const int d = dur_i[v];
    const int wv = work_i[v];
    const int e = s + d;

    const int lo = s > 0 ? s : 0;
    const int hi = e < Tp ? e : Tp;
    for (int u = lo + tid; u < hi; u += kThreads) rem[u] -= wv;

    const long long k = src + (by_task ? v : t - t0);
    const int* row = lp + k * Np;
    const int* col = lp_t + k * Np;
    for (int u = tid; u < Np; u += kThreads) {
      const int a = s + row[u];
      const int b = s - col[u];
      if (a > est[u]) est[u] = a;
      if (b < lst[u]) lst[u] = b;
    }
    if (tid == 0) {
      // mask.at[s].set(True), an out-of-range s dropped; an end e marks a
      // candidate point only when e <= Tp (the padded horizon)
      if (s <= Tp) mask[s < 0 ? 0 : s] = 1;
      if (e <= Tp) mask[e] = 1;
      start_r[v] = s;
    }
    __syncthreads();
  }

  int* out_rem = g_rem + (long long)r * Tp;
  unsigned char* out_mask = g_mask + (long long)r * (Tp + 1);
  int* out_est = g_est + (long long)r * Np;
  int* out_lst = g_lst + (long long)r * Np;
  if (stage_time) {
    for (int u = tid; u < Tp; u += kThreads) out_rem[u] = rem[u];
    for (int u = tid; u <= Tp; u += kThreads) out_mask[u] = mask[u];
  }
  if (stage_tasks) {
    for (int u = tid; u < Np; u += kThreads) {
      out_est[u] = est[u];
      out_lst[u] = lst[u];
    }
  }
}

}  // namespace

// Launch on `stream`: steps [t0, t1) of every row's order, one CTA a row.
// by_task != 0: the dense form, lp/lp_t [S, Np, Np] looked up at row
// (lp_of[r], v) with lp_rows = Np; by_task == 0: the blocked form, the
// chunk's rows/cols [S, lp_rows, Np] looked up at (lp_of[r], t - t0). The
// state (rem, mask, est, lst) is updated in place, start written at each
// placed task. Returns cudaGetLastError() after the launch (0 = ok). The
// caller checks shapes, dtypes, devices and contiguity.
extern "C" int greedy_scan_launch(int* rem, unsigned char* mask, int* est,
                                  int* lst, int* start, const int* order,
                                  const int* dur, const int* work,
                                  const int* inst_of, const int* lp,
                                  const int* lp_t, const int* lp_of,
                                  int lp_rows, int by_task, int R, int Np,
                                  int Tp, int t0, int t1, void* stream) {
  if (R == 0 || t1 <= t0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t base = kWarps * (sizeof(long long) + sizeof(int));
  const size_t tasks = 2 * (size_t)Np * sizeof(int);
  const size_t timeline = (size_t)Tp * sizeof(int) + (size_t)Tp + 1;
  size_t smem = base;
  int stage_tasks = 0, stage_time = 0;
  if (smem + tasks + timeline <= (size_t)optin) {
    stage_tasks = stage_time = 1;
    smem += tasks + timeline;
  } else if (smem + timeline <= (size_t)optin) {
    stage_time = 1;
    smem += timeline;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(greedy_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_scan_kernel<<<(unsigned)R, kThreads, smem,
                       (cudaStream_t)stream>>>(
      rem, mask, est, lst, start, order, dur, work, inst_of, lp, lp_t, lp_of,
      lp_rows, by_task, Np, Tp, t0, t1, stage_time, stage_tasks);
  return (int)cudaGetLastError();
}
