// One round of the device climb's top-K commit scan for Hopper (sm_90a).
//
// Replaces the XLA loop src/repro/core/local_search_jax.py::commit_step
// under lax.scan (:232, inside the climb's lax.while_loop at :239); it is no
// Pallas kernel in the reference, but in eager PyTorch each commit costs
// some 40 launches. For each live row r it walks the row's proposals in
// gain order, v = order[r, j] for j < K, and for each task:
//
//   dlo   = max(0, max over preds u of start[u] + dur[u])
//   dhi   = min(t_real, min over succs u of start[u]) - dur[v]
//   new_s = min(max(start[v] + best_delta[v], dlo), dhi)   (hi wins)
//   released = sum of min(max(-rem, 0), w) over the vacated units,
//   incurred = sum of min(max(w - max(rem, 0), 0), w) over the newly
//   occupied ones (the symmetric difference of the old and new windows)
//   ok    = best_gain[v] > 0 & dlo <= dhi & new_s != s
//           & released - incurred > 0
//
// and commits under ok: rem += w on the old window and -= w on the new one,
// start[v] = new_s. The predecessors and successors come from the dense
// form's bool rows pred[v], succ[v] [Np, Np], or from the padded CSR tables
// pidx/pok, sidx/sok [Np, D] (the blocked-lp instances' form). Every value
// is int32 as in the port's plain version; the two sums are int64, as
// torch's sum of int32 is. A row stops at its first proposal whose best
// gain is not positive: the order is a stable descending sort of the gains,
// so every later proposal has ok false too. That is the plain version's
// cut at the largest count of positive proposals, and needs no host sync.
//
// Bound on this card: a commit reads its task's adjacency rows (2 Np bytes
// dense, 10 D bytes padded) and at most 2 (d + mu) timeline units, and
// does O(Np) (dense) or O(D) (padded) int32 operations: a round is some
// K (2 Np) bytes and operations a row, microseconds of work at the card's
// rates. Each commit depends on the ones before it in its row, so a row is
// K serial steps, each with three block barriers: latency-bound.
//
// Design: one CTA per row; the row's rem [Tp] and start [Np] are staged in
// shared memory (21.0 KB at Np = 4352, Tp = 1024; in device memory where
// they do not fit); the bounds and the two sums are block reductions (warp
// shuffles, then one slot per warp). A dead row does nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) commit_scan_kernel(
    int* g_rem,                          // [R, Tp]  in place
    int* g_start,                        // [R, Np]  in place
    unsigned char* __restrict__ any_out, // [R]
    const int* __restrict__ order,       // [R, K]
    const int* __restrict__ best_delta,  // [R, Np]
    const float* __restrict__ best_gain, // [R, Np]
    const unsigned char* __restrict__ live,  // [R]
    const int* __restrict__ dur,         // [Np]
    const int* __restrict__ work,        // [Np]
    const unsigned char* __restrict__ pred,  // [Np, Np] or null
    const unsigned char* __restrict__ succ,  // [Np, Np] or null
    const int* __restrict__ pidx,        // [Np, D] or null
    const unsigned char* __restrict__ pok,
    const int* __restrict__ sidx,
    const unsigned char* __restrict__ sok,
    int D, int Np, int Tp, int K, int t_real, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* red_lo = reinterpret_cast<int*>(smem);
  int* red_hi = red_lo + kWarps;
  long long* red_rel = reinterpret_cast<long long*>(red_hi + kWarps);
  long long* red_inc = red_rel + kWarps;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (!live[r]) {
    if (tid == 0) any_out[r] = 0;
    return;
  }

  int* rem = g_rem + (long long)r * Tp;
  int* start = g_start + (long long)r * Np;
  if (stage) {
    int* s_rem = reinterpret_cast<int*>(red_inc + kWarps);
    int* s_start = s_rem + Tp;
    for (int u = tid; u < Tp; u += kThreads) s_rem[u] = rem[u];
    for (int u = tid; u < Np; u += kThreads) s_start[u] = start[u];
    rem = s_rem;
    start = s_start;
  }
  __syncthreads();

  const int* order_r = order + (long long)r * K;
  const int* delta_r = best_delta + (long long)r * Np;
  const float* gain_r = best_gain + (long long)r * Np;
  bool any = false;
  for (int j = 0; j < K; ++j) {
    const int v = order_r[j];
    if (!(gain_r[v] > 0.0f)) break;           // the same for every thread
    const int s = start[v];
    const int d = dur[v];
    const int w = work[v];
    const int e = s + d;

    // current bounds: commits earlier in this scan may have moved the
    // neighbours
    int lo = INT_MIN, hi = INT_MAX;
    if (pred != nullptr) {
      const unsigned char* prow = pred + (long long)v * Np;
      const unsigned char* srow = succ + (long long)v * Np;
      for (int u = tid; u < Np; u += kThreads) {
        const int a = prow[u] ? start[u] + dur[u] : 0;
        const int b = srow[u] ? start[u] : t_real;
        lo = a > lo ? a : lo;
        hi = b < hi ? b : hi;
      }
    } else {
      const long long base = (long long)v * D;
      for (int c = tid; c < D; c += kThreads) {
        const int pu = pidx[base + c];
        const int su = sidx[base + c];
        const int a = pok[base + c] ? start[pu] + dur[pu] : 0;
        const int b = sok[base + c] ? start[su] : t_real;
        lo = a > lo ? a : lo;
        hi = b < hi ? b : hi;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = max(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
      hi = min(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
    }
    if (lane == 0) {
      red_lo[warp] = lo;
      red_hi[warp] = hi;
    }
    __syncthreads();
    lo = red_lo[0];
    hi = red_hi[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) {
      lo = max(lo, red_lo[q]);
      hi = min(hi, red_hi[q]);
    }
    const int dlo = lo;
    const int dhi = hi - d;
    const int new_s = min(max(s + delta_r[v], dlo), dhi);
    const int dd = new_s - s;
    const int ln = min(dd < 0 ? -dd : dd, d);
    const int vac_lo = dd > 0 ? s : e - ln;
    const int occ_hi = dd > 0 ? new_s + d : new_s + ln;

    // released over [vac_lo, vac_lo + ln), incurred over
    // [occ_hi - ln, occ_hi), both inside [0, Tp)
    long long rel = 0, inc = 0;
    for (int u = max(vac_lo, 0) + tid; u < min(vac_lo + ln, Tp);
         u += kThreads) {
      rel += min(max(-rem[u], 0), w);
    }
    for (int u = max(occ_hi - ln, 0) + tid; u < min(occ_hi, Tp);
         u += kThreads) {
      inc += min(max(w - max(rem[u], 0), 0), w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      rel += __shfl_xor_sync(0xFFFFFFFFu, rel, o);
      inc += __shfl_xor_sync(0xFFFFFFFFu, inc, o);
    }
    if (lane == 0) {
      red_rel[warp] = rel;
      red_inc[warp] = inc;
    }
    __syncthreads();
    rel = red_rel[0];
    inc = red_inc[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) {
      rel += red_rel[q];
      inc += red_inc[q];
    }
    const bool ok = dlo <= dhi && dd != 0 && rel - inc > 0;
    if (ok) {
      // rem += w * (old - new) over the union of the two windows, one
      // thread a unit
      const int ua = max(min(s, new_s), 0);
      const int ub = min(max(e, new_s + d), Tp);
      for (int u = ua + tid; u < ub; u += kThreads) {
        const int was = (u >= s && u < e) ? 1 : 0;
        const int now = (u >= new_s && u < new_s + d) ? 1 : 0;
        rem[u] += w * (was - now);
      }
      if (tid == 0) start[v] = new_s;
      any = true;
    }
    __syncthreads();
  }

  if (stage) {
    int* out_rem = g_rem + (long long)r * Tp;
    int* out_start = g_start + (long long)r * Np;
    for (int u = tid; u < Tp; u += kThreads) out_rem[u] = rem[u];
    for (int u = tid; u < Np; u += kThreads) out_start[u] = start[u];
  }
  if (tid == 0) any_out[r] = any ? 1 : 0;
}

}  // namespace

// Launch on `stream`: one round's commit scan of every row, one CTA a row.
// Dense adjacency: pred/succ non-null, pidx/pok/sidx/sok null; padded: the
// other way round, D their width. rem and start are updated in place and
// any_out[r] says whether row r committed anything (0 for a dead row).
// Returns cudaGetLastError() after the launch (0 = ok). The caller checks
// shapes, dtypes, devices and contiguity.
extern "C" int commit_scan_launch(int* rem, int* start,
                                  unsigned char* any_out, const int* order,
                                  const int* best_delta,
                                  const float* best_gain,
                                  const unsigned char* live, const int* dur,
                                  const int* work,
                                  const unsigned char* pred,
                                  const unsigned char* succ, const int* pidx,
                                  const unsigned char* pok, const int* sidx,
                                  const unsigned char* sok, int D, int R,
                                  int Np, int Tp, int K, int t_real,
                                  void* stream) {
  if (R == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t base = kWarps * (2 * sizeof(int) + 2 * sizeof(long long));
  const size_t row = ((size_t)Tp + (size_t)Np) * sizeof(int);
  const int stage = base + row <= (size_t)optin ? 1 : 0;
  const size_t smem = base + (stage ? row : 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(commit_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  commit_scan_kernel<<<(unsigned)R, kThreads, smem, (cudaStream_t)stream>>>(
      rem, start, any_out, order, best_delta, best_gain, live, dur, work,
      pred, succ, pidx, pok, sidx, sok, D, Np, Tp, K, t_real, stage);
  return (int)cudaGetLastError();
}
