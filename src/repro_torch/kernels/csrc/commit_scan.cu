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
// at most K serial commits: latency-bound.
//
// Design: one CTA of 8 warps per row. Warp 0 commits; warps 1-7 gather
// the bounds of the next proposal meanwhile. Iteration j of the row's loop
// is: the scan warps gather proposal j's bounds over its preds and succs
// (warp reductions, one part a warp), while the commit warp combines
// proposal j - 1's parts and commits it (warp reductions, the int64 sum
// through __reduce_add_sync where every lane's part is small, else
// shuffles); one block barrier ends the iteration. A commit changes one
// start, start[v_{j-1}], so the scan of proposal j leaves that task out
// and flags whether it is a pred or succ; the commit warp adds it from its
// final start. Parts are double-buffered by j & 1. On an NVIDIA H100 80GB
// HBM3 (700 W), at the plan's largest bucket, a round takes about 0.033 ms
// dense and 0.025 ms padded (32 commits a row).
//
// * At the start the commit warp reads the row's first K proposals, their
//   shifts and works into shared memory and finds n, the count of leading
//   positive gains; all warps stage rem [Tp], start [Np] and dur [Np] in
//   shared memory (38.4 KB at Np = 4352, Tp = 1024; in device memory where
//   they do not fit).
// * Dense form: the proposals' pred and succ rows (Np bytes each) come
//   through a ring of up to kStages shared-memory stages fed by the Tensor
//   Memory Accelerator (1-D bulk copies, a full mbarrier a stage). The
//   tasks order[r, j] are known at launch, so the first stages are in
//   flight while the row is staged, and the stage of proposal j is refilled
//   with proposal j + stages as soon as its scan is done. Only the n
//   proposals that will be visited are ever loaded, so nothing waits on a
//   stage that is never filled. A bulk copy needs Np % 16 == 0 and
//   16-byte aligned rows (the wrapper raises a ValueError otherwise; the
//   plan's buckets are multiples of 128). The rows are read 16 bytes a lane
//   and zero words skipped (a DAG's rows are sparse); a nonzero word's four
//   tasks are read with no branch on its bytes.
// * Padded form: the rows (D int32 and D bytes each; 8 bytes for a pok row
//   at D = 8, too short and unaligned for a bulk copy) are read by the
//   scan warps from device memory directly, one entry a lane, while the
//   commit warp commits the proposal before.
// * The launch is set up once: the device's shared-memory limit and the
//   kernel's shared-memory attribute are cached per device.
//
// A dead row does nothing.

#include <cuda_runtime.h>

#include "tma.cuh"

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // warp 0 commits, the rest scan
constexpr int kScanWarps = kThreads / 32 - 1;
constexpr int kScanLanes = 32 * kScanWarps;
constexpr int kStages = 8;          // dense rows in flight, at most
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kHead = 128;          // full barriers and the count n
constexpr int kPartBytes = 2 * kScanWarps * 24;   // two Parts a scan warp

// the warp's int64 sum: 32-bit where no lane's part can carry it out
__device__ __forceinline__ long long warp_sum(long long x) {
  if (__all_sync(kAll, x >= -(1LL << 25) && x <= (1LL << 25)))
    return __reduce_add_sync(kAll, (int)x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// bit 7 of each byte of the result set where that byte of x is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// What a scanning thread gathers of one proposal's adjacency: the max over
// its preds u of start[u] + dur[u] and the min over its succs of start[u]
// (the task `ux` left out: its commit may be under way), the counts of
// pred and succ entries (dense form), and whether `ux` is a pred or succ.
struct Part {
  int lo, hi, n_p, n_s, x_p, x_s;
};
static_assert(2 * kScanWarps * sizeof(Part) == kPartBytes, "parts' room");

// the contribution of four tasks u0..u0+3 through a word of the pred row
// (p) and of the succ row (q); the eight loads go out together, with no
// branch on the bytes
__device__ __forceinline__ void scan_word(uint32_t p, uint32_t q, int u0,
                                          int ux, const int* start,
                                          const int* dur, Part& g) {
  const uint32_t np = nonzero_bytes(p);
  const uint32_t ns = nonzero_bytes(q);
  if ((np | ns) == 0) return;
  int su[4], du[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    su[b] = start[u0 + b];
    du[b] = dur[u0 + b];
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t bit = 0x80u << (8 * b);
    const bool left_out = u0 + b == ux;
    const bool pb = (np & bit) != 0;
    const bool sb = (ns & bit) != 0;
    const int a = pb && !left_out ? su[b] + du[b] : INT_MIN;
    const int c = sb && !left_out ? su[b] : INT_MAX;
    g.lo = a > g.lo ? a : g.lo;
    g.hi = c < g.hi ? c : g.hi;
    g.x_p |= pb && left_out;
    g.x_s |= sb && left_out;
  }
  g.n_p += __popc(np);
  g.n_s += __popc(ns);
}

__global__ void __launch_bounds__(kThreads) commit_scan_kernel(
    int* g_rem,                          // [R, Tp]  in place
    int* g_start,                        // [R, Np]  in place
    unsigned char* __restrict__ any_out, // [R]
    const int* __restrict__ order,       // [R, K]
    const int* __restrict__ best_delta,  // [R, Np]
    const float* __restrict__ best_gain, // [R, Np]
    const unsigned char* __restrict__ live,  // [R]
    const int* __restrict__ g_dur,       // [Np]
    const int* __restrict__ work,        // [Np]
    const unsigned char* __restrict__ pred,  // [Np, Np] or null
    const unsigned char* __restrict__ succ,  // [Np, Np] or null
    const int* __restrict__ pidx,        // [Np, D] or null
    const unsigned char* __restrict__ pok,
    const int* __restrict__ sidx,
    const unsigned char* __restrict__ sok,
    int D, int Np, int Tp, int K, int t_real, int stages, int stage_state,
    int stage_dur) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_addr(smem);
  int* s_n = reinterpret_cast<int*>(smem + 8 * kStages);
  Part* parts = reinterpret_cast<Part*>(smem + kHead);   // [2][kScanWarps]
  int* s_v = reinterpret_cast<int*>(smem + kHead + kPartBytes);   // [K]
  int* s_delta = s_v + K;                                          // [K]
  int* s_w = s_delta + K;                                          // [K]
  unsigned char* ring = smem + kHead + kPartBytes
      + 16 * ((12 * (size_t)K + 15) / 16);   // [stages][pred, succ row]
  const bool dense = pred != nullptr;
  unsigned char* cursor = ring + (dense ? 2 * (size_t)stages * Np : 0);

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (!live[r]) {
    if (tid == 0) any_out[r] = 0;
    return;
  }

  const int* order_r = order + (long long)r * K;
  if (warp == 0) {
    // the proposals, and n: the first j whose gain is not positive
    const int* delta_r = best_delta + (long long)r * Np;
    const float* gain_r = best_gain + (long long)r * Np;
    int n = K;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      int stop = 0;
      if (j < K) {
        const int v = order_r[j];
        stop = !(gain_r[v] > 0.0f);
        s_v[j] = v;
        s_delta[j] = delta_r[v];
        s_w[j] = work[v];
      }
      const unsigned b = __ballot_sync(kAll, stop);
      if (b) {
        n = j0 + __ffs(b) - 1;
        break;
      }
    }
    __syncwarp();
    if (lane == 0) {
      *s_n = n;
      if (dense) {
        for (int s = 0; s < stages; ++s) mbar_init(full0 + 8 * s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int j = 0; j < n && j < stages; ++j) {
          const uint32_t dst = smem_addr(ring + 2 * (size_t)j * Np);
          const long long at = (long long)s_v[j] * Np;
          mbar_expect_tx(full0 + 8 * j, 2 * Np);
          bulk_load(dst, pred + at, Np, full0 + 8 * j);
          bulk_load(dst + Np, succ + at, Np, full0 + 8 * j);
        }
      }
    }
  }

  int* rem = g_rem + (long long)r * Tp;
  int* start = g_start + (long long)r * Np;
  const int* dur = g_dur;
  if (stage_state) {
    int* s_rem = reinterpret_cast<int*>(cursor);
    int* s_start = s_rem + Tp;
    for (int u = tid; u < Tp; u += kThreads) s_rem[u] = rem[u];
    for (int u = tid; u < Np; u += kThreads) s_start[u] = start[u];
    rem = s_rem;
    start = s_start;
    cursor = reinterpret_cast<unsigned char*>(s_start + Np);
  }
  if (stage_dur) {
    int* s_dur = reinterpret_cast<int*>(cursor);
    for (int u = tid; u < Np; u += kThreads) s_dur[u] = g_dur[u];
    dur = s_dur;
  }
  __syncthreads();
  const int n = *s_n;

  // Iteration j: the scanning warps gather proposal j's bounds, while the
  // commit warp commits proposal j - 1; one block barrier ends it.
  bool any = false;
  const int scan_lane = tid - 32;                 // 0 .. kScanLanes - 1
  for (int j = 0; j <= n; ++j) {
    if (warp > 0 && j < n) {
      const int v = s_v[j];
      const int ux = j > 0 ? s_v[j - 1] : -1;     // its commit is under way
      Part g{INT_MIN, INT_MAX, 0, 0, 0, 0};
      if (dense) {
        const int slot = j % stages;
        mbar_wait(full0 + 8 * slot, (uint32_t)(j / stages) & 1);
        const uint4* prow = reinterpret_cast<const uint4*>(
            ring + 2 * (size_t)slot * Np);
        const int nq = Np / 16;
        const uint4* srow = prow + nq;
        for (int q0 = scan_lane; q0 < nq; q0 += 2 * kScanLanes) {
          const int q1 = q0 + kScanLanes;
          const uint4 p0 = prow[q0], c0 = srow[q0];
          const uint4 p1 = q1 < nq ? prow[q1] : make_uint4(0, 0, 0, 0);
          const uint4 c1 = q1 < nq ? srow[q1] : make_uint4(0, 0, 0, 0);
          if (p0.x | p0.y | p0.z | p0.w | c0.x | c0.y | c0.z | c0.w) {
            scan_word(p0.x, c0.x, 16 * q0, ux, start, dur, g);
            scan_word(p0.y, c0.y, 16 * q0 + 4, ux, start, dur, g);
            scan_word(p0.z, c0.z, 16 * q0 + 8, ux, start, dur, g);
            scan_word(p0.w, c0.w, 16 * q0 + 12, ux, start, dur, g);
          }
          if (p1.x | p1.y | p1.z | p1.w | c1.x | c1.y | c1.z | c1.w) {
            scan_word(p1.x, c1.x, 16 * q1, ux, start, dur, g);
            scan_word(p1.y, c1.y, 16 * q1 + 4, ux, start, dur, g);
            scan_word(p1.z, c1.z, 16 * q1 + 8, ux, start, dur, g);
            scan_word(p1.w, c1.w, 16 * q1 + 12, ux, start, dur, g);
          }
        }
      } else {
        const long long base = (long long)v * D;
        for (int c = scan_lane; c < D; c += kScanLanes) {
          const int pu = pidx[base + c];
          const int su = sidx[base + c];
          const bool pk = pok[base + c] != 0;
          const bool sk = sok[base + c] != 0;
          // an entry that is no edge contributes 0 (t_real); ux's edge is
          // left to the commit warp
          const int a = !pk ? 0 : pu == ux ? INT_MIN : start[pu] + dur[pu];
          const int b = !sk ? t_real : su == ux ? INT_MAX : start[su];
          g.lo = a > g.lo ? a : g.lo;
          g.hi = b < g.hi ? b : g.hi;
          g.x_p |= pk && pu == ux;
          g.x_s |= sk && su == ux;
        }
      }
      g.lo = __reduce_max_sync(kAll, g.lo);
      g.hi = __reduce_min_sync(kAll, g.hi);
      g.n_p = __reduce_add_sync(kAll, g.n_p);
      g.n_s = __reduce_add_sync(kAll, g.n_s);
      g.x_p = __any_sync(kAll, g.x_p);
      g.x_s = __any_sync(kAll, g.x_s);
      if (lane == 0) parts[(j & 1) * kScanWarps + warp - 1] = g;
    }
    if (warp == 0 && j > 0) {
      const int c = j - 1;                        // the proposal committed
      if (dense && lane == 0 && c + stages < n) {
        // proposal c's stage was read before the last barrier: refill it
        const int slot = c % stages;
        const uint32_t dst = smem_addr(ring + 2 * (size_t)slot * Np);
        const long long at = (long long)s_v[c + stages] * Np;
        mbar_expect_tx(full0 + 8 * slot, 2 * Np);
        bulk_load(dst, pred + at, Np, full0 + 8 * slot);
        bulk_load(dst + Np, succ + at, Np, full0 + 8 * slot);
      }
      const int v = s_v[c];
      const int w = s_w[c];
      const int s = start[v];
      const int d = dur[v];
      const int e = s + d;
      // current bounds: the scanning warps' parts, then the proposal
      // committed just before (its start is final now)
      Part g{INT_MIN, INT_MAX, 0, 0, 0, 0};
      if (lane < kScanWarps) g = parts[(c & 1) * kScanWarps + lane];
      int lo = __reduce_max_sync(kAll, g.lo);
      int hi = __reduce_min_sync(kAll, g.hi);
      const int n_p = __reduce_add_sync(kAll, g.n_p);
      const int n_s = __reduce_add_sync(kAll, g.n_s);
      if (__any_sync(kAll, g.x_p)) {
        const int ux = s_v[c - 1];
        const int a = start[ux] + dur[ux];
        lo = a > lo ? a : lo;
      }
      if (__any_sync(kAll, g.x_s)) {
        const int b = start[s_v[c - 1]];
        hi = b < hi ? b : hi;
      }
      if (dense) {
        // a task that is no pred (no succ) of v contributes 0 (t_real)
        if (n_p < Np) lo = lo > 0 ? lo : 0;
        if (n_s < Np) hi = hi < t_real ? hi : t_real;
      }
      const int dlo = lo;
      const int dhi = hi - d;
      const int new_s = min(max(s + s_delta[c], dlo), dhi);
      const int dd = new_s - s;
      const int ln = min(dd < 0 ? -dd : dd, d);
      const int vac_lo = dd > 0 ? s : e - ln;
      const int occ_hi = dd > 0 ? new_s + d : new_s + ln;

      // released over [vac_lo, vac_lo + ln) less incurred over
      // [occ_hi - ln, occ_hi), both inside [0, Tp)
      long long gain = 0;
      for (int u = max(vac_lo, 0) + lane; u < min(vac_lo + ln, Tp);
           u += 32) {
        gain += min(max(-rem[u], 0), w);
      }
      for (int u = max(occ_hi - ln, 0) + lane; u < min(occ_hi, Tp);
           u += 32) {
        gain -= min(max(w - max(rem[u], 0), 0), w);
      }
      gain = warp_sum(gain);
      if (dlo <= dhi && dd != 0 && gain > 0) {
        // rem += w * (old - new) over the union of the two windows
        const int ua = max(min(s, new_s), 0);
        const int ub = min(max(e, new_s + d), Tp);
        for (int u = ua + lane; u < ub; u += 32) {
          const int was = (u >= s && u < e) ? 1 : 0;
          const int now = (u >= new_s && u < new_s + d) ? 1 : 0;
          rem[u] += w * (was - now);
        }
        if (lane == 0) start[v] = new_s;
        any = true;
      }
    }
    __syncthreads();
  }

  if (stage_state) {
    int* out_rem = g_rem + (long long)r * Tp;
    int* out_start = g_start + (long long)r * Np;
    for (int u = tid; u < Tp; u += kThreads) out_rem[u] = rem[u];
    for (int u = tid; u < Np; u += kThreads) out_start[u] = start[u];
  }
  if (tid == 0) any_out[r] = any ? 1 : 0;
}

struct Plan {
  int stages, stage_state, stage_dur;
  size_t smem;
};

// What shared memory holds under a limit of `optin` bytes: the parts and
// the proposals, then (dense form) up to kStages ring stages of 2 Np bytes,
// then the row's rem and start where they fit, then dur where it fits.
Plan make_plan(bool dense, int Np, int Tp, int K, int optin) {
  Plan p{0, 0, 0, 0};
  size_t used = kHead + kPartBytes + 16 * ((12 * (size_t)K + 15) / 16);
  const size_t limit = (size_t)optin;
  if (used >= limit) return p;
  if (dense) {
    const size_t per = 2 * (size_t)Np;
    const size_t s = per ? (limit - used) / per : (size_t)kStages;
    p.stages = (int)(s < (size_t)kStages ? s : (size_t)kStages);
    used += per * p.stages;
  }
  const size_t state = ((size_t)Tp + (size_t)Np) * sizeof(int);
  if (used + state <= limit) {
    p.stage_state = 1;
    used += state;
  }
  const size_t durb = (size_t)Np * sizeof(int);
  if (used + durb <= limit) {
    p.stage_dur = 1;
    used += durb;
  }
  p.smem = used;
  return p;
}

SmemAttribute g_smem;

}  // namespace

// Launch on `stream` (of device `dev`, the current device): one round's
// commit scan of every row, one CTA a row. Dense adjacency: pred/succ
// non-null, pidx/pok/sidx/sok null; padded: the other way round, D their
// width. rem and start are updated in place and any_out[r] says whether
// row r committed anything (0 for a dead row). Returns cudaGetLastError()
// after the launch (0 = ok). The caller checks shapes, dtypes, devices and
// contiguity, and, for the dense form, Np % 16 == 0 and pred/succ 16-byte
// aligned (the ring's bulk copies need both); adjacency rows the shared
// memory cannot take return cudaErrorInvalidValue.
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
                                  int Np, int Tp, int K, int t_real, int dev,
                                  void* stream) {
  if (R == 0) return 0;
  const bool dense = pred != nullptr;
  if (dense && Np % 16 != 0) return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = optin_of(dev, &optin);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(dense, Np, Tp, K, optin);
  if (dense && p.stages < 1) return (int)cudaErrorInvalidValue;
  err = g_smem.allow((const void*)commit_scan_kernel, dev, p.smem);
  if (err != cudaSuccess) return (int)err;
  commit_scan_kernel<<<(unsigned)R, kThreads, p.smem, (cudaStream_t)stream>>>(
      rem, start, any_out, order, best_delta, best_gain, live, dur, work,
      pred, succ, pidx, pok, sidx, sok, D, Np, Tp, K, t_real, p.stages,
      p.stage_state, p.stage_dur);
  return (int)cudaGetLastError();
}
