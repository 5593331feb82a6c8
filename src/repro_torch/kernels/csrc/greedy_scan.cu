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
// steps: the kernel is latency-bound, far from that bound, and its design
// shortens the serial step.
//
// Design: one CTA per row, the step loop inside the block (it replaces
// lax.scan's sequential axis); 8 consumer warps run the steps and one
// producer warp feeds them. On an NVIDIA H100 80GB HBM3 (700 W) a step
// at the plan's largest bucket (R = 32, Np = 4352, Tp = 1024) takes about
// 1.06 us; 256 consumer threads measured faster there than 512 or 128.
//
// * A ring of kStages shared-memory stages, fed by the Tensor Memory
//   Accelerator. The lp row and column a step needs are known before the
//   step starts (v = order[r, t] dense, t - t0 blocked), so one producer
//   thread keeps the next stages' 1-D bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx) in flight, each stage with a
//   full and an empty mbarrier, while the consumers run the current step's
//   argmax. A stage holds `chunk` int32 of a row and of its column: the
//   whole row where it fits (Np = 4352: 34.8 KB a stage), else the row in
//   chunks that the relaxation walks in turn (Np = 30720). A bulk copy needs
//   16-byte-aligned addresses and sizes, so Np % 4 == 0 and lp, lp_t, est
//   and lst 16-byte aligned (the wrapper raises a ValueError otherwise; the
//   plan's buckets are multiples of 128). Each launch initialises its
//   barriers, so the phase bits start afresh in a chunk launch of fewer
//   steps than the ring is deep.
// * One block barrier a step. Each consumer thread owns the units
//   u = tid (mod 256) of rem and mask, and the groups of four tasks
//   q = tid (mod 256) of est and lst (read and written 16 bytes at a time,
//   two groups' loads in flight together): it reads its own units' argmax
//   candidates and updates its own units and groups, with no barrier
//   between them. The one barrier is the argmax's: warp results go to
//   slots double-buffered by t & 1, so the next step's slots cannot
//   overwrite a slot still being read. The next step's est[v'] and lst[v']
//   (v' = order[r, t + 1]) are not waited for: every thread reads the value
//   before this step's relaxation (or the owner's new one; both monotone,
//   either gives the same result) and applies this step's relaxation of v'
//   itself, from the stage it picks lp[v, v'] out of.
// * A 32-bit argmax: in a warp __reduce_max_sync of the value, then
//   __reduce_min_sync of the index among the lanes holding that maximum;
//   across warps one slot per warp, reduced the same way by every warp.
//   The first maximum wins, as in torch.argmax and jnp.argmax.
// * The step's inputs from device memory (order[r, t + 1], dur[v],
//   work[v]) are loaded at the top of the step and used after the argmax,
//   so their latency hides behind it (loading them a step earlier measured
//   no faster).
// * The row's rem [Tp], mask [Tp + 1], est and lst [Np] live in dynamic
//   shared memory (40.0 KB at Np = 4352, Tp = 1024); where they do not fit
//   beside the ring, est and lst (and, past that, rem and mask) are read
//   and written in device memory by the same code.
// * The launch is set up once: the device's shared-memory limit and the
//   kernel's shared-memory attribute are cached per device.
//
// At R = 32 rows a launch fills 32 of the 132 SMs; splitting a row over a
// cluster is left untried.

#include <cuda_runtime.h>

#include "tma.cuh"

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kConsumers = 256;              // threads that run the steps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kStages = 4;                   // ring depth
constexpr int kBig = INT_MAX / 4;            // greedy_scan._BIG
constexpr unsigned kAll = 0xFFFFFFFFu;
// barriers (full, empty) and the argmax slots, before the ring
constexpr int kHead = 128 * ((2 * kStages * 8 + 3 * 2 * kWarps * 4 + 127)
                             / 128);

// the consumers' block barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// four units' est = max(est, s + row), lst = min(lst, s - col)
__device__ __forceinline__ void relax4(int4& e, int4& l, const int4& a,
                                       const int4& b, int s) {
  e.x = max(e.x, s + a.x);
  e.y = max(e.y, s + a.y);
  e.z = max(e.z, s + a.z);
  e.w = max(e.w, s + a.w);
  l.x = min(l.x, s - b.x);
  l.y = min(l.y, s - b.y);
  l.z = min(l.z, s - b.z);
  l.w = min(l.w, s - b.w);
}

__device__ __forceinline__ int load_fresh(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
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
    int lp_rows, int by_task, int Np, int Tp, int t0, int t1, int chunk,
    int stage_time, int stage_tasks) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* slot_val = reinterpret_cast<int*>(smem + 2 * kStages * 8);
  int* slot_idx = slot_val + 2 * kWarps;
  int* slot_any = slot_idx + 2 * kWarps;
  int* ring = reinterpret_cast<int*>(smem + kHead);    // [kStages][2][chunk]
  unsigned char* cursor =
      reinterpret_cast<unsigned char*>(ring + 2 * kStages * chunk);
  const uint32_t full0 = smem_addr(smem);
  const uint32_t empty0 = full0 + 8 * kStages;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* order_r = order + (long long)r * Np;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  int* rem = g_rem + (long long)r * Tp;
  unsigned char* mask = g_mask + (long long)r * (Tp + 1);
  int* est = g_est + (long long)r * Np;
  int* lst = g_lst + (long long)r * Np;
  if (stage_tasks) {
    int* s_est = reinterpret_cast<int*>(cursor);
    int* s_lst = s_est + Np;
    for (int q = tid; q < Np / 4 && tid < kConsumers; q += kConsumers) {
      reinterpret_cast<int4*>(s_est)[q] = reinterpret_cast<int4*>(est)[q];
      reinterpret_cast<int4*>(s_lst)[q] = reinterpret_cast<int4*>(lst)[q];
    }
    est = s_est;
    lst = s_lst;
    cursor = reinterpret_cast<unsigned char*>(s_lst + Np);
  }
  if (stage_time) {
    int* s_rem = reinterpret_cast<int*>(cursor);
    unsigned char* s_mask = reinterpret_cast<unsigned char*>(s_rem + Tp);
    for (int u = tid; u <= Tp && tid < kConsumers; u += kConsumers) {
      if (u < Tp) s_rem[u] = rem[u];
      s_mask[u] = mask[u];
    }
    rem = s_rem;
    mask = s_mask;
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: lp's row and column of every step, chunk by chunk, into
    // the ring, as soon as the consumers have released the stage
    if (lane == 0) {
      const long long src = (long long)lp_of[r] * lp_rows;
      int slot = 0;
      uint32_t phase = 0;
      for (int j = 0; j < t1 - t0; ++j) {
        const long long k = src + (by_task ? order_r[t0 + j] : j);
        const int* row = lp + k * Np;
        const int* col = lp_t + k * Np;
        for (int base = 0; base < Np; base += chunk) {
          const uint32_t bytes = 4u * (uint32_t)min(chunk, Np - base);
          const int* dst = ring + 2 * slot * chunk;
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          mbar_expect_tx(full0 + 8 * slot, 2 * bytes);
          bulk_load(smem_addr(dst), row + base, bytes, full0 + 8 * slot);
          bulk_load(smem_addr(dst + chunk), col + base, bytes,
                    full0 + 8 * slot);
          if (++slot == kStages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int inst = inst_of[r];
  int* start_r = start + (long long)r * Np;
  const int* dur_i = dur + (long long)inst * Np;
  const int* work_i = work + (long long)inst * Np;
  int v = order_r[t0];
  int ev = est[v];
  int lv = lst[v];
  int slot = 0;
  uint32_t phase = 0;

  for (int t = t0; t < t1; ++t) {
    const int par = (t & 1) * kWarps;
    const int vn = t + 1 < t1 ? order_r[t + 1] : -1;
    const int d = dur_i[v];
    const int wv = work_i[v];

    // the first argmax of (feas ? rem : -BIG) over this thread's units,
    // then over the warp
    int best = INT_MIN, at = INT_MAX, found = 0;
#pragma unroll 4
    for (int u = tid; u < Tp; u += kConsumers) {
      const int f = mask[u] && u >= ev && u <= lv;
      const int val = f ? rem[u] : -kBig;
      if (at == INT_MAX || val > best) {
        best = val;
        at = u;
      }
      found |= f;
    }
    const int wbest = __reduce_max_sync(kAll, best);
    const int wat = __reduce_min_sync(kAll, best == wbest ? at : INT_MAX);
    const int wfound = __any_sync(kAll, found);
    if (lane == 0) {
      slot_val[par + warp] = wbest;
      slot_idx[par + warp] = wat;
      slot_any[par + warp] = wfound;
    }
    consumers_sync();

    // ... and over the block, by every warp from the slots
    const int cval = lane < kWarps ? slot_val[par + lane] : INT_MIN;
    const int cidx = lane < kWarps ? slot_idx[par + lane] : INT_MAX;
    const int cany = lane < kWarps ? slot_any[par + lane] : 0;
    const int bval = __reduce_max_sync(kAll, cval);
    const int bidx = __reduce_min_sync(kAll, cval == bval ? cidx : INT_MAX);
    const int s = __any_sync(kAll, cany) ? bidx : ev;
    // est[v'] and lst[v'] as the steps before this one left them (or as
    // the owner's relaxation below leaves them: the maximum and minimum
    // with this step's bound below give the same either way)
    const int en = vn >= 0 ? load_fresh(est + vn) : 0;
    const int ln = vn >= 0 ? load_fresh(lst + vn) : 0;
    const int e = s + d;

    const int lo = s > 0 ? s : 0;
    const int hi = e < Tp ? e : Tp;
    for (int u = lo + ((tid - lo) & (kConsumers - 1)); u < hi;
         u += kConsumers) {
      rem[u] -= wv;
    }
    // mask.at[s].set(True), an out-of-range s dropped; an end e marks a
    // candidate point only when e <= Tp (the padded horizon)
    if (s <= Tp && (lo & (kConsumers - 1)) == tid) mask[lo] = 1;
    if (e <= Tp && (e & (kConsumers - 1)) == tid) mask[e] = 1;
    if (tid == 0) start_r[v] = s;

    // relax est and lst through lp's row and column of v, stage by stage
    int an = INT_MIN, bn = INT_MAX;
    for (int base = 0; base < Np; base += chunk) {
      const int len = min(chunk, Np - base);
      const int* row = ring + 2 * slot * chunk;
      const int* col = row + chunk;
      mbar_wait(full0 + 8 * slot, phase);
      // groups of four units, 16-byte loads and stores (base and len are
      // multiples of 4), a thread owning the groups q = tid (mod
      // kConsumers); two groups at a time, every load before any store, so
      // that the loads are in flight together (est and lst may lie in
      // device memory)
      const int4* row4 = reinterpret_cast<const int4*>(row);
      const int4* col4 = reinterpret_cast<const int4*>(col);
      int4* est4 = reinterpret_cast<int4*>(est + base);
      int4* lst4 = reinterpret_cast<int4*>(lst + base);
      const int n4 = len / 4;
      for (int q = (tid - base / 4) & (kConsumers - 1); q < n4;
           q += 2 * kConsumers) {
        const int q1 = q + kConsumers < n4 ? q + kConsumers : q;
        const int4 a0 = row4[q], a1 = row4[q1];
        const int4 b0 = col4[q], b1 = col4[q1];
        int4 e0 = est4[q], e1 = est4[q1];
        int4 l0 = lst4[q], l1 = lst4[q1];
        relax4(e0, l0, a0, b0, s);
        relax4(e1, l1, a1, b1, s);
        est4[q] = e0;
        lst4[q] = l0;
        if (q1 != q) {
          est4[q1] = e1;
          lst4[q1] = l1;
        }
      }
      if (vn >= base && vn < base + len) {
        an = s + row[vn - base];
        bn = s - col[vn - base];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    if (vn >= 0) {
      v = vn;
      ev = en > an ? en : an;
      lv = ln < bn ? ln : bn;
    }
  }

  // each thread writes back the units it owns
  if (stage_time) {
    int* out_rem = g_rem + (long long)r * Tp;
    unsigned char* out_mask = g_mask + (long long)r * (Tp + 1);
    for (int u = tid; u <= Tp; u += kConsumers) {
      if (u < Tp) out_rem[u] = rem[u];
      out_mask[u] = mask[u];
    }
  }
  if (stage_tasks) {
    int4* out_est = reinterpret_cast<int4*>(g_est + (long long)r * Np);
    int4* out_lst = reinterpret_cast<int4*>(g_lst + (long long)r * Np);
    for (int q = tid; q < Np / 4; q += kConsumers) {
      out_est[q] = reinterpret_cast<int4*>(est)[q];
      out_lst[q] = reinterpret_cast<int4*>(lst)[q];
    }
  }
}

struct Plan {
  int stage_tasks, stage_time, chunk;
  size_t smem;
};

// What shared memory holds for (Np, Tp) under a limit of `optin` bytes: the
// ring first at a floor of 1024 int32 a stage, then the row's state where
// it fits (est and lst with rem and mask, else rem and mask alone), then
// the ring widened to the whole row, or as far as the rest allows.
Plan make_plan(int Np, int Tp, int optin) {
  const size_t stage_int = 2 * kStages * sizeof(int);   // ring bytes/chunk
  const size_t tasks = 2 * (size_t)Np * sizeof(int);
  const size_t timeline = (size_t)Tp * sizeof(int) + (size_t)Tp + 1;
  const size_t least = stage_int * (size_t)(Np < 1024 ? Np : 1024);
  const size_t room = (size_t)optin > kHead + least
      ? (size_t)optin - kHead - least : 0;
  Plan p{0, 0, 0, 0};
  size_t state = 0;
  if (tasks + timeline <= room) {
    p.stage_tasks = p.stage_time = 1;
    state = tasks + timeline;
  } else if (timeline <= room) {
    p.stage_time = 1;
    state = timeline;
  }
  const size_t left = (size_t)optin - kHead - state;
  size_t chunk = (left / stage_int) & ~(size_t)3;
  if (chunk > (size_t)Np) chunk = (size_t)Np;
  p.chunk = (int)chunk;
  p.smem = kHead + stage_int * chunk + state;
  return p;
}

SmemAttribute g_smem;

}  // namespace

// The plan the kernel uses for (Np, Tp) on device `dev`, written to
// out[0..3]: stage_tasks, stage_time, the ring's chunk in int32, the
// dynamic shared memory in bytes; out[4] the ring's depth. Returns a CUDA
// error code (0 = ok).
extern "C" int greedy_scan_plan(int Np, int Tp, int dev, long long* out) {
  int optin = 0;
  cudaError_t err = optin_of(dev, &optin);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(Np, Tp, optin);
  out[0] = p.stage_tasks;
  out[1] = p.stage_time;
  out[2] = p.chunk;
  out[3] = (long long)p.smem;
  out[4] = kStages;
  return 0;
}

// Launch on `stream` (of device `dev`, the current device): steps [t0, t1)
// of every row's order, one CTA a row. by_task != 0: the dense form,
// lp/lp_t [S, Np, Np] looked up at row (lp_of[r], v) with lp_rows = Np;
// by_task == 0: the blocked form, the chunk's rows/cols [S, lp_rows, Np]
// looked up at (lp_of[r], t - t0). The state (rem, mask, est, lst) is
// updated in place, start written at each placed task. Returns
// cudaGetLastError() after the launch (0 = ok). The caller checks shapes,
// dtypes, devices and contiguity, Np % 4 == 0 and lp/lp_t 16-byte aligned
// (the ring's bulk copies need both); an Np the ring cannot take returns
// cudaErrorInvalidValue.
extern "C" int greedy_scan_launch(int* rem, unsigned char* mask, int* est,
                                  int* lst, int* start, const int* order,
                                  const int* dur, const int* work,
                                  const int* inst_of, const int* lp,
                                  const int* lp_t, const int* lp_of,
                                  int lp_rows, int by_task, int R, int Np,
                                  int Tp, int t0, int t1, int dev,
                                  void* stream) {
  if (R == 0 || t1 <= t0) return 0;
  if (Np % 4 != 0) return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = optin_of(dev, &optin);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(Np, Tp, optin);
  if (p.chunk < 4) return (int)cudaErrorInvalidValue;
  err = g_smem.allow((const void*)greedy_scan_kernel, dev, p.smem);
  if (err != cudaSuccess) return (int)err;
  greedy_scan_kernel<<<(unsigned)R, kThreads, p.smem,
                       (cudaStream_t)stream>>>(
      rem, mask, est, lst, start, order, dur, work, inst_of, lp, lp_t, lp_of,
      lp_rows, by_task, Np, Tp, t0, t1, p.chunk, p.stage_time,
      p.stage_tasks);
  return (int)cudaGetLastError();
}
