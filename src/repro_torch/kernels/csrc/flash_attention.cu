// Fused forward attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (line 33, launched by flash_attention). It computes what repro's
// flash_attention computes: for q, k, v of shape [B, S, H, hd] (kv heads
// already expanded),
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
//
// over the keys j < S (and j <= i when causal), with scale = hd^-0.5 (in
// f32) applied after the dot, the running max starting at -1e30, f32
// running max, sum and output accumulator, masked scores contributing an
// explicit 0, and the result acc / max(l, 1e-30) rounded once to the input
// type. hd is 64 or 128. Two kernels compute it, one per input type:
//
// * bf16: flash_fwd_kernel_wgmma, on the tensor cores.
// * f32: flash_fwd_kernel, on the CUDA cores (TF32 would keep about three
//   decimal digits and break the 2e-5 f32 tolerance).
//
// Bound on this card: operations. A causal pass does about 2 B H S^2 hd
// flops (QK^T and PV over the lower triangle): 34.4 GFLOP at B = 4, S =
// 2048, H = 16, hd = 64, some 0.035 ms at the bf16 tensor-core peak (989
// TFLOP/s), while it must move only 4 B S H hd * 2 bytes (67 MB, 0.020 ms at
// 3.35 TB/s). In f32 the same flops take 0.51 ms at the CUDA cores' 67
// TFLOP/s.
//
// The bf16 kernel is the Hopper flash form. One CTA per (128-query tile,
// b·h) of three warpgroups: two consumers own 64 query rows each, and one
// thread of the producer warpgroup issues every load. The producer gives
// its registers up (setmaxnreg, 24 a thread) so the consumers may hold 240:
// with 9 warps or more one SM sub-partition hosts three, which caps a kernel
// without setmaxnreg at 168 registers, and the hd = 64 consumer spills
// there. Q arrives once by TMA; K and V tiles of kBK keys (128 for hd 64, 64
// for hd 128, whose O fragment is twice as large) go through a kStages-deep
// ring in shared memory, fed by cp.async.bulk.tensor under a full and an
// empty mbarrier per stage. The tensor maps are 4-D over (hd, H, S, B) with
// the tensors' own byte strides, so q, k, v unbound from one
// [B, S, 3, H, hd] projection reach the kernel with no copy, and use the
// 128-byte swizzle (hd 128 is two 64-column panels). S = Q K^T is wgmma
// m64n{kBK}k16 with Q and K read through shared-memory descriptors; the
// online softmax runs on the accumulator fragment (row max and sum over the
// four threads of a row by shuffles, one FFMA and one ex2 a score, with
// scale * log2(e) folded in); O += P V is wgmma m64n{hd}k16 with P in
// registers as the A operand and V read through a descriptor with the
// transpose bit (V is hd-contiguous, MN-major), so V needs no transpose
// pass. Within a warpgroup, QK^T of tile t and PV of tile t - 1 are issued
// together and the softmax of t runs while the PV product does (P is
// double-buffered). Key tiles wholly above the diagonal are never loaded,
// and only tiles on the diagonal or the ragged S edge run the masked
// softmax; TMA zero-fills rows past S. The epilogue stages the bf16 tile in
// the warpgroup's own Q rows (consumed by then) and writes it with one TMA
// store per panel, which clips rows past S. The grid launches the longest
// query tiles first. At hd = 64 the exponentials (16 a clock per SM) take
// about as long as the products; scheduling the two consumer warpgroups in
// turn and a persistent grid are the next steps.
//
// One numerical choice differs from the reference kernel: P is rounded to
// bf16 before the PV product (f32 accumulation), as the tensor cores take
// it. The reference's own model attention does the same
// (src/repro/models/layers.py:134, softmax(...).astype(v.dtype)); the sum l
// stays the f32 sum of the unrounded P. The kernel stays within the
// reference sweep's 2e-2 bf16 tolerance of the f32 definition.
//
// The f32 kernel is the simple form: one CTA per (64-query tile, b·h) walks
// its key tiles; each thread owns one query row's kDT = 64 head dims (hd =
// 128 takes two threads per row, which combine their partial dots with one
// shuffle), with its q slice and output accumulator in registers. K and V
// tiles of 64 rows are staged through shared memory as f32 (padded rows, so
// two threads of one query row read different banks), every thread reads
// each staged row as a broadcast, and the online-softmax update runs once
// per kChunk = 8 keys. It reads [B, S, H, hd] through its strides,
// zero-fills and masks keys at the ragged S edge, stops each warp at the
// last key any of its rows can see when causal, and launches the longest
// query tiles first. Issue slots, not bytes, set its time.

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // queries per CTA
constexpr int kBK = 64;       // keys per shared-memory tile
constexpr int kDT = 64;       // head dims per thread
constexpr int kChunk = 8;     // keys per online-softmax update
constexpr float kNeg = -1e30f;

struct Strides {              // element strides of the b, s and h axes
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {           // 16 bytes = 4 f32
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <int HD>
constexpr int smem_bytes() {  // K and V tiles, f32, rows padded by 4
  return 2 * kBK * (HD + 4) * (int)sizeof(float);
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBQ * (HD / kDT)) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, int H, Strides st, float scale) {
  constexpr int kTPR = HD / kDT;         // threads per query row
  constexpr int kThreads = kBQ * kTPR;
  constexpr int kLD = HD + 4;            // shared row stride, in floats
  constexpr int kVN = Vec<T>::kN;
  constexpr int kPerRow = HD / kVN;      // 16-byte vectors per key row
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBK * kLD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest tiles first
  const int row = threadIdx.x / kTPR;
  const int part = threadIdx.x % kTPR;
  const int qpos = q0 + row;
  const bool live = qpos < S;
  // the last query row any lane of this warp holds: keys past it are
  // masked for the whole warp
  const int warp_last = q0 + ((threadIdx.x | 31) / kTPR);

  float qr[kDT];
  {
    const T* src = q + b * st.qb + (long long)min(qpos, S - 1) * st.qs +
                   h * st.qh + part * kDT;
#pragma unroll
    for (int i = 0; i < kDT; i += kVN) Vec<T>::load(src + i, qr + i);
  }
  float acc[kDT];
#pragma unroll
  for (int i = 0; i < kDT; ++i) acc[i] = 0.0f;
  float m = kNeg;
  float l = 0.0f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = CAUSAL ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow;
      const int c = (idx % kPerRow) * kVN;
      const int key = k0 + r;
      float kb[kVN], vb[kVN];
      if (key < S) {
        Vec<T>::load(k + b * st.kb + (long long)key * st.ks + h * st.kh + c,
                     kb);
        Vec<T>::load(v + b * st.vb + (long long)key * st.vs + h * st.vh + c,
                     vb);
      } else {                           // ragged S edge: zero rows
#pragma unroll
        for (int i = 0; i < kVN; ++i) kb[i] = vb[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kVN; i += 4) {
        *reinterpret_cast<float4*>(ks + r * kLD + c + i) =
            make_float4(kb[i], kb[i + 1], kb[i + 2], kb[i + 3]);
        *reinterpret_cast<float4*>(vs + r * kLD + c + i) =
            make_float4(vb[i], vb[i + 1], vb[i + 2], vb[i + 3]);
      }
    }
    __syncthreads();

    const int n_keys = min(kBK, S - k0);
    for (int j0 = 0; j0 < n_keys; j0 += kChunk) {
      if (CAUSAL && k0 + j0 > warp_last) break;       // warp-uniform
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* kr = ks + (j0 + c) * kLD + part * kDT;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kDT; i += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + i);
          dot = fmaf(qr[i], kv.x, dot);
          dot = fmaf(qr[i + 1], kv.y, dot);
          dot = fmaf(qr[i + 2], kv.z, dot);
          dot = fmaf(qr[i + 3], kv.w, dot);
        }
        s[c] = dot;
      }
#pragma unroll
      for (int off = 1; off < kTPR; off <<= 1) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
      }
      unsigned valid = 0;
      float cmax = kNeg;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int key = k0 + j0 + c;
        const bool ok = key < S && (!CAUSAL || key <= qpos);
        s[c] = ok ? s[c] * scale : kNeg;
        valid |= (ok ? 1u : 0u) << c;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] = ((valid >> c) & 1u) ? expf(s[c] - m_new) : 0.0f;
        psum += s[c];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < kDT; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* vr = vs + (j0 + c) * kLD + part * kDT;
#pragma unroll
        for (int i = 0; i < kDT; i += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + i);
          acc[i] = fmaf(s[c], vv.x, acc[i]);
          acc[i + 1] = fmaf(s[c], vv.y, acc[i + 1]);
          acc[i + 2] = fmaf(s[c], vv.z, acc[i + 2]);
          acc[i + 3] = fmaf(s[c], vv.w, acc[i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* dst = o + b * st.ob + (long long)qpos * st.os + h * st.oh + part * kDT;
#pragma unroll
    for (int i = 0; i < kDT; i += kVN) {
      float buf[kVN];
#pragma unroll
      for (int j = 0; j < kVN; ++j) buf[j] = acc[i + j] / denom;
      Vec<T>::store(dst + i, buf);
    }
    // the row's log-sum-exp of the scaled scores; m is in natural units
    if (lse != nullptr && part == 0)
      lse[((long long)b * H + h) * S + qpos] = m + logf(l);
  }
}

template <typename T, int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, const Strides& st, float scale,
           cudaStream_t stream) {
  constexpr int kThreads = kBQ * (HD / kDT);
  constexpr int kSmem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD, CAUSAL>;
  // dynamic shared memory above 48 KB is opted into once per device
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((attr_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= 1ull << dev;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, st, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_causal(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int H, int causal,
                  const Strides& st, float scale, cudaStream_t stream) {
  return causal ? launch<T, HD, true>(q, k, v, o, lse, B, S, H, st, scale,
                                      stream)
                : launch<T, HD, false>(q, k, v, o, lse, B, S, H, st, scale,
                                       stream);
}

// ---- bf16: wgmma products fed by a TMA ring ----------------------------

constexpr int kWgBQ = 128;            // queries per CTA (two warpgroups of 64)
constexpr int kStages = 3;            // depth of the K/V ring
constexpr int kConsumers = 256;       // threads of the consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after the split: the producer gives most of its share
// to the consumers (24 + 2 x 240 of 512 a warp triple on each SMSP)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int HD>
struct Layout {                       // shared memory, in bytes from a
  static constexpr int kBK = HD == 64 ? 128 : 64;   // 1024-aligned base
  static constexpr int kPanels = HD / 64;           // 64-column panels
  static constexpr int kQPanel = kWgBQ * 128;       // one panel of Q
  static constexpr int kKVPanel = kBK * 128;        // one panel of K or V
  static constexpr int kTile = kPanels * kKVPanel;  // one K or V tile
  static constexpr int kK = kPanels * kQPanel;      // the K ring
  static constexpr int kV = kK + kStages * kTile;   // the V ring
  static constexpr int kBar = kV + kStages * kTile; // full[], empty[], q
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of the 4-D map at (hd, h, s, b) into shared memory, completing
// its bytes on `bar`; rows past S arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory to the 4-D map at (hd, h, s, b); rows past S
// are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset `lbo` (ignored for K-major operands; for the
// MN-major V the distance between 64-column panels) and a stride of 1024
// bytes between groups of 8 rows, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups are in flight (they complete in
// the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma m64nNk16, f32 accumulators, bf16 operands. Fragment of d in each
// thread (warp w of the warpgroup, lane = 4 g + t): d[4 j + e] is row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  // d (+)= a b^T: a, b K-major in shared memory (descriptors)
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d += a b: a in registers (bf16 pairs), b MN-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // d (+)= a b^T: a, b K-major in shared memory (descriptors)
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d += a b: a in registers (bf16 pairs), b MN-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// f32 fragment values x[8 kk .. 8 kk + 7] as the bf16 A operand of k-step kk
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// d (+)= a b^T over HD for two K-major operands of 64-column panels: a's
// rows at `a` (panel stride pa), b's at `b` (panel stride pb)
template <int N, int HD>
__device__ __forceinline__ void mma_abt(float (&d)[N / 2], uint32_t a,
                                        int pa, uint32_t b, int pb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {    // 16 head dims a k-step
    const uint32_t col = (kk % 4) * 32;      // within a 64-column panel
    Mma<N>::ss(d, sw128_desc(a + (kk / 4) * pa + col, 16),
               sw128_desc(b + (kk / 4) * pb + col, 16), kk > 0);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step, in base 2, on the raw scores sc (q . k) of the
// key tile at k0 in this thread's fragment (rows row0 and row0 + 8):
// updates the running max m (of score * scale * log2 e) and this thread's
// shares l of the row sums, sets corr to the factor that rescales O, and
// leaves P rounded to bf16 in pa, the A fragments of the PV product (their
// layout is the accumulator's, 16 keys a k-step). MASK: the tile holds
// keys past S or above the diagonal; they contribute an explicit 0.
template <int BK, bool MASK, bool CAUSAL>
__device__ __forceinline__ void softmax_step(
    float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&m)[2],
    float (&l)[2], float (&corr)[2], float sl2, int k0, int S, int row0,
    int t4) {
  auto visible = [&](int i) {   // key and row of sc[i]
    const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
    return key < S && (!CAUSAL || key <= row0 + 8 * ((i / 2) & 1));
  };
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (MASK && !visible(i)) sc[i] = kNeg;
    mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // the four threads of a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) & 1;
    float p = ex2(fmaf(sc[i], sl2, -m[r]));
    if (MASK && !visible(i)) p = 0.0f;
    psum[r] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
  pack_a<BK>(pa, sc);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_kernel_wgmma(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap, float* __restrict__ lse, int S,
    int H, float scale) {
  using L = Layout<HD>;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;  // longest first
  const int q_last = min(q0 + kWgBQ, S) - 1;
  // key tiles wholly above the diagonal are never loaded
  const int n_tiles = CAUSAL ? q_last / BK + 1 : (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {    // the producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, kWgBQ * HD * 2);
      for (int p = 0; p < L::kPanels; ++p)
        for (int half = 0; half < 2; ++half)
          tma_load(sq + p * L::kQPanel + half * 64 * 128, &qmap, qbar,
                   64 * p, h, q0 + 64 * half, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(empty + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * L::kTile);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(sk + st * L::kTile + p * L::kKVPanel, &kmap, full + 8 * st,
                   64 * p, h, t * BK, b);
          tma_load(sv + st * L::kTile + p * L::kKVPanel, &vmap, full + 8 * st,
                   64 * p, h, t * BK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = threadIdx.x / 128;   // consumer warpgroup: 64 query rows
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wg_first = q0 + 64 * wg;
  const int wg_last = wg_first + 63;
  const int row0 = wg_first + 16 * warp + g;   // rows row0 and row0 + 8
  const float sl2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
  const uint32_t qa = sq + wg * 64 * 128;      // this warpgroup's Q rows
  // when causal, tiles wholly above this warpgroup's rows are consumed
  // without a product
  const int n_mine = CAUSAL ? min(n_tiles, wg_last / BK + 1) : n_tiles;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
  uint32_t pa[2][BK / 16][4];   // P of two consecutive tiles
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};    // this thread's share of the row sums
  float corr[2];

  // S = Q K^T of the tile in stage st, issued and committed, not waited for
  auto issue_qk = [&](int st) {
    mma_abt<BK, HD>(s, qa, L::kQPanel, sk + st * L::kTile, L::kKVPanel);
    wgmma_commit();
  };
  // the softmax of the key tile at k0 into P fragments p; edge tiles (keys
  // past S or above a row of this warpgroup) are masked
  auto softmax = [&](uint32_t (&p)[BK / 16][4], int k0) {
    if (k0 + BK > S || (CAUSAL && k0 + BK - 1 > wg_first))
      softmax_step<BK, true, CAUSAL>(s, p, m, l, corr, sl2, k0, S, row0, t4);
    else
      softmax_step<BK, false, CAUSAL>(s, p, m, l, corr, sl2, k0, S, row0, t4);
  };
  // O += P V of the tile in stage st, committed, not waited for
  auto issue_pv = [&](const uint32_t (&p)[BK / 16][4], int st) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)     // 16 keys a k-step
      Mma<HD>::rs(o, p[kk], sw128_desc(sv + st * L::kTile + kk * 16 * 128,
                                       L::kKVPanel));
    wgmma_commit();
  };
  // tile t: QK^T of t and PV of t - 1 go in flight together, and the
  // softmax of t runs while the PV product does
  auto step = [&](int t, const uint32_t (&prev)[BK / 16][4],
                  uint32_t (&cur)[BK / 16][4]) {
    const int st = t % kStages;
    const int sp = (t - 1) % kStages;
    mbar_wait(full + 8 * st, (t / kStages) & 1);
    fence_regs(o);
    fence_regs(s);
    wgmma_fence();
    issue_qk(st);
    issue_pv(prev, sp);
    wgmma_wait<1>();                         // QK^T is done
    fence_regs(s);
    softmax(cur, t * BK);
    wgmma_wait<0>();                         // and PV
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sp);   // tile t - 1 is consumed
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j + 0] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  mbar_wait(qbar, 0);
  mbar_wait(full, 0);
  fence_regs(s);
  wgmma_fence();
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(pa[0], 0);
  for (int t = 1; t < n_mine; t += 2) {   // two steps: the P buffers swap
    step(t, pa[0], pa[1]);
    if (t + 1 < n_mine) step(t + 1, pa[1], pa[0]);
  }
  {
    const int st = (n_mine - 1) % kStages;   // the last tile's PV
    fence_regs(o);
    wgmma_fence();
    if ((n_mine - 1) & 1)
      issue_pv(pa[1], st);
    else
      issue_pv(pa[0], st);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  for (int t = n_mine; t < n_tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(full + 8 * st, (t / kStages) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: acc / max(l, 1e-30) in bf16, staged in this warpgroup's Q
  // rows in the TMA's 128-byte swizzle, then one TMA store per panel
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  // the rows' log-sum-exp of the scaled scores: m is in log2 units (sl2
  // folds log2 e in), so lse = (m + log2 l) ln 2; one lane a row writes
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S)
        lse[((long long)b * H + h) * S + row] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      const uint32_t addr = qa + (j / 8) * L::kQPanel + r * 128 +
                            (((j % 8) ^ (r & 7)) << 4) + 4 * t4;
      const uint32_t val = pack_bf16(o[4 * j + 2 * half] / den[half],
                                     o[4 * j + 2 * half + 1] / den[half]);
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (tid == 0) {
    for (int p = 0; p < L::kPanels; ++p)
      tma_store(&omap, qa + p * L::kQPanel, 64 * p, h, wg_first, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime, so the library
// needs no -lcuda
cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// the map of one [B, S, H, hd] bf16 tensor as 4-D (hd, H, S, B) with its
// element strides `st` (b, s, h), boxes of 64 head dims x `rows` rows
CUresult encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                    int B, int S, int H, int hd, const long long* st,
                    int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD, bool CAUSAL>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int H, const long long* strides,
                 float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  auto kernel = flash_fwd_kernel_wgmma<HD, CAUSAL>;
  EncodeTiled encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const int rows[4] = {64, L::kBK, L::kBK, 64};
  for (int i = 0; i < 4; ++i) {
    const CUresult res = encode_map(encode, &maps[i], ptrs[i], B, S, H, HD,
                                    strides + 3 * i, rows[i]);
    if (res != CUDA_SUCCESS) return -(int)res;
  }
  // dynamic shared memory above 48 KB is opted into once per device
  static unsigned long long attr_set = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((attr_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set |= 1ull << dev;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kWgBQ - 1) / kWgBQ));
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], lse, S, H, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wgmma_causal(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int H, int causal,
                        const long long* strides, float scale,
                        cudaStream_t stream) {
  return causal ? launch_wgmma<HD, true>(q, k, v, o, lse, B, S, H, strides,
                                         scale, stream)
                : launch_wgmma<HD, false>(q, k, v, o, lse, B, S, H, strides,
                                          scale, stream);
}


// ---- backward: FlashAttention-2 in two deterministic passes -------------
//
// Given q, k, v, the forward's output o and row log-sum-exp lse (natural
// units, [B, H, S] f32) and the output gradient g = dL/do, the gradients
// are, with P = exp(scale q k^T - lse) (masked entries 0),
//
//   D = rowsum(g o),  dv = P^T g,  dP = g v^T,  dS = P (dP - D),
//   dq = scale dS k,  dk = scale dS^T q.
//
// flash_bwd_dot writes D (a row's 16-byte loads across 4 to 32 lanes of a
// warp, so every lane has a whole 16 bytes of o and of g in flight); for
// bf16 it also writes lse in
// log2 units, both into rows padded to a multiple of 128 (D = 0 and lse =
// +inf past S, so a padded query row has P = 0). Then a dK/dV pass and a
// dQ pass: the dK/dV pass gives each CTA a tile of keys of one (b, h),
// holds K and V and walks the query tiles (from the diagonal on when
// causal), accumulating dK and dV; the dQ pass gives each CTA a tile of
// queries, holds Q, g, lse and D and walks the key tiles up to the
// diagonal, accumulating dQ. Each gradient is summed by one CTA in a fixed
// order and written once: no atomics, the same bits on every run. Both
// passes recompute QK^T and g V^T (seven products against the bound's
// five; a one-pass form with an atomic dQ would give other bits each run).
//
// Bound on this card: operations, the five products QK^T, g V^T, P^T g,
// dS^T q and dS k over the visible (q, k) pairs (0.087 ms in bf16 at B = 4,
// S = 2048, H = 16, hd = 64, causal, at 989 TFLOP/s; 1.28 ms at the f32
// rate). Two kernels each pass, one per input type:
//
// * bf16: flash_bwd_dkdv_wgmma and flash_bwd_dq_wgmma, on the tensor
//   cores, built as the forward's wgmma kernel is: three warpgroups, one
//   producer thread issuing TMA loads (4-D maps over the tensors' strides,
//   128-byte swizzle, rows past S zero-filled) into a kBwdStages-deep ring
//   under full and empty mbarriers, setmaxnreg moving registers to the two
//   consumer warpgroups. dK/dV pass: 128 keys a CTA, 64 per consumer
//   warpgroup, K and V resident; the ring brings 64-query tiles of Q and
//   g with their lse and D rows (cp.async.bulk). With keys as wgmma's M,
//   S^T = K Q^T and dP^T = V g^T are m64n64 products from shared memory;
//   P^T = exp2(S^T scale log2 e - lse log2 e) runs on the fragment (masked
//   above the diagonal on diagonal tiles only); dV += P^T g and dK += dS^T
//   Q take P^T and dS^T = P^T (dP^T - D), rounded to bf16, as register A
//   operands, with g and Q read MN-major through a transposed descriptor,
//   as the forward's P V reads V. P never goes through shared memory. dQ
//   pass: 128 queries a CTA, Q and g resident, lse and D in registers; the
//   ring brings K and V tiles (128 keys at hd 64, 64 at hd 128); S = Q K^T
//   and dP = g V^T from shared memory, dQ += dS K with dS in registers and
//   K MN-major. Keys past S are masked on the ragged tile. Each epilogue
//   scales, rounds, stages the tile in the warpgroup's own consumed rows
//   and writes it with TMA stores, which clip rows past S. Both grids
//   launch the longest walks first. A warpgroup's products run one after
//   another within a tile, and the two warpgroups overlap each other: a
//   form that issued tile t + 1's S^T and dP^T behind tile t's dK measured
//   slower on the H100. A persistent grid is the next step. P and dS round
//   to bf16 before their products (f32 accumulation), as the forward rounds
//   P before PV.
// * f32: flash_bwd_dkdv and flash_bwd_dq on the CUDA cores (TF32 would
//   break the 1e-4 f32 gate): every product in f32, tiles staged as f32
//   rows padded to HD + 1 floats, so a warp's 16 row reads of one column
//   fall in 16 banks. Each of 256 threads owns a 4 x 4 block of a 64 x 64
//   score tile (rows ty + 16 r, columns tx + 16 c) and a 4 x HD/16 block of
//   the gradient tile.

constexpr int kBwdB = 64;          // queries, and keys, per tile (f32)
constexpr int kBwdThreads = 256;   // 16 x 16
constexpr int kDotWarps = 8;       // warps per CTA of flash_bwd_dot
constexpr int kLDP = kBwdB + 1;    // shared row stride of a score tile

struct BwdStrides {   // element strides of the b, s and h axes of q, k, v, g
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, gb, gs, gh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the dot of 16 bytes of a and of b, in f32
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 w = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(u.y, w.y, fmaf(u.x, w.x, acc));
  }
  return acc;
}

// D of the rows (b H + h) pitch + i: rowsum(g o) for i < S, 0 past it; with
// lse2, also lse log2 e there (+inf past S). A row is kLanes lanes of one
// warp, each with one 16-byte load of o and of g (rows 16-byte aligned).
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kDotWarps) flash_bwd_dot(
    const T* __restrict__ o, const T* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dsum,
    float* __restrict__ lse2, int B, int S, int H, int pitch, long long ob,
    long long os, long long oh, long long gb, long long gs, long long gh) {
  constexpr int kVec = 16 / (int)sizeof(T);   // elements a 16-byte load
  constexpr int kLanes = HD / kVec;           // lanes a row
  const long long row = ((long long)blockIdx.x * 32 * kDotWarps +
                         threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool in = row < (long long)B * H * pitch;
  const int i = (int)(row % pitch);
  const long long bh = row / pitch;
  float acc = 0.0f;
  if (in && i < S) {
    const int h = (int)(bh % H);
    const int b = (int)(bh / H);
    acc = dot16(o + b * ob + i * os + h * oh + lane * kVec,
                g + b * gb + i * gs + h * gh + lane * kVec);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!in || lane != 0) return;
  dsum[row] = acc;                              // 0 past S
  if (lse2 != nullptr)
    lse2[row] = i < S ? lse[bh * S + i] * 1.4426950408889634f
                      : __int_as_float(0x7f800000);   // +inf
}

// rows [r0, r0 + kBwdB) of one (b, h) slice (src points at row 0 of it; ss
// is the row stride) into a shared f32 tile of row stride HD + 1, rows past
// S as zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int S) {
  for (int idx = threadIdx.x; idx < kBwdB * HD; idx += kBwdThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int s = r0 + r;
    dst[r * (HD + 1) + d] = s < S ? src[(long long)s * ss + d] : 0.0f;
  }
}

// lse and D of rows [r0, r0 + kBwdB) into shared memory (0 past S)
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const float* lse, const float* dsum,
                                          int r0, int S) {
  for (int r = threadIdx.x; r < kBwdB; r += kBwdThreads) {
    const bool ok = r0 + r < S;
    lse_s[r] = ok ? lse[r0 + r] : 0.0f;
    d_s[r] = ok ? dsum[r0 + r] : 0.0f;
  }
}

// c[r][c] = a[ty + 16 r] . b[tx + 16 c] over HD: rows of two [kBwdB][HD]
// tiles (row stride HD + 1)
template <int HD>
__device__ __forceinline__ void tile_abt(float (&c)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int kLD = HD + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[r][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * kLD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[r][j] = fmaf(av[r], bv[j], c[r][j]);
  }
}

// c[r][j] += sum_i p[i][ty + 16 r] b[i][tx + 16 j]: the columns of a
// [kBwdB][kBwdB] score tile (row stride kLDP) against a [kBwdB][HD] tile
template <int HD>
__device__ __forceinline__ void tile_atb(float (&c)[4][HD / 16],
                                         const float* p, const float* b,
                                         int ty, int tx) {
  constexpr int kLD = HD + 1;
#pragma unroll 4
  for (int i = 0; i < kBwdB; ++i) {
    float pv[4], bv[HD / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[i * kLDP + ty + 16 * r];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) bv[j] = b[i * kLD + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) c[r][j] = fmaf(pv[r], bv[j], c[r][j]);
  }
}

// c[r][j] += sum_k p[ty + 16 r][k] b[k][tx + 16 j]: the rows of a score
// tile against a [kBwdB][HD] tile
template <int HD>
__device__ __forceinline__ void tile_ab(float (&c)[4][HD / 16],
                                        const float* p, const float* b,
                                        int ty, int tx) {
  constexpr int kLD = HD + 1;
#pragma unroll 4
  for (int k = 0; k < kBwdB; ++k) {
    float pv[4], bv[HD / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[(ty + 16 * r) * kLDP + k];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) bv[j] = b[k * kLD + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) c[r][j] = fmaf(pv[r], bv[j], c[r][j]);
  }
}

// P and dS of one (query tile at i0, key tile at k0) pair from the staged
// q, g, k, v tiles into shared memory (ps may be null: the dq pass needs
// only dS)
template <int HD, bool CAUSAL>
__device__ __forceinline__ void scores(float* ps, float* dss, const float* qs,
                                       const float* gs, const float* ks,
                                       const float* vs, const float* lse_s,
                                       const float* d_s, int i0, int k0,
                                       int S, float scale, int ty, int tx) {
  float sc[4][4], dp[4][4];
  tile_abt<HD>(sc, qs, ks, ty, tx);    // q k^T
  tile_abt<HD>(dp, gs, vs, ty, tx);    // g v^T
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ri = ty + 16 * r;
    const int i = i0 + ri;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cj = tx + 16 * c;
      const int j = k0 + cj;
      const bool ok = i < S && j < S && (!CAUSAL || j <= i);
      const float p = ok ? expf(fmaf(sc[r][c], scale, -lse_s[ri])) : 0.0f;
      if (ps != nullptr) ps[ri * kLDP + cj] = p;
      dss[ri * kLDP + cj] = p * (dp[r][c] - d_s[ri]);
    }
  }
}

template <int HD>
constexpr int bwd_smem_bytes(int score_tiles) {
  return (4 * kBwdB * (HD + 1) + score_tiles * kBwdB * kLDP + 2 * kBwdB) *
         (int)sizeof(float);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H,
    BwdStrides st, float scale) {
  constexpr int kTile = kBwdB * (HD + 1);
  extern __shared__ float4 bwd_smem4[];
  float* ks = reinterpret_cast<float*>(bwd_smem4);
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* gs = qs + kTile;
  float* ps = gs + kTile;
  float* dss = ps + kBwdB * kLDP;
  float* lse_s = dss + kBwdB * kLDP;
  float* d_s = lse_s + kBwdB;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kt = blockIdx.y;          // causal: the longest walks first
  const int k0 = kt * kBwdB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* gb = g + b * st.gb + h * st.gh;
  const long long rows = ((long long)b * H + h) * S;
  load_tile<HD>(ks, k + b * st.kb + h * st.kh, st.ks, k0, S);
  load_tile<HD>(vs, v + b * st.vb + h * st.vh, st.vs, k0, S);

  float dka[4][HD / 16], dva[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dka[r][j] = dva[r][j] = 0.0f;

  const int n_q = (S + kBwdB - 1) / kBwdB;
  for (int qt = CAUSAL ? kt : 0; qt < n_q; ++qt) {
    const int i0 = qt * kBwdB;
    __syncthreads();                  // the previous tiles are consumed
    load_tile<HD>(qs, qb, st.qs, i0, S);
    load_tile<HD>(gs, gb, st.gs, i0, S);
    load_rows(lse_s, d_s, lse + rows, dsum + rows, i0, S);
    __syncthreads();
    scores<HD, CAUSAL>(ps, dss, qs, gs, ks, vs, lse_s, d_s, i0, k0, S, scale,
                       ty, tx);
    __syncthreads();
    tile_atb<HD>(dva, ps, gs, ty, tx);   // dV += P^T g
    tile_atb<HD>(dka, dss, qs, ty, tx);  // dK += dS^T q
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= S) continue;
    const long long at = (((long long)b * S + j) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      dk[at + tx + 16 * c] = scale * dka[r][c];
      dv[at + tx + 16 * c] = dva[r][c];
    }
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int S, int H, BwdStrides st, float scale) {
  constexpr int kTile = kBwdB * (HD + 1);
  extern __shared__ float4 bwd_smem4[];
  float* qs = reinterpret_cast<float*>(bwd_smem4);
  float* gs = qs + kTile;
  float* ks = gs + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;
  float* lse_s = dss + kBwdB * kLDP;
  float* d_s = lse_s + kBwdB;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int qt = gridDim.y - 1 - blockIdx.y;   // the longest walks first
  const int i0 = qt * kBwdB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const long long rows = ((long long)b * H + h) * S;
  load_tile<HD>(qs, q + b * st.qb + h * st.qh, st.qs, i0, S);
  load_tile<HD>(gs, g + b * st.gb + h * st.gh, st.gs, i0, S);
  load_rows(lse_s, d_s, lse + rows, dsum + rows, i0, S);

  float dqa[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dqa[r][j] = 0.0f;

  const int n_k = CAUSAL ? qt + 1 : (S + kBwdB - 1) / kBwdB;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBwdB;
    __syncthreads();                  // the previous tiles are consumed
    load_tile<HD>(ks, kb, st.ks, k0, S);
    load_tile<HD>(vs, vb, st.vs, k0, S);
    __syncthreads();
    scores<HD, CAUSAL>(nullptr, dss, qs, gs, ks, vs, lse_s, d_s, i0, k0, S,
                       scale, ty, tx);
    __syncthreads();
    tile_ab<HD>(dqa, dss, ks, ty, tx);   // dQ += dS k
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= S) continue;
    const long long at = (((long long)b * S + i) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
      dq[at + tx + 16 * c] = scale * dqa[r][c];
  }
}

// ---- bf16 backward: wgmma products fed by a TMA ring ---------------------

constexpr int kBwdStages = 3;     // depth of both passes' rings
constexpr int kBwdKeys = 128;     // keys per CTA of the dK/dV pass
constexpr int kBwdQ = 64;         // queries per tile of its ring
constexpr int kRowsPad = 128;     // lse and D rows padded to a multiple

// one contiguous run of `bytes` from global memory into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// keeps the registers of a wgmma A operand live, and in place, until the
// products that read them are waited for
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// the accumulator fragment of a 64 x HD tile, scaled and rounded to bf16,
// into 64 rows at `dst` (panel stride `panel`) in the TMA's 128-byte swizzle
template <int HD>
__device__ __forceinline__ void stage_bf16(uint32_t dst, int panel,
                                           const float (&acc)[HD / 2],
                                           float mul, int warp, int g,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      const uint32_t addr = dst + (j / 8) * panel + r * 128 +
                            (((j % 8) ^ (r & 7)) << 4) + 4 * t4;
      const uint32_t val = pack_bf16(acc[4 * j + 2 * half] * mul,
                                     acc[4 * j + 2 * half + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(val)
                   : "memory");
    }
  }
}

template <int HD>
struct BwdKVLayout {                  // shared memory of the dK/dV pass
  static constexpr int kPanels = HD / 64;
  static constexpr int kKVPanel = kBwdKeys * 128;   // one panel of K or V
  static constexpr int kKVTile = kPanels * kKVPanel;
  static constexpr int kQPanel = kBwdQ * 128;       // one panel of Q or g
  static constexpr int kQTile = kPanels * kQPanel;
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;                  // the Q ring
  static constexpr int kG = kQ + kBwdStages * kQTile;     // the g ring
  static constexpr int kRows = kG + kBwdStages * kQTile;  // lse2 and D rows
  static constexpr int kRowBytes = 2 * kBwdQ * 4;         // a stage's rows
  static constexpr int kBar = kRows + kBwdStages * kRowBytes;
  static constexpr int kBytes = kBar + 8 * (2 * kBwdStages + 1) + 1024;
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap dkmap,
    const __grid_constant__ CUtensorMap dvmap,
    const float* __restrict__ lse2, const float* __restrict__ dsum, int S,
    int pitch, int H, float scale) {
  using L = BwdKVLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);   // generic view of base
  const uint32_t sk = base + L::kK, sv = base + L::kV;
  const uint32_t sq = base + L::kQ, sg = base + L::kG;
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kBwdStages;
  const uint32_t kvbar = empty + 8 * kBwdStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kc = blockIdx.y * kBwdKeys;     // causal: the longest walks first
  const long long rows = ((long long)b * H + h) * pitch;
  // query tiles from the diagonal on: tiles wholly before a key tile see
  // none of its keys
  const int t0 = CAUSAL ? kc / kBwdQ : 0;
  const int n_tiles = (S + kBwdQ - 1) / kBwdQ - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {    // the producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kvbar, 2 * L::kKVTile);
      for (int p = 0; p < L::kPanels; ++p)
        for (int half = 0; half < kBwdKeys / 64; ++half) {
          const uint32_t off = p * L::kKVPanel + half * 64 * 128;
          tma_load(sk + off, &kmap, kvbar, 64 * p, h, kc + 64 * half, b);
          tma_load(sv + off, &vmap, kvbar, 64 * p, h, kc + 64 * half, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        const int i0 = (t0 + t) * kBwdQ;
        mbar_wait(empty + 8 * st, ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * L::kQTile + L::kRowBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(sq + st * L::kQTile + p * L::kQPanel, &qmap, full + 8 * st,
                   64 * p, h, i0, b);
          tma_load(sg + st * L::kQTile + p * L::kQPanel, &gmap, full + 8 * st,
                   64 * p, h, i0, b);
        }
        const uint32_t rs = base + L::kRows + st * L::kRowBytes;
        bulk_load(rs, lse2 + rows + i0, kBwdQ * 4, full + 8 * st);
        bulk_load(rs + kBwdQ * 4, dsum + rows + i0, kBwdQ * 4, full + 8 * st);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = threadIdx.x / 128;   // consumer warpgroup: 64 keys
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int kw = kc + 64 * wg;        // this warpgroup's first key
  const bool live = kw < S;
  const int key0 = kw + 16 * warp + g;   // keys key0 and key0 + 8
  const float sl2 = scale * 1.4426950408889634f;
  const uint32_t ka = sk + wg * 64 * 128;   // this warpgroup's K and V rows
  const uint32_t va = sv + wg * 64 * 128;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[32], dp[32];               // S^T and dP^T: 64 keys x 64 queries
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  uint32_t pa[4][4], dsa[4][4];      // P^T and dS^T in bf16, 4 k-steps

  mbar_wait(kvbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kBwdStages;
    const int i0 = (t0 + t) * kBwdQ;
    mbar_wait(full + 8 * st, (t / kBwdStages) & 1);
    // a tile whose queries all precede this warpgroup's keys is consumed
    // without a product
    if (live && !(CAUSAL && kw > i0 + kBwdQ - 1)) {
      const uint32_t qs = sq + st * L::kQTile;
      const uint32_t gs = sg + st * L::kQTile;
      const float* lrow =
          reinterpret_cast<const float*>(gbase + L::kRows + st * L::kRowBytes);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_abt<64, HD>(s, ka, L::kKVPanel, qs, L::kQPanel);    // S^T = K Q^T
      wgmma_commit();
      mma_abt<64, HD>(dp, va, L::kKVPanel, gs, L::kQPanel);   // dP^T = V g^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P^T = exp2(S^T scale log2 e - lse2) with lse2 of this thread's
      // query columns 8 j + 2 t4 + {0, 1}; above the diagonal 0
      const bool diag = CAUSAL && kw + 63 > i0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lrow + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = ex2(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x)));
          if (diag && key0 + 8 * (e / 2) > i0 + 8 * j + 2 * t4 + (e & 1))
            p = 0.0f;
          s[i] = p;
        }
      }
      pack_a<64>(pa, s);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdQ / 16; ++kk)   // dV += P^T g
        Mma<HD>::rs(dv, pa[kk], sw128_desc(gs + kk * 16 * 128, L::kQPanel));
      wgmma_commit();
      wgmma_wait<1>();                          // dP^T is done
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {             // dS^T = P^T (dP^T - D)
        const float2 d =
            *reinterpret_cast<const float2*>(lrow + kBwdQ + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - ((e & 1) ? d.y : d.x));
        }
      }
      pack_a<64>(dsa, dp);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdQ / 16; ++kk)   // dK += dS^T Q
        Mma<HD>::rs(dk, dsa[kk], sw128_desc(qs + kk * 16 * 128, L::kQPanel));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);   // the stage is consumed
  }
  if (!live) return;

  // epilogue: dK scale and dV in bf16, staged in this warpgroup's own K and
  // V rows (consumed), then one TMA store per panel, clipped at S
  stage_bf16<HD>(ka, L::kKVPanel, dk, scale, warp, g, t4);
  stage_bf16<HD>(va, L::kKVPanel, dv, 1.0f, warp, g, t4);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (tid == 0) {
    for (int p = 0; p < L::kPanels; ++p) {
      tma_store(&dkmap, ka + p * L::kKVPanel, 64 * p, h, kw, b);
      tma_store(&dvmap, va + p * L::kKVPanel, 64 * p, h, kw, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int HD>
struct BwdQLayout {                   // shared memory of the dQ pass
  static constexpr int kBK = HD == 64 ? 128 : 64;   // keys a ring tile
  static constexpr int kPanels = HD / 64;
  static constexpr int kQPanel = kWgBQ * 128;       // one panel of Q or g
  static constexpr int kKVPanel = kBK * 128;        // one panel of K or V
  static constexpr int kTile = kPanels * kKVPanel;
  static constexpr int kQ = 0;
  static constexpr int kG = kPanels * kQPanel;
  static constexpr int kK = 2 * kPanels * kQPanel;  // the K ring
  static constexpr int kV = kK + kBwdStages * kTile;  // the V ring
  static constexpr int kBar = kV + kBwdStages * kTile;
  static constexpr int kBytes = kBar + 8 * (2 * kBwdStages + 1) + 1024;
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap dqmap,
    const float* __restrict__ lse2, const float* __restrict__ dsum, int S,
    int pitch, int H, float scale) {
  using L = BwdQLayout<HD>;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sg = base + L::kG;
  const uint32_t sk = base + L::kK, sv = base + L::kV;
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kBwdStages;
  const uint32_t qbar = empty + 8 * kBwdStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;  // longest first
  const int q_last = min(q0 + kWgBQ, S) - 1;
  // key tiles wholly above the diagonal are never loaded
  const int n_tiles = CAUSAL ? q_last / BK + 1 : (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {    // the producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, 2 * L::kPanels * L::kQPanel);
      for (int p = 0; p < L::kPanels; ++p)
        for (int half = 0; half < 2; ++half) {
          const uint32_t off = p * L::kQPanel + half * 64 * 128;
          tma_load(sq + off, &qmap, qbar, 64 * p, h, q0 + 64 * half, b);
          tma_load(sg + off, &gmap, qbar, 64 * p, h, q0 + 64 * half, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        mbar_wait(empty + 8 * st, ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          for (int half = 0; half < BK / 64; ++half) {
            const uint32_t off = st * L::kTile + p * L::kKVPanel +
                                 half * 64 * 128;
            tma_load(sk + off, &kmap, full + 8 * st, 64 * p, h,
                     t * BK + 64 * half, b);
            tma_load(sv + off, &vmap, full + 8 * st, 64 * p, h,
                     t * BK + 64 * half, b);
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = threadIdx.x / 128;   // consumer warpgroup: 64 query rows
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wg_first = q0 + 64 * wg;
  const int wg_last = wg_first + 63;
  const int row0 = wg_first + 16 * warp + g;   // rows row0 and row0 + 8
  const float sl2 = scale * 1.4426950408889634f;
  const uint32_t qa = sq + wg * 64 * 128;      // this warpgroup's Q, g rows
  const uint32_t ga = sg + wg * 64 * 128;
  // tiles wholly above this warpgroup's rows (when causal), and every tile
  // of a warpgroup wholly past S, are consumed without a product
  const int n_mine = wg_first >= S ? 0
                     : CAUSAL ? min(n_tiles, wg_last / BK + 1) : n_tiles;
  const long long rows = ((long long)b * H + h) * pitch;
  float l2[2], dd[2];                 // lse2 and D of rows row0, row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l2[r] = lse2[rows + row0 + 8 * r];
    dd[r] = dsum[rows + row0 + 8 * r];
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
  float s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;
  uint32_t dsa[BK / 16][4];           // dS in bf16

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_mine; ++t) {
    const int st = t % kBwdStages;
    const int k0 = t * BK;
    const uint32_t ks = sk + st * L::kTile;
    mbar_wait(full + 8 * st, (t / kBwdStages) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt<BK, HD>(s, qa, L::kQPanel, ks, L::kKVPanel);    // S = Q K^T
    wgmma_commit();
    mma_abt<BK, HD>(dp, ga, L::kQPanel, sv + st * L::kTile,
                    L::kKVPanel);                           // dP = g V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // edge tiles (keys past S or above a row of this warpgroup) are masked
    const bool edge = k0 + BK > S || (CAUSAL && k0 + BK - 1 > wg_first);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) & 1;
      float p = ex2(fmaf(s[i], sl2, -l2[r]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        if (key >= S || (CAUSAL && key > row0 + 8 * r)) p = 0.0f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();                            // dP is done
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dd[(i / 2) & 1]);
    pack_a<BK>(dsa, dp);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)        // dQ += dS K
      Mma<HD>::rs(dq, dsa[kk], sw128_desc(ks + kk * 16 * 128, L::kKVPanel));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);   // the stage is consumed
  }
  for (int t = n_mine; t < n_tiles; ++t) {
    const int st = t % kBwdStages;
    mbar_wait(full + 8 * st, (t / kBwdStages) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  if (wg_first >= S) return;

  // epilogue: dQ scale in bf16, staged in this warpgroup's Q rows
  // (consumed), then one TMA store per panel, clipped at S
  stage_bf16<HD>(qa, L::kQPanel, dq, scale, warp, g, t4);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (tid == 0) {
    for (int p = 0; p < L::kPanels; ++p)
      tma_store(&dqmap, qa + p * L::kQPanel, 64 * p, h, wg_first, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// opts `kernel` into `bytes` of dynamic shared memory, once per device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((*set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    *set |= 1ull << dev;
  }
  return cudaSuccess;
}

template <typename T, int HD>
int launch_bwd_dot(const void* o, const void* g, const float* lse,
                   float* dsum, float* lse2, int B, int S, int H, int pitch,
                   const long long* st, cudaStream_t stream) {
  constexpr int kRowsPerCta = 32 * kDotWarps / (HD * (int)sizeof(T) / 16);
  const long long rows = (long long)B * H * pitch;
  const unsigned grid = (unsigned)((rows + kRowsPerCta - 1) / kRowsPerCta);
  flash_bwd_dot<T, HD><<<grid, 32 * kDotWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), lse, dsum, lse2, B,
      S, H, pitch, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_bwd(int pass, const void* q, const void* k, const void* v,
               const void* g, const float* lse, const float* dsum, void* d0,
               void* d1, int B, int S, int H, const BwdStrides& st,
               float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBwdB - 1) / kBwdB));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  cudaError_t err;
  if (pass == 0) {
    static unsigned long long set = 0;
    constexpr int kSmem = bwd_smem_bytes<HD>(2);
    auto kernel = flash_bwd_dkdv<HD, CAUSAL>;
    err = allow_smem(kernel, kSmem, &set);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kBwdThreads, kSmem, stream>>>(
        qt, kt, vt, gt, lse, dsum, static_cast<float*>(d0),
        static_cast<float*>(d1), S, H, st, scale);
  } else {
    static unsigned long long set = 0;
    constexpr int kSmem = bwd_smem_bytes<HD>(1);
    auto kernel = flash_bwd_dq<HD, CAUSAL>;
    err = allow_smem(kernel, kSmem, &set);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kBwdThreads, kSmem, stream>>>(
        qt, kt, vt, gt, lse, dsum, static_cast<float*>(d0), S, H, st, scale);
  }
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_bwd_wgmma(int pass, const void* q, const void* k, const void* v,
                     const void* g, const float* lse2, const float* dsum,
                     void* d0, void* d1, int B, int S, int H, int pitch,
                     const long long* strides, float scale,
                     cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return (int)err;
  // q, k, v, g through their strides; the gradients contiguous
  const long long out_st[3] = {(long long)S * H * HD, (long long)H * HD, HD};
  const void* ptrs[6] = {q, k, v, g, d0, d1};
  CUtensorMap maps[6];
  const int n_maps = pass == 0 ? 6 : 5;
  for (int i = 0; i < n_maps; ++i) {
    const CUresult res = encode_map(encode, &maps[i], ptrs[i], B, S, H, HD,
                                    i < 4 ? strides + 3 * i : out_st, 64);
    if (res != CUDA_SUCCESS) return -(int)res;
  }
  if (pass == 0) {
    using L = BwdKVLayout<HD>;
    static unsigned long long set = 0;
    auto kernel = flash_bwd_dkdv_wgmma<HD, CAUSAL>;
    err = allow_smem(kernel, L::kBytes, &set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(B * H),
                    (unsigned)((S + kBwdKeys - 1) / kBwdKeys));
    kernel<<<grid, kWgThreads, L::kBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], lse2, dsum, S,
        pitch, H, scale);
  } else {
    using L = BwdQLayout<HD>;
    static unsigned long long set = 0;
    auto kernel = flash_bwd_dq_wgmma<HD, CAUSAL>;
    err = allow_smem(kernel, L::kBytes, &set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(B * H), (unsigned)((S + kWgBQ - 1) / kWgBQ));
    kernel<<<grid, kWgThreads, L::kBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], lse2, dsum, S, pitch, H,
        scale);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_causal(int pass, int causal, int dtype, const void* q,
                      const void* k, const void* v, const void* g,
                      const float* lse, const float* dsum, void* d0,
                      void* d1, int B, int S, int H, int pitch,
                      const long long* strides, float scale,
                      cudaStream_t stream) {
  if (dtype == 1)
    return causal ? launch_bwd_wgmma<HD, true>(pass, q, k, v, g, lse, dsum,
                                               d0, d1, B, S, H, pitch,
                                               strides, scale, stream)
                  : launch_bwd_wgmma<HD, false>(pass, q, k, v, g, lse, dsum,
                                                d0, d1, B, S, H, pitch,
                                                strides, scale, stream);
  const BwdStrides st = {strides[0], strides[1], strides[2],  strides[3],
                         strides[4], strides[5], strides[6],  strides[7],
                         strides[8], strides[9], strides[10], strides[11]};
  return causal ? launch_bwd<HD, true>(pass, q, k, v, g, lse, dsum, d0, d1,
                                       B, S, H, st, scale, stream)
                : launch_bwd<HD, false>(pass, q, k, v, g, lse, dsum, d0, d1,
                                        B, S, H, st, scale, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// cudaErrorInvalidValue for a head dim or type the kernels do not take, and
// minus the CUresult when the driver refuses a bf16 tensor map. `dtype` is
// 0 for f32 (flash_fwd_kernel), 1 for bf16 (flash_fwd_kernel_wgmma);
// `strides` holds the element strides of the b, s and h axes of q, k, v and
// out, in that order (12 values; the hd axis is contiguous); `scale` is
// hd^-0.5 rounded to f32 by the caller. `lse`, when not null, receives the
// rows' log-sum-exp of the scaled scores, [B, H, S] f32 (the backward's
// input). The caller allocates `o` and `lse` and checks shapes, types, the
// 16-byte alignment of every row (for bf16 also what the tensor maps need:
// a 16-byte-aligned base and strides that are multiples of 16 bytes) and
// the launch limits.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int S, int H, int hd, int dtype,
                                      int causal, const long long* strides,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && hd == 64)
    return launch_wgmma_causal<64>(q, k, v, o, lse, B, S, H, causal, strides,
                                   scale, s);
  if (dtype == 1 && hd == 128)
    return launch_wgmma_causal<128>(q, k, v, o, lse, B, S, H, causal,
                                    strides, scale, s);
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  if (dtype == 0 && hd == 64)
    return launch_causal<float, 64>(q, k, v, o, lse, B, S, H, causal, st,
                                    scale, s);
  if (dtype == 0 && hd == 128)
    return launch_causal<float, 128>(q, k, v, o, lse, B, S, H, causal, st,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}

// flash_bwd_dot on `stream`: dsum[(b H + h) pitch + i] = sum_d g[b, i, h, d]
// o[b, i, h, d] in f32 for i < S, 0 for S <= i < pitch; when `lse2` is not
// null also lse2[(b H + h) pitch + i] = lse[b, h, i] log2 e (+inf past S),
// the bf16 passes' input. `strides`: the b, s, h element strides of o, then
// of g (6 values; hd contiguous, every row 16-byte aligned). Returns as
// flash_attention_launch.
extern "C" int flash_attention_bwd_dot_launch(const void* o, const void* g,
                                              const float* lse, float* dsum,
                                              float* lse2, int B, int S,
                                              int H, int hd, int dtype,
                                              int pitch,
                                              const long long* strides,
                                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (pitch < S) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch_bwd_dot<float, 64>(o, g, lse, dsum, lse2, B, S, H, pitch,
                                     strides, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd_dot<float, 128>(o, g, lse, dsum, lse2, B, S, H, pitch,
                                      strides, s);
  if (dtype == 1 && hd == 64)
    return launch_bwd_dot<__nv_bfloat16, 64>(o, g, lse, dsum, lse2, B, S, H,
                                             pitch, strides, s);
  if (dtype == 1 && hd == 128)
    return launch_bwd_dot<__nv_bfloat16, 128>(o, g, lse, dsum, lse2, B, S, H,
                                              pitch, strides, s);
  return (int)cudaErrorInvalidValue;
}

// The two gradient passes on `stream`: pass 0 is the dK/dV pass (d0 = dk,
// d1 = dv), pass 1 the dQ pass (d0 = dq, d1 unused). q, k, v, g are read
// through `strides` (the b, s, h element strides of q, k, v, g: 12 values;
// hd contiguous; for bf16 also what the tensor maps need, as for
// flash_attention_launch); the gradients are written contiguous [B, S, H,
// hd] in the inputs' type. `lse` and `dsum` are flash_bwd_dot's rows of
// pitch `pitch`: for f32 (flash_bwd_dkdv, flash_bwd_dq) the natural-log LSE
// with pitch == S; for bf16 (flash_bwd_dkdv_wgmma, flash_bwd_dq_wgmma) its
// lse2, with pitch a multiple of 128 (kRowsPad) of at least S. Returns as
// flash_attention_launch.
extern "C" int flash_attention_bwd_launch(int pass, const void* q,
                                          const void* k, const void* v,
                                          const void* g, const float* lse,
                                          const float* dsum, void* d0,
                                          void* d1, int B, int S, int H,
                                          int hd, int dtype, int causal,
                                          int pitch, const long long* strides,
                                          float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (pass != 0 && pass != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 ? pitch != S : (pitch < S || pitch % kRowsPad != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return launch_bwd_causal<64>(pass, causal, dtype, q, k, v, g, lse, dsum,
                                 d0, d1, B, S, H, pitch, strides, scale, s);
  if (hd == 128)
    return launch_bwd_causal<128>(pass, causal, dtype, q, k, v, g, lse, dsum,
                                  d0, d1, B, S, H, pitch, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
