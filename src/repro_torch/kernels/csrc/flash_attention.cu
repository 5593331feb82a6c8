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
// type. hd is 64 or 128. Two kernels compute it, one per input type, both
// on the tensor cores:
//
// * bf16: flash_fwd_kernel_wgmma (wgmma, bf16 operands).
// * f32: flash_fwd_kernel_tf32 (mma.sync TF32, every product split into
//   three; see "f32: three-term split TF32" below).
//
// Bound on this card: operations. A causal pass does about 2 B H S^2 hd
// flops (QK^T and PV over the lower triangle): 34.4 GFLOP at B = 4, S =
// 2048, H = 16, hd = 64, some 0.035 ms at the bf16 tensor-core peak (989
// TFLOP/s), while it must move only 4 B S H hd * 2 bytes (67 MB, 0.020 ms at
// 3.35 TB/s). In f32 (134 MB, 0.040 ms) one TF32 product keeps about three
// decimal digits, which breaks the 2e-5 f32 gate; three of them on split
// operands keep f32's accuracy, so f32-accurate products run at a third of
// the TF32 peak (494.7 / 3 = 165 TFLOP/s): 0.208 ms, against 0.51 ms at the
// CUDA cores' 67 TFLOP/s.
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

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Strides {              // element strides of the b, s and h axes
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

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
// S = 2048, H = 16, hd = 64, causal, at 989 TFLOP/s; in f32 0.521 ms as
// three TF32 products each at 494.7 TFLOP/s, 1.28 ms at the CUDA cores' f32
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
// * f32: flash_bwd_dkdv_tf32 and flash_bwd_dq_tf32, every product as
//   three TF32 products on the tensor cores (mma.sync), built as the f32
//   forward is (see "f32: three-term split TF32" below). dK/dV pass: a CTA
//   holds 128 keys at hd 64 (64 at hd 128) and walks query tiles of 16; dQ
//   pass: a CTA holds 128 queries at hd 64 (64 at hd 128) and walks key
//   tiles of 16. P and dS feed dV, dK and dQ from registers, unrounded:
//   each is split into three products as every other operand is.

constexpr int kDotWarps = 8;       // warps per CTA of flash_bwd_dot

struct BwdStrides {   // element strides of the b, s and h axes of q, k, v, g
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, gb, gs, gh;
};

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
cudaError_t allow_smem(K kernel, int bytes, unsigned long long* set,
                       bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((*set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (max_carveout) {   // shared memory for two CTAs an SM
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    *set |= 1ull << dev;
  }
  return cudaSuccess;
}

// ---- f32: three-term split TF32 on the tensor cores ----------------------
//
// The f32 forward and backward passes run every product as mma.sync.m16n8k8
// TF32 on the tensor cores, three times on split operands: x = x_hi + x_lo
// with x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi) (cvt.rna's
// rounding, to nearest with ties away from zero, done on the bits, the low
// 13 bits cleared, so nothing depends on what the tensor core does with
// them), and
//
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
//
// accumulated in f32, the small terms first. What is dropped (a_lo b_lo,
// the rounding of the lo terms) is ~2^-22 of each product, so the kernels
// keep the f32 gates (2e-5 forward, 1e-4 backward), where one TF32 product
// (~2^-11) misses them. The tensor core's f32 accumulation rounds toward
// zero: the short sums over the head dim (S, dP) run on its accumulator,
// but the long ones over keys or queries (O, dV, dK, dQ), hundreds of its
// roundings on one running sum, left a bias that failed the f32 model
// gates. They are summed two k-steps at a time from zero on the tensor
// core, and each partial is added on the CUDA cores, rounded to nearest
// (mma6_tf32_add).
//
// What bounds them: three products for each f32 one, so the tensor pipe,
// and the shared memory that feeds it. A CTA is four warps; each warp owns
// 16 kMT rows of the products' M (queries in the forward and the dQ pass,
// keys in the dK/dV pass) and keeps them for the whole walk as a raw f32
// tile; its A fragments are split in registers as they are read (each
// feeds every B fragment of the tile). The walked tiles (K and V, or Q
// and dO) arrive by cp.async into a staging tile while the previous tile
// is multiplied, and are split once into hi and lo halves; at hd = 64 each
// B fragment feeds two m16 tiles. Fragments are read register by register,
// so no operand needs a transpose: a tile whose rows are the product's K
// dimension (V in P V, dO in dV = P^T dO, Q in dK = dS^T Q, K in dQ = dS K)
// is read down its columns. P and dS feed their products from registers:
// an m16n8 accumulator holds row g's columns {2t, 2t + 1} where the A
// fragment wants {t, t + 4}, so those products read their B operand's K
// rows in the order 0, 2, 4, 6, 1, 3, 5, 7 within each 8 (a sum over keys,
// or queries, in any order). Tiles fit two CTAs an SM at hd = 64.
//
// Why mma.sync and not wgmma: TF32 wgmma takes its shared-memory operands
// K-major only (the transpose bit exists for 16-bit types), so four of the
// seven products would need transposed split copies of their tiles beside
// the plain ones; with every operand held twice (hi, lo) at 4 bytes an
// element, the dK/dV pass's K, V, Q, dO and the copies do not fit 227 KB
// at hd = 128, nor at hd = 64 with two warpgroups of keys.

constexpr int kTfThreads = 128;   // four warps

template <int HD>
struct TfTiles {
  // m16 row tiles a warp: at hd = 64 two, so every B fragment loaded from
  // shared memory feeds two products (at hd = 128 the accumulators of a
  // second would not fit the registers)
  static constexpr int kMT = HD == 64 ? 2 : 1;
  static constexpr int kRows = 4 * 16 * kMT;         // the CTA's M rows
  static constexpr int kFwdBK = HD == 64 ? 32 : 16;  // keys a forward tile
  static constexpr int kDqBK = 16;                   // keys a dQ tile
  static constexpr int kDkvBQ = 16;                  // queries a dK/dV tile
};

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x, with the low 13 bits cleared: half a
// unit of the 13th bit added to the magnitude's bits, then masked off (two
// integer operations; ptxas expands cvt.rna.tf32 for sm_90 into a compare,
// an add and a select)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// The float index of element (r, c) in a tile the fragments are read from:
// rows padded to HD + 4 floats, so a fragment read along the rows (rows g,
// columns t) and one read down the columns (rows 2t or 2t + 1, columns g)
// both reach 32 different banks; every fragment address is a per-thread
// base plus a constant. A split tile of ROWS rows holds the hi halves in
// ROWS such rows and the lo halves in the next ROWS, so each fragment
// element lands in the register its product reads.
template <int HD>
__device__ __forceinline__ int tf_at(int r, int c) {
  return r * (HD + 4) + c;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows from r0 of one (b, h) slice of an f32 [B, S, H, HD] tensor
// (src at its row 0, ss its row stride) into a raw f32 tile of the
// shared memory, one cp.async of 16 bytes a step (rows past S as zeros).
// A: the tile is an A operand's (tf_at); else staging, rows of HD floats
template <int ROWS, int HD, bool A>
__device__ __forceinline__ void tf_fetch(float* raw, const float* src,
                                         long long ss, int r0, int S) {
  constexpr int kPerRow = HD / 4;
  static_assert(ROWS * kPerRow % kTfThreads == 0, "whole steps a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / kTfThreads; ++i) {
    const int idx = threadIdx.x + i * kTfThreads;
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    const bool ok = r0 + r < S;
    cp_async16(smem_addr(raw + (A ? tf_at<HD>(r, c) : r * HD + c)),
               src + (long long)(ok ? r0 + r : 0) * ss + c, ok);
  }
}

// a staged tile of ROWS rows split into the hi and lo halves of a B
// operand's tile
template <int ROWS, int HD>
__device__ __forceinline__ void tf_split(float* tile, const float* raw) {
  constexpr int kPerRow = HD / 4;
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / kTfThreads; ++i) {
    const int idx = threadIdx.x + i * kTfThreads;
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * HD + c);
    uint32_t hi[4], lo[4];
    split_tf32(x.x, hi[0], lo[0]);
    split_tf32(x.y, hi[1], lo[1]);
    split_tf32(x.z, hi[2], lo[2]);
    split_tf32(x.w, hi[3], lo[3]);
    float* dst = tile + tf_at<HD>(r, c);
    *reinterpret_cast<float4*>(dst) =
        make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                    __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    *reinterpret_cast<float4*>(dst + ROWS * (HD + 4)) =
        make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                    __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
}

// m16n8k8 fragments (lane = 4 g + t), split. A: rows r0 + g, r0 + g + 8 by
// columns c0 + t, c0 + t + 4 of a raw tile whose columns are K (r0 a
// multiple of 8)
template <int HD>
__device__ __forceinline__ void tf_frag_a(const float* raw, int r0, int c0,
                                          int g, int t4, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(raw[tf_at<HD>(r0 + g, c0 + t4)], hi[0], lo[0]);
  split_tf32(raw[tf_at<HD>(r0 + g + 8, c0 + t4)], hi[1], lo[1]);
  split_tf32(raw[tf_at<HD>(r0 + g, c0 + t4 + 4)], hi[2], lo[2]);
  split_tf32(raw[tf_at<HD>(r0 + g + 8, c0 + t4 + 4)], hi[3], lo[3]);
}

// one element of a split tile of ROWS rows: its hi and lo halves
template <int ROWS, int HD>
__device__ __forceinline__ void tf_elem(const float* tile, int r, int c,
                                        uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(tile[tf_at<HD>(r, c)]);
  lo = __float_as_uint(tile[ROWS * (HD + 4) + tf_at<HD>(r, c)]);
}

// B of a split tile whose columns are K (n along its rows): (k, n) = (t,
// g) and (t + 4, g) at row n0 + g, columns k0 + t, k0 + t + 4
template <int ROWS, int HD>
__device__ __forceinline__ void tf_frag_b_rows(const float* tile, int n0,
                                               int k0, int g, int t4,
                                               uint32_t (&hi)[2],
                                               uint32_t (&lo)[2]) {
  tf_elem<ROWS, HD>(tile, n0 + g, k0 + t4, hi[0], lo[0]);
  tf_elem<ROWS, HD>(tile, n0 + g, k0 + t4 + 4, hi[1], lo[1]);
}

// B of a split tile whose rows are K, for an accumulator fed as A
// (tf_acc_as_a): logical k = t is row k0 + 2t, k = t + 4 is row k0 + 2t +
// 1, column n0 + g
template <int ROWS, int HD>
__device__ __forceinline__ void tf_frag_b_cols(const float* tile, int k0,
                                               int n0, int g, int t4,
                                               uint32_t (&hi)[2],
                                               uint32_t (&lo)[2]) {
  tf_elem<ROWS, HD>(tile, k0 + 2 * t4, n0 + g, hi[0], lo[0]);
  tf_elem<ROWS, HD>(tile, k0 + 2 * t4 + 1, n0 + g, hi[1], lo[1]);
}

// an m16n8 accumulator (row g: columns 2t, 2t + 1 in c[0], c[1]; row g + 8
// in c[2], c[3]), split, as the A fragment of a k-step whose logical
// columns t and t + 4 are its columns 2t and 2t + 1
__device__ __forceinline__ void tf_acc_as_a(const float (&c)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 products, the small terms first
__device__ __forceinline__ void mma3_tf32(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// d = a b, summed from zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d += a0 b0 + a1 b1 over two k-steps, for the long sums (over keys or
// queries): the six TF32 products are summed from zero on the tensor core,
// small terms first, and the partial is added to d on the CUDA cores,
// rounded to nearest. The tensor core's f32 accumulation rounds toward zero,
// and hundreds of its roundings on one running sum leave a bias that fails
// the f32 model gates; a partial of two k-steps keeps it small.
__device__ __forceinline__ void mma6_tf32_add(
    float (&d)[4], const uint32_t (&ah0)[4], const uint32_t (&al0)[4],
    const uint32_t (&bh0)[2], const uint32_t (&bl0)[2],
    const uint32_t (&ah1)[4], const uint32_t (&al1)[4],
    const uint32_t (&bh1)[2], const uint32_t (&bl1)[2]) {
  float t[4];
  mma_tf32_zero(t, al0, bh0[0], bh0[1]);
  mma_tf32(t, al1, bh1[0], bh1[1]);
  mma_tf32(t, ah0, bl0[0], bl0[1]);
  mma_tf32(t, ah1, bl1[0], bl1[1]);
  mma_tf32(t, ah0, bh0[0], bh0[1]);
  mma_tf32(t, ah1, bh1[0], bh1[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// One online-softmax step, in base 2, on the raw scores s (q . k) of the
// key tile at k0 in one m16 tile's fragment (rows row0 and row0 + 8, keys
// k0 + 8 j + 2 t + {0, 1}): updates the running max m (of score * scale *
// log2 e), this thread's shares l of the row sums and corr, the factor that
// rescales O, and leaves P in s. MASK: the tile holds keys past S or above
// the diagonal; they contribute an explicit 0.
template <int BK, bool MASK, bool CAUSAL>
__device__ __forceinline__ void tf_softmax(float (&s)[BK / 8][4],
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], float sl2,
                                           int k0, int S, int row0, int t4) {
  auto visible = [&](int j, int e) {
    const int key = k0 + 8 * j + 2 * t4 + (e & 1);
    return key < S && (!CAUSAL || key <= row0 + 8 * (e >> 1));
  };
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && !visible(j, e)) s[j][e] = kNeg;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
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
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[j][e], sl2, -m[e >> 1]));
      if (MASK && !visible(j, e)) p = 0.0f;
      psum[e >> 1] += p;
      s[j][e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&a)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][j][e] = 0.0f;
}

// The f32 forward: a CTA holds kRows queries of one (b, h) (raw, 16 kMT a
// warp) and walks the key tiles up to the diagonal: S = Q K^T, the online
// softmax, O += P V, then acc / max(l, 1e-30) and the rows' LSE.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kTfThreads) flash_fwd_kernel_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int H, Strides st, float scale) {
  constexpr int MT = TfTiles<HD>::kMT;
  constexpr int BQ = TfTiles<HD>::kRows;
  constexpr int BK = TfTiles<HD>::kFwdBK;
  // a warp's rows span whole key tiles, so every key tile of its walk
  // ends at or before its last row: no 8-key step lies wholly above it
  static_assert((16 * MT) % BK == 0, "key tiles within a warp's rows");
  static_assert(BK % 16 == 0, "key tiles of whole pairs of k-steps");
  extern __shared__ float4 tf_smem[];
  constexpr int LD = HD + 4;
  float* sq = reinterpret_cast<float*>(tf_smem);   // BQ x LD, raw
  float* sk = sq + BQ * LD;                         // BK x LD pairs
  float* sv = sk + 2 * BK * LD;
  float* rk = sv + 2 * BK * LD;                     // BK x HD, raw
  float* rv = rk + BK * HD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t4 = lane % 4;
  const int wr = 16 * MT * warp;        // this warp's first row in the CTA
  const int wfirst = q0 + wr;
  const int wlast = wfirst + 16 * MT - 1;
  const float sl2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const int q_last = min(q0 + BQ, S) - 1;
  // key tiles wholly above the diagonal are never loaded; a warp stops at
  // the last tile any of its rows sees
  const int n_tiles = CAUSAL ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int n_mine = wfirst >= S ? 0
                     : CAUSAL ? min(n_tiles, wlast / BK + 1) : n_tiles;

  tf_fetch<BQ, HD, true>(sq, q + b * st.qb + h * st.qh, st.qs, q0, S);
  tf_fetch<BK, HD, false>(rk, kb, st.ks, 0, S);
  tf_fetch<BK, HD, false>(rv, vb, st.vs, 0, S);
  cp_async_commit();

  float acc[MT][HD / 8][4], s[MT][BK / 8][4];
  zero(acc);
  float m[MT][2], l[MT][2];       // l: this thread's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNeg;
    l[mt][0] = l[mt][1] = 0.0f;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();              // tile kt landed; kt - 1 is consumed
    tf_split<BK, HD>(sk, rk);
    tf_split<BK, HD>(sv, rv);
    __syncthreads();
    if (kt + 1 < n_tiles) {       // in flight while this tile is multiplied
      tf_fetch<BK, HD, false>(rk, kb, st.ks, k0 + BK, S);
      tf_fetch<BK, HD, false>(rv, vb, st.vs, k0 + BK, S);
      cp_async_commit();
    }
    if (kt >= n_mine) continue;
    zero(s);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {         // S = Q K^T
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf_frag_a<HD>(sq, wr + 16 * mt, 8 * kk, gr, t4, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bh[2], bl[2];
        tf_frag_b_rows<BK, HD>(sk, 8 * j, 8 * kk, gr, t4, bh, bl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3_tf32(s[mt][j], ah[mt], al[mt], bh, bl);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int first = wfirst + 16 * mt;
      float corr[2];
      if (k0 + BK > S || (CAUSAL && k0 + BK - 1 > first))
        tf_softmax<BK, true, CAUSAL>(s[mt], m[mt], l[mt], corr, sl2, k0, S,
                                     first + gr, t4);
      else
        tf_softmax<BK, false, CAUSAL>(s[mt], m[mt], l[mt], corr, sl2, k0, S,
                                      first + gr, t4);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[mt][n][0] *= corr[0];
        acc[mt][n][1] *= corr[0];
        acc[mt][n][2] *= corr[1];
        acc[mt][n][3] *= corr[1];
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {        // O += P V, 2 k-steps
      uint32_t ph[2][MT][4], pl[2][MT][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tf_acc_as_a(s[mt][j + u], ph[u][mt], pl[u][mt]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          tf_frag_b_cols<BK, HD>(sv, 8 * (j + u), 8 * n, gr, t4, bh[u],
                                 bl[u]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma6_tf32_add(acc[mt][n], ph[0][mt], pl[0][mt], bh[0], bl[0],
                        ph[1][mt], pl[1][mt], bh[1], bl[1]);
      }
    }
  }
  if (wfirst >= S) return;

  // epilogue: acc / max(l, 1e-30); the rows' log-sum-exp of the scaled
  // scores: m is in log2 units, so lse = (m + log2 l) ln 2
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float den = fmaxf(lr, 1e-30f);
      const int row = wfirst + 16 * mt + gr + 8 * r;
      if (row >= S) continue;
      float* dst = o + b * st.ob + (long long)row * st.os + h * st.oh + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(
            acc[mt][n][2 * r] / den, acc[mt][n][2 * r + 1] / den);
      if (lse != nullptr && t4 == 0)
        lse[((long long)b * H + h) * S + row] =
            (m[mt][r] + log2f(lr)) * 0.6931471805599453f;
    }
}

// The dK/dV pass: a CTA holds kRows keys of one (b, h) with their values
// (raw, 16 kMT a warp, keys as the products' M) and walks the query tiles
// (from the diagonal on when causal): S^T = K Q^T and dP^T = V dO^T, P^T =
// exp2(S^T scale log2 e - lse log2 e) (0 for a query past S or, causal,
// before the key), dS^T = P^T (dP^T - D), dV += P^T dO, dK += dS^T Q.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kTfThreads) flash_bwd_dkdv_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H,
    BwdStrides st, float scale) {
  constexpr int MT = TfTiles<HD>::kMT;
  constexpr int BKV = TfTiles<HD>::kRows;
  constexpr int BQ = TfTiles<HD>::kDkvBQ;
  static_assert(BQ % 16 == 0, "query tiles of whole pairs of k-steps");
  extern __shared__ float4 tf_smem[];
  constexpr int LD = HD + 4;
  float* sk = reinterpret_cast<float*>(tf_smem);   // BKV x LD, raw
  float* sv = sk + BKV * LD;
  float* sq = sv + BKV * LD;                        // BQ x LD pairs
  float* sg = sq + 2 * BQ * LD;
  float* rq = sg + 2 * BQ * LD;                     // BQ x HD, raw
  float* rg = rq + BQ * HD;
  float* lrow = rg + BQ * HD;                       // lse log2 e of BQ rows
  float* drow = lrow + BQ;                          // and D

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int k0 = blockIdx.y * BKV;       // causal: the longest walks first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t4 = lane % 4;
  const int wr = 16 * MT * warp;
  const int kw = k0 + wr;                // this warp's keys
  const int kw_last = kw + 16 * MT - 1;
  const bool live = kw < S;
  const float sl2 = scale * 1.4426950408889634f;
  const long long rows = ((long long)b * H + h) * S;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* gb = dout + b * st.gb + h * st.gh;
  // query tiles from the diagonal on: tiles wholly before the key tile see
  // none of its keys
  const int t0 = CAUSAL ? k0 / BQ : 0;
  const int n_tiles = (S + BQ - 1) / BQ - t0;

  tf_fetch<BKV, HD, true>(sk, k + b * st.kb + h * st.kh, st.ks, k0, S);
  tf_fetch<BKV, HD, true>(sv, v + b * st.vb + h * st.vh, st.vs, k0, S);
  float lr = 0.0f, dr = 0.0f;     // row threadIdx.x of the next tile
  auto fetch = [&](int i0) {
    tf_fetch<BQ, HD, false>(rq, qb, st.qs, i0, S);
    tf_fetch<BQ, HD, false>(rg, gb, st.gs, i0, S);
    cp_async_commit();
    const int i = i0 + (int)threadIdx.x;
    const bool ok = threadIdx.x < BQ && i < S;
    lr = ok ? lse[rows + i] * 1.4426950408889634f : 0.0f;
    dr = ok ? dsum[rows + i] : 0.0f;
  };
  fetch(t0 * BQ);

  float dka[MT][HD / 8][4], dva[MT][HD / 8][4];
  float sa[MT][BQ / 8][4], pa[MT][BQ / 8][4];
  zero(dka);
  zero(dva);
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = (t0 + t) * BQ;
    cp_async_wait_all();
    __syncthreads();              // tile t landed; t - 1 is consumed
    tf_split<BQ, HD>(sq, rq);
    tf_split<BQ, HD>(sg, rg);
    if (threadIdx.x < BQ) {
      lrow[threadIdx.x] = lr;
      drow[threadIdx.x] = dr;
    }
    __syncthreads();
    if (t + 1 < n_tiles) fetch(i0 + BQ);
    // a tile whose queries all precede this warp's keys: no product
    if (!live || (CAUSAL && i0 + BQ - 1 < kw)) continue;
    zero(sa);
    zero(pa);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {   // S^T = K Q^T, dP^T = V dO^T
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf_frag_a<HD>(sk, wr + 16 * mt, 8 * kk, gr, t4, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t bh[2], bl[2];
        tf_frag_b_rows<BQ, HD>(sq, 8 * j, 8 * kk, gr, t4, bh, bl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3_tf32(sa[mt][j], ah[mt], al[mt], bh, bl);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf_frag_a<HD>(sv, wr + 16 * mt, 8 * kk, gr, t4, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t bh[2], bl[2];
        tf_frag_b_rows<BQ, HD>(sg, 8 * j, 8 * kk, gr, t4, bh, bl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3_tf32(pa[mt][j], ah[mt], al[mt], bh, bl);
      }
    }
    const bool edge = i0 + BQ > S || (CAUSAL && kw_last > i0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int query = i0 + col;
          const int key = kw + 16 * mt + gr + 8 * (e >> 1);
          float p = ex2(fmaf(sa[mt][j][e], sl2, -lrow[col]));
          if (edge && (query >= S || (CAUSAL && key > query))) p = 0.0f;
          sa[mt][j][e] = p;
          pa[mt][j][e] = p * (pa[mt][j][e] - drow[col]);
        }
#pragma unroll
    for (int j = 0; j < BQ / 8; j += 2) {   // 2 k-steps of queries
      uint32_t ah[2][MT][4], al[2][MT][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tf_acc_as_a(sa[mt][j + u], ah[u][mt], al[u][mt]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {   // dV += P^T dO
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          tf_frag_b_cols<BQ, HD>(sg, 8 * (j + u), 8 * n, gr, t4, bh[u],
                                 bl[u]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma6_tf32_add(dva[mt][n], ah[0][mt], al[0][mt], bh[0], bl[0],
                        ah[1][mt], al[1][mt], bh[1], bl[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tf_acc_as_a(pa[mt][j + u], ah[u][mt], al[u][mt]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {   // dK += dS^T Q
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          tf_frag_b_cols<BQ, HD>(sq, 8 * (j + u), 8 * n, gr, t4, bh[u],
                                 bl[u]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma6_tf32_add(dka[mt][n], ah[0][mt], al[0][mt], bh[0], bl[0],
                        ah[1][mt], al[1][mt], bh[1], bl[1]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + 16 * mt + gr + 8 * r;
      if (key >= S) continue;
      const long long at = (((long long)b * S + key) * H + h) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(dk + at + 8 * n) = make_float2(
            scale * dka[mt][n][2 * r], scale * dka[mt][n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + at + 8 * n) =
            make_float2(dva[mt][n][2 * r], dva[mt][n][2 * r + 1]);
      }
    }
}

// The dQ pass: a CTA holds kRows queries of one (b, h) with their dO rows
// (raw, 16 kMT a warp), lse and D, and walks the key tiles up to the
// diagonal: S = Q K^T and dP = dO V^T, dS = P (dP - D), dQ += dS K.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kTfThreads) flash_bwd_dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int S, int H, BwdStrides st, float scale) {
  constexpr int MT = TfTiles<HD>::kMT;
  constexpr int BQ = TfTiles<HD>::kRows;
  constexpr int BK = TfTiles<HD>::kDqBK;
  // a warp's rows span whole key tiles, so every key tile of its walk
  // ends at or before its last row: no 8-key step lies wholly above it
  static_assert((16 * MT) % BK == 0, "key tiles within a warp's rows");
  static_assert(BK % 16 == 0, "key tiles of whole pairs of k-steps");
  extern __shared__ float4 tf_smem[];
  constexpr int LD = HD + 4;
  float* sq = reinterpret_cast<float*>(tf_smem);   // BQ x LD, raw
  float* sg = sq + BQ * LD;
  float* sk = sg + BQ * LD;                         // BK x LD pairs
  float* sv = sk + 2 * BK * LD;
  float* rk = sv + 2 * BK * LD;                     // BK x HD, raw
  float* rv = rk + BK * HD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t4 = lane % 4;
  const int wr = 16 * MT * warp;
  const int wfirst = q0 + wr;
  const int wlast = wfirst + 16 * MT - 1;
  const float sl2 = scale * 1.4426950408889634f;
  const long long rows = ((long long)b * H + h) * S;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_tiles = CAUSAL ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int n_mine = wfirst >= S ? 0
                     : CAUSAL ? min(n_tiles, wlast / BK + 1) : n_tiles;
  float l2[MT][2], dd[MT][2];           // lse log2 e and D of the rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wfirst + 16 * mt + gr + 8 * r;
      l2[mt][r] = row < S ? lse[rows + row] * 1.4426950408889634f : 0.0f;
      dd[mt][r] = row < S ? dsum[rows + row] : 0.0f;
    }

  tf_fetch<BQ, HD, true>(sq, q + b * st.qb + h * st.qh, st.qs, q0, S);
  tf_fetch<BQ, HD, true>(sg, dout + b * st.gb + h * st.gh, st.gs, q0, S);
  tf_fetch<BK, HD, false>(rk, kb, st.ks, 0, S);
  tf_fetch<BK, HD, false>(rv, vb, st.vs, 0, S);
  cp_async_commit();

  float dqa[MT][HD / 8][4], sa[MT][BK / 8][4], pa[MT][BK / 8][4];
  zero(dqa);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    cp_async_wait_all();
    __syncthreads();              // tile t landed; t - 1 is consumed
    tf_split<BK, HD>(sk, rk);
    tf_split<BK, HD>(sv, rv);
    __syncthreads();
    if (t + 1 < n_tiles) {
      tf_fetch<BK, HD, false>(rk, kb, st.ks, k0 + BK, S);
      tf_fetch<BK, HD, false>(rv, vb, st.vs, k0 + BK, S);
      cp_async_commit();
    }
    if (t >= n_mine) continue;
    zero(sa);
    zero(pa);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {   // S = Q K^T, dP = dO V^T
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf_frag_a<HD>(sq, wr + 16 * mt, 8 * kk, gr, t4, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bh[2], bl[2];
        tf_frag_b_rows<BK, HD>(sk, 8 * j, 8 * kk, gr, t4, bh, bl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3_tf32(sa[mt][j], ah[mt], al[mt], bh, bl);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf_frag_a<HD>(sg, wr + 16 * mt, 8 * kk, gr, t4, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bh[2], bl[2];
        tf_frag_b_rows<BK, HD>(sv, 8 * j, 8 * kk, gr, t4, bh, bl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3_tf32(pa[mt][j], ah[mt], al[mt], bh, bl);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row0 = wfirst + 16 * mt + gr;   // rows row0 and row0 + 8
      // edge tiles (keys past S or above a row of this m16 tile) are masked
      const bool edge = k0 + BK > S || (CAUSAL && k0 + BK - 1 > row0 - gr);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          float p = ex2(fmaf(sa[mt][j][e], sl2, -l2[mt][r]));
          if (edge && (key >= S || (CAUSAL && key > row0 + 8 * r)))
            p = 0.0f;
          pa[mt][j][e] = p * (pa[mt][j][e] - dd[mt][r]);
        }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {   // dQ += dS K, 2 k-steps
      uint32_t ah[2][MT][4], al[2][MT][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tf_acc_as_a(pa[mt][j + u], ah[u][mt], al[u][mt]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          tf_frag_b_cols<BK, HD>(sk, 8 * (j + u), 8 * n, gr, t4, bh[u],
                                 bl[u]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma6_tf32_add(dqa[mt][n], ah[0][mt], al[0][mt], bh[0], bl[0],
                        ah[1][mt], al[1][mt], bh[1], bl[1]);
      }
    }
  }
  if (wfirst >= S) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wfirst + 16 * mt + gr + 8 * r;
      if (row >= S) continue;
      const long long at = (((long long)b * S + row) * H + h) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(dq + at + 8 * n) = make_float2(
            scale * dqa[mt][n][2 * r], scale * dqa[mt][n][2 * r + 1]);
    }
}

template <int HD>
struct TfSmem {   // dynamic shared memory of the three kernels, in bytes
  using T = TfTiles<HD>;
  static constexpr int kLD = HD + 4;   // a padded row, in elements
  // raw A rows, split B tiles (pairs), the B tiles' staging
  static constexpr int kFwd =
      (T::kRows * kLD + 4 * T::kFwdBK * kLD + 2 * T::kFwdBK * HD) * 4;
  static constexpr int kDkv = (2 * T::kRows * kLD + 4 * T::kDkvBQ * kLD +
                               2 * T::kDkvBQ * HD + 2 * T::kDkvBQ) * 4;
  static constexpr int kDq =
      (2 * T::kRows * kLD + 4 * T::kDqBK * kLD + 2 * T::kDqBK * HD) * 4;
};

template <int HD, bool CAUSAL>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int S, int H, const Strides& st,
                    float scale, cudaStream_t stream) {
  constexpr int kRows = TfTiles<HD>::kRows;
  static unsigned long long set = 0;
  auto kernel = flash_fwd_kernel_tf32<HD, CAUSAL>;
  const cudaError_t err = allow_smem(kernel, TfSmem<HD>::kFwd, &set, true);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kRows - 1) / kRows));
  kernel<<<grid, kTfThreads, TfSmem<HD>::kFwd, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, st,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd_tf32_causal(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int H,
                           int causal, const Strides& st, float scale,
                           cudaStream_t stream) {
  return causal ? launch_fwd_tf32<HD, true>(q, k, v, o, lse, B, S, H, st,
                                            scale, stream)
                : launch_fwd_tf32<HD, false>(q, k, v, o, lse, B, S, H, st,
                                             scale, stream);
}

template <int HD, bool CAUSAL>
int launch_bwd_tf32(int pass, const void* q, const void* k, const void* v,
                    const void* g, const float* lse, const float* dsum,
                    void* d0, void* d1, int B, int S, int H,
                    const BwdStrides& st, float scale, cudaStream_t stream) {
  constexpr int kRows = TfTiles<HD>::kRows;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kRows - 1) / kRows));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  cudaError_t err;
  if (pass == 0) {
    static unsigned long long set = 0;
    auto kernel = flash_bwd_dkdv_tf32<HD, CAUSAL>;
    err = allow_smem(kernel, TfSmem<HD>::kDkv, &set, true);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTfThreads, TfSmem<HD>::kDkv, stream>>>(
        qt, kt, vt, gt, lse, dsum, static_cast<float*>(d0),
        static_cast<float*>(d1), S, H, st, scale);
  } else {
    static unsigned long long set = 0;
    auto kernel = flash_bwd_dq_tf32<HD, CAUSAL>;
    err = allow_smem(kernel, TfSmem<HD>::kDq, &set, true);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTfThreads, TfSmem<HD>::kDq, stream>>>(
        qt, kt, vt, gt, lse, dsum, static_cast<float*>(d0), S, H, st, scale);
  }
  return (int)cudaGetLastError();
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
  return causal ? launch_bwd_tf32<HD, true>(pass, q, k, v, g, lse, dsum, d0,
                                            d1, B, S, H, st, scale, stream)
                : launch_bwd_tf32<HD, false>(pass, q, k, v, g, lse, dsum, d0,
                                             d1, B, S, H, st, scale, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// cudaErrorInvalidValue for a head dim or type the kernels do not take, and
// minus the CUresult when the driver refuses a bf16 tensor map. `dtype` is
// 0 for f32 (flash_fwd_kernel_tf32), 1 for bf16 (flash_fwd_kernel_wgmma);
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
    return launch_fwd_tf32_causal<64>(q, k, v, o, lse, B, S, H, causal, st,
                                      scale, s);
  if (dtype == 0 && hd == 128)
    return launch_fwd_tf32_causal<128>(q, k, v, o, lse, B, S, H, causal, st,
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
// pitch `pitch`: for f32 (flash_bwd_dkdv_tf32, flash_bwd_dq_tf32) the
// natural-log LSE with pitch == S; for bf16 (flash_bwd_dkdv_wgmma,
// flash_bwd_dq_wgmma) its lse2, with pitch a multiple of 128 (kRowsPad) of
// at least S. Returns as
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
