// Fused forward attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention). It computes what repro's flash_attention
// computes: for q, k, v of shape [B, S, H, hd] (kv heads already expanded),
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
//
// over the keys j < S (and j <= i when causal), with scale = hd^-0.5 (in
// f32) applied after the dot, the running max starting at -1e30, f32
// running max, sum and output accumulator, and the result divided by
// max(l, 1e-30) and written in the input type. Inputs are f32 or bf16, hd
// is 64 or 128.
//
// Bound on this card: operations. A causal pass does about 2 B H S^2 hd
// flops (QK^T and PV over the lower triangle): 34.4 GFLOP at B = 4, S =
// 2048, H = 16, hd = 64, some 0.035 ms at the bf16 tensor-core peak, while
// it must move only 4 B S H hd * 2 bytes (67 MB, 0.020 ms at 3.35 TB/s).
// This kernel does not reach the tensor cores: it runs the products on the
// CUDA cores in f32, whose peak (67 TFLOP/s) puts the same work at about
// 0.5 ms, and issue slots, not bytes, set its time: 1.57 ms in bf16 at that
// shape on an H100 80GB HBM3 at 700 W, where PyTorch's
// scaled_dot_product_attention takes 0.10 ms.
//
// Design: simple and exact first. The TPU kernel walked the key blocks as a
// sequential grid axis with the accumulators in VMEM scratch; here blocks run
// in parallel in no order, so one CTA owns a tile of kBQ = 64 queries of one
// (b, h) and walks the key tiles itself. Each thread owns one query row's
// kDT = 64 head dims (hd = 128 takes two threads per row, which combine
// their partial dots with one shuffle), with its q slice and its output
// accumulator in registers. Key and value tiles of kBK = 64 rows are staged
// through shared memory as f32 (padded rows, so two threads of one query row
// read different banks), and every thread reads each staged row as a
// broadcast. The online-softmax update runs once per kChunk = 8 keys. The
// kernel reads [B, S, H, hd] through its strides (so the reference's moveaxis
// and pad copies are gone), zero-fills and masks keys at the ragged S edge,
// stops each warp at the last key any of its rows can see when causal (so
// k-tiles wholly above the diagonal are never loaded), and launches the
// longest query tiles first. The wgmma/TMA form with bf16 tensor-core
// products is the redesign that closes the gap to the bound.

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

template <>
struct Vec<__nv_bfloat16> {   // 16 bytes = 8 bf16
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <int HD>
constexpr int smem_bytes() {  // K and V tiles, f32, rows padded by 4
  return 2 * kBK * (HD + 4) * (int)sizeof(float);
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBQ * (HD / kDT)) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int H, Strides st,
    float scale) {
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
  }
}

template <typename T, int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, const Strides& st, float scale,
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
      static_cast<const T*>(v), static_cast<T*>(o), S, H, st, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_causal(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int causal, const Strides& st,
                  float scale, cudaStream_t stream) {
  return causal
             ? launch<T, HD, true>(q, k, v, o, B, S, H, st, scale, stream)
             : launch<T, HD, false>(q, k, v, o, B, S, H, st, scale, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// cudaErrorInvalidValue for a head dim or type the kernel does not take.
// `dtype` is 0 for f32, 1 for bf16; `strides` holds the element strides of
// the b, s and h axes of q, k, v and out, in that order (12 values; the hd
// axis is contiguous); `scale` is hd^-0.5 rounded to f32 by the caller. The
// caller allocates `o` and checks shapes, types, the 16-byte alignment of
// every row and the launch limits.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int hd, int dtype, int causal,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch_causal<float, 64>(q, k, v, o, B, S, H, causal, st, scale,
                                    s);
  if (dtype == 0 && hd == 128)
    return launch_causal<float, 128>(q, k, v, o, B, S, H, causal, st, scale,
                                     s);
  if (dtype == 1 && hd == 64)
    return launch_causal<__nv_bfloat16, 64>(q, k, v, o, B, S, H, causal, st,
                                            scale, s);
  if (dtype == 1 && hd == 128)
    return launch_causal<__nv_bfloat16, 128>(q, k, v, o, B, S, H, causal,
                                             st, scale, s);
  return (int)cudaErrorInvalidValue;
}
