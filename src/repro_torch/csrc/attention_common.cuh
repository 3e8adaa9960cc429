// Device code shared by the port's attention kernels (sm_90a).
//
// * Numeric helpers: conversions between the storage types (float,
//   bfloat16, half) and f32, rounding an f32 value through a storage type,
//   warp reductions.
// * decode_attend: the flash-decode loop of one (request, KV head) block,
//   the body of the TPU kernels' _decode_body
//   (src/repro/kernels/decode_attention.py).  The contiguous-cache kernel
//   (decode_attention.cu) and the paged one (paged_decode_attention.cu)
//   differ only in where the rows of tile j live, which the caller passes
//   as a functor.
//
// Numerics mirror _decode_body: q is scaled by 1/sqrt(hd) in f32; the
// running max, denominator and accumulator are f32; masked scores are
// -0.7 * FLT_MAX; p is rounded to V's dtype before the PV product, and each
// tile's PV product is rounded to V's dtype (the TPU dot returns V's dtype)
// before it joins the accumulator; the output is acc / max(l, 1e-30).

#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// Round an f32 value through T (round to nearest even) and back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// Flash-decode of one (request, KV head) block.
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kMaxPerLane = 8;   // hd <= 256: hd / 32 values per lane
constexpr int kGChunk = 8;       // query heads accumulated per PV pass

// Dynamic shared memory decode_attend needs for G query heads of hd dims
// and tiles of `tile` rows.
inline size_t decode_smem_bytes(int G, int hd, int tile) {
  return (size_t)(2 * G * hd + G * tile + 3 * G) * sizeof(float);
}

// One block of kDecodeThreads threads attends the G = H / KV query heads
// of KV head `kvh` of request `b` to rows [0, kv_len) of its cache, walked
// in tiles of `tile` rows: tile_base(j) is the element offset, in k and v,
// of row j * tile for this KV head; rows inside a tile are KV * hd
// elements apart.  Tiles at or past ceil(kv_len / tile) are never touched,
// and rows past kv_len in the last tile are masked without being read, so
// whatever lies there (stale rows, poison) cannot reach the output.
template <typename T, typename TileBase>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q,
                                              const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              T* __restrict__ out, int b, int kvh, int H,
                                              int KV, int hd, int tile, int kv_len,
                                              float scale, TileBase tile_base) {
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_lane = hd / 32;

  extern __shared__ float smem[];
  float* qs = smem;              // (G, hd)   q * scale
  float* acc = qs + G * hd;      // (G, hd)   running PV accumulator
  float* s = acc + G * hd;       // (G, tile) scores, then rounded p
  float* m = s + G * tile;       // (G,)      running max
  float* l = m + G;              // (G,)      running denominator
  float* corr = l + G;           // (G,)      this tile's rescale factor

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kDecodeThreads) {
    qs[i] = to_f32(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KV * hd;
  const int n_tiles = kv_len > 0 ? (kv_len + tile - 1) / tile : 0;
  for (int j = 0; j < n_tiles; ++j) {
    const size_t base = tile_base(j);
    const T* kp = k + base;
    const T* vp = v + base;
    const int valid = min(tile, kv_len - j * tile);

    // 1. scores s[g, t] = q_g . k_t: one warp per key row, the row held
    //    in registers while the warp reduces it against every head.
    for (int t = warp; t < tile; t += kDecodeWarps) {
      if (t >= valid) {
        for (int g = lane; g < G; g += 32) s[g * tile + t] = kNegInf;
        continue;
      }
      const T* krow = kp + (size_t)t * row_stride;
      float kr[kMaxPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i)
        kr[i] = i < per_lane ? to_f32(krow[lane + 32 * i]) : 0.f;
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * hd;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i)
          if (i < per_lane) part += qg[lane + 32 * i] * kr[i];
        part = warp_sum(part);
        if (lane == 0) s[g * tile + t] = part;
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head: new max, p = exp(s - m),
    //    l = l * corr + sum(p) in f32; p is kept rounded to T for PV.
    for (int g = warp; g < G; g += kDecodeWarps) {
      float* sg = s + g * tile;
      float mx = kNegInf;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const float p = expf(sg[t] - m_new);
        sum += p;
        sg[t] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + round_T(p @ V): each thread owns head dims and
    //    reads every valid V row once for up to kGChunk heads.
    for (int g0 = 0; g0 < G; g0 += kGChunk) {
      const int gn = min(kGChunk, G - g0);
      for (int d = tid; d < hd; d += kDecodeThreads) {
        float pv[kGChunk];
#pragma unroll
        for (int gi = 0; gi < kGChunk; ++gi) pv[gi] = 0.f;
        for (int t = 0; t < valid; ++t) {
          const float vv = to_f32(vp[(size_t)t * row_stride + d]);
#pragma unroll
          for (int gi = 0; gi < kGChunk; ++gi)
            if (gi < gn) pv[gi] += s[(g0 + gi) * tile + t] * vv;
        }
#pragma unroll
        for (int gi = 0; gi < kGChunk; ++gi) {
          if (gi < gn) {
            const int g = g0 + gi;
            acc[g * hd + d] = acc[g * hd + d] * corr[g] + round_to<T>(pv[gi]);
          }
        }
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kDecodeThreads)
    ob[i] = from_f32<T>(acc[i] / fmaxf(l[i / hd], 1e-30f));
}

// Raise a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.  Returns a cudaError_t (0 on success).
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace attn
