// Paged flash-decode attention for Hopper (sm_90a): one query token per
// request against a block-paged KV pool, grouped-query heads.
//
// Replaces the Pallas TPU kernel paged_decode_attention
// (src/repro/kernels/decode_attention.py: _paged_decode_kernel and its
// body _decode_body), which the paged serve engine runs once per layer
// on every decode tick.
//
// Operands (row-major, contiguous):
//   q        (B, H, hd)           query of each request's pending token
//   k_pool   (P, page, KV, hd)    shared key pool, page rows per block
//   v_pool   (P, page, KV, hd)    shared value pool
//   tables   (B, NB) int32        physical block of each logical page
//   lens     (B,)    int32        tokens each request attends (kv_len)
//   out      (B, H, hd)           in q's dtype
//
// Design.  One block of 128 threads per (KV head, request) walks the
// request's pages in order, exactly as the TPU grid walks its sequential
// kv axis; the G = H / KV query heads of the group share every K/V row
// the block reads, so each row is read from device memory once.  Pages at
// or past ceil(kv_len / page) are never touched, and rows past kv_len in
// the last page are masked without being read: table slots past a
// request's prefix (the engine points them at null block 0) and the
// stale rows of a recycled block cost nothing and cannot leak in.
//
// Numerics mirror _decode_body: q is scaled by 1/sqrt(hd) in f32; the
// running max, denominator and accumulator are f32; masked scores are
// -0.7 * FLT_MAX; p is rounded to V's dtype before the PV product, the
// page's PV product is rounded to V's dtype (the TPU dot returns V's
// dtype) before it joins the accumulator; the output is
// acc / max(l, 1e-30).
//
// Bound: bytes.  The kernel does ~4 * G * hd flops per K/V row it reads
// (2 * KV * hd elements), about 2 * G flops per byte in bf16 -- far below
// the ~295 flops per byte where an H100's tensor cores would become the
// limit.  Its floor is reading each attended K/V row once:
// sum_b kv_len[b] * KV * hd * 2 * sizeof(T) bytes at 3.35 TB/s.  This
// first version is simple and right: scores and PV run on CUDA cores
// from plain loads, with B * KV blocks in flight (32 for qwen2-7b at
// B = 8), which leaves most of the 132 SMs idle; splitting the pages of
// a request over several blocks, cp.async/TMA loads and wgmma are later
// work.

#include <cfloat>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 8;   // hd <= 256: hd / 32 values per lane
constexpr int kGChunk = 8;       // query heads accumulated per pass
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int H, int KV,
                    int hd, int page, int NB, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_lane = hd / 32;

  extern __shared__ float smem[];
  float* qs = smem;              // (G, hd)   q * scale
  float* acc = qs + G * hd;      // (G, hd)   running PV accumulator
  float* s = acc + G * hd;       // (G, page) scores, then rounded p
  float* m = s + G * page;       // (G,)      running max
  float* l = m + G;              // (G,)      running denominator
  float* corr = l + G;           // (G,)      this page's rescale factor

  const int kv_len = lens[b];
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = to_f32(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KV * hd;
  const int n_pages = kv_len > 0 ? (kv_len + page - 1) / page : 0;
  for (int j = 0; j < n_pages; ++j) {
    const size_t blk = (size_t)tables[(size_t)b * NB + j];
    const size_t base = blk * (size_t)page * row_stride + (size_t)kvh * hd;
    const T* kp = k_pool + base;
    const T* vp = v_pool + base;
    const int valid = min(page, kv_len - j * page);

    // 1. scores s[g, t] = q_g . k_t: one warp per key row, the row held
    //    in registers while the warp reduces it against every head.
    for (int t = warp; t < page; t += kWarps) {
      if (t >= valid) {
        for (int g = lane; g < G; g += 32) s[g * page + t] = kNegInf;
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
        if (lane == 0) s[g * page + t] = part;
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head: new max, p = exp(s - m),
    //    l = l * corr + sum(p) in f32; p is kept rounded to T for PV.
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s + g * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
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
      for (int d = tid; d < hd; d += kThreads) {
        float pv[kGChunk];
#pragma unroll
        for (int gi = 0; gi < kGChunk; ++gi) pv[gi] = 0.f;
        for (int t = 0; t < valid; ++t) {
          const float vv = to_f32(vp[(size_t)t * row_stride + d]);
#pragma unroll
          for (int gi = 0; gi < kGChunk; ++gi)
            if (gi < gn) pv[gi] += s[(g0 + gi) * page + t] * vv;
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
  for (int i = tid; i < G * hd; i += kThreads)
    ob[i] = from_f32<T>(acc[i] / fmaxf(l[i / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lens, void* out, int B, int H, int KV, int hd, int page, int NB,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = (size_t)(2 * G * hd + G * page + 3 * G) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(KV, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lens, static_cast<T*>(out), H, KV, hd, page,
      NB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream` and is not
// waited for.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const int* tables,
                                             const int* lens, void* out, int B, int H,
                                             int KV, int hd, int page, int NB, float scale,
                                             int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tables, lens, out, B, H, KV, hd, page, NB,
                           scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lens, out, B, H, KV, hd,
                                   page, NB, scale, st);
    case 2:
      return launch<__half>(q, k_pool, v_pool, tables, lens, out, B, H, KV, hd, page, NB,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
