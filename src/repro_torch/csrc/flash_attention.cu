// Causal grouped-query flash attention for Hopper (sm_90a): a prefill (or
// training) step's S query rows against T key/value rows.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py: _flash_kernel), which the
// synchronous serve engine runs once per layer on every prefill.
//
// Operands (row-major, contiguous):
//   q        (B, S, H, hd)     queries, H = KV * G
//   k, v     (B, T, KV, hd)    keys and values; rows >= kv_len are masked
//   out      (B, S, H, hd)     in q's dtype; rows >= S are never written
//
// Design.  One block of 256 threads per (request, query head, tile of 64
// query rows).  The block reads the K/V rows of its KV head h / G straight
// from the cache (the TPU wrapper repeats K/V G times first) and walks
// them in tiles of 64 rows, keeping the online softmax's running max,
// denominator and accumulator in registers in f32.  Tiles wholly past
// kv_len, and (causal) wholly above the diagonal, are never read.  Each
// thread owns 4 query rows by 4 score columns of a tile and 4 rows by
// hd / 16 output dims; the q tile, the current K (then V) tile and the
// rounded p tile sit in shared memory as f32, rows padded by one word so
// the column reads do not collide in a bank.  Ragged S and T are masked
// here, which computes what the TPU path's pad, mask and slice computes.
//
// Numerics mirror _flash_kernel: q is scaled by 1/sqrt(hd) in f32 and the
// scores are f32 dot products; masked scores are -0.7 * FLT_MAX; p is
// rounded to V's dtype before the PV product, and each tile's PV product
// is rounded to V's dtype (the TPU dot returns V's dtype) before it joins
// the accumulator; the output is acc / max(l, 1e-30).
//
// Bound: operations at full width.  A causal 2048-row prefill of qwen2-7b
// does 4 * H * S * T * hd / 2 = 30 GFLOP on 34 MB of q, k, v and out,
// ~900 flops per byte, above the ~295 where an H100's bf16 tensor cores
// take over from memory as the limit.  This first version is simple and
// right and runs its products on CUDA cores in f32 (67 TFLOP/s peak, not
// the 989 of the tensor cores); wgmma on bf16 tiles fed by TMA is later
// work.

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::kNegInf;
using attn::round_to;
using attn::to_f32;

constexpr int kBQ = 64;           // query rows per block
constexpr int kBKV = 64;          // key/value rows per step (TILE in flash_attention.py)
constexpr int kThreads = 256;     // 16 x 16 threads (ty, tx)
constexpr int kRows = kBQ / 16;   // query rows per thread: ty + 16 i
constexpr int kCols = kBKV / 16;  // score columns per thread: tx + 16 c

template <int HD>
constexpr size_t smem_bytes() {
  return ((size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) + (size_t)kBQ * (kBKV + 1)) *
         sizeof(float);
}

// Max over the 16 lanes that share a query row (one half of the warp).
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int T_len, int H, int KV, int kv_len, int causal,
             float scale) {
  constexpr int LD = HD + 1;       // padded row of the q and K/V tiles
  constexpr int LDP = kBKV + 1;    // padded row of the p tile
  constexpr int kDims = HD / 16;   // output dims per thread: tx + 16 e
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* qs = smem;              // (kBQ, LD)  q * scale
  float* kv = qs + kBQ * LD;     // (kBKV, LD) the K tile, then the V tile
  float* ps = kv + kBKV * LD;    // (kBQ, LDP) p rounded to T

  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)KV * HD;
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * T_len * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * T_len * kv_row + (size_t)kvh * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * LD + d] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) * scale : 0.f;
  }

  // rows attended, and the tiles that hold any of them for these queries
  const int n = min(kv_len, T_len);
  int n_tiles = n > 0 ? (n + kBKV - 1) / kBKV : 0;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, S) - 1) / kBKV + 1);

  float m[kRows], l[kRows], corr[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kBKV;
    const int valid = min(kBKV, n - t0);
    __syncthreads();   // the q tile is stored; the last tile's readers are done
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      kv[c * LD + d] = c < valid ? to_f32(kb[(size_t)(t0 + c) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // 1. scores s = (q * scale) . k in f32, masked past kv_len and above
    //    the diagonal; then the online softmax of each row over its 16 lanes
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bk[c] = kv[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] += a[i] * bk[c];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = t0 + tx + 16 * c;
        if (col >= n || (causal && col > row)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        s[i][c] = round_to<T>(p);
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();   // every thread is done with the K tile

    // 2. acc = acc * corr + round_T(p @ V)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) ps[(ty + 16 * i) * LDP + tx + 16 * c] = s[i][c];
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      kv[c * LD + d] = c < valid ? to_f32(vb[(size_t)(t0 + c) * kv_row + d]) : 0.f;
    }
    __syncthreads();
    float pv[kRows][kDims];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) pv[i][e] = 0.f;
    for (int c = 0; c < valid; ++c) {
      float a[kRows], bv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < kDims; ++e) bv[e] = kv[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kDims; ++e) pv[i][e] += a[i] * bv[e];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] = acc[i][e] * corr[i] + round_to<T>(pv[i][e]);
  }

  T* ob = out + (size_t)b * S * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      ob[(size_t)row * q_row + tx + 16 * e] = from_f32<T>(acc[i][e] / fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int H, int KV, int kv_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  const int e = attn::allow_smem(flash_kernel<T, HD>, smem);
  if (e) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, T_len, H, KV, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
              int H, int KV, int hd, int kv_len, int causal, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; hd 32, 64 or 128.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream` and is not waited for.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int T_len, int H, int KV, int hd,
                                      int kv_len, int causal, float scale, int dtype,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(q, k, v, out, B, S, T_len, H, KV, hd, kv_len, causal, scale,
                              st);
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, T_len, H, KV, hd, kv_len, causal,
                                      scale, st);
    case 2:
      return launch_hd<__half>(q, k, v, out, B, S, T_len, H, KV, hd, kv_len, causal, scale,
                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
