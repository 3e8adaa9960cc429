// Flash-decode attention for Hopper (sm_90a): one query token per request
// against a contiguous KV cache, grouped-query heads.
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention.py: _decode_kernel and its body
// _decode_body), which the synchronous serve engine runs once per layer
// on every decode step.
//
// Operands (row-major, contiguous):
//   q        (B, H, hd)       query of each request's new token
//   k, v     (B, T, KV, hd)   the cache, rows [0, kv_len) written
//   lens     (B,) int32       tokens each request attends, or null: then
//                             every request attends `kv_len` tokens
//   out      (B, H, hd)       in q's dtype
//
// Design.  One block of 128 threads per (KV head, request), as the TPU
// grid's (B * KV) programs: the G = H / KV query heads of the group share
// every K/V row the block reads, so each row is read from device memory
// once.  The block walks the cache in tiles of kTile rows up to
// min(kv_len, T); tiles past it are never touched and rows past it in the
// last tile are masked without being read, so stale rows of the cache
// cannot leak in.  The loop and its numerics are shared with the paged
// kernel (attention_common.cuh).
//
// Bound: bytes, as for the paged kernel: ~2 * G flops per byte of K/V in
// bf16, far below the ~295 flops per byte where an H100's tensor cores
// become the limit.  Its floor is reading each attended K/V row once:
// sum_b kv_len[b] * KV * hd * 2 * sizeof(T) bytes at 3.35 TB/s.  With
// B * KV blocks in flight (32 for qwen2-7b at B = 8) most of the 132 SMs
// idle; splitting a request's rows over several blocks is later work.

#include "attention_common.cuh"

namespace {

// cache rows per step of the online softmax (TILE in kernels/decode_attention.py)
constexpr int kTile = 64;

template <typename T>
__global__ void __launch_bounds__(attn::kDecodeThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lens, T* __restrict__ out, int H, int KV, int hd,
              int T_len, int kv_len, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int n = min(lens != nullptr ? lens[b] : kv_len, T_len);
  const size_t row_stride = (size_t)KV * hd;
  const size_t start = (size_t)b * T_len * row_stride + (size_t)kvh * hd;
  attn::decode_attend<T>(q, k, v, out, b, kvh, H, KV, hd, kTile, n, scale,
                         [=](int j) { return start + (size_t)j * kTile * row_stride; });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens, void* out, int B,
           int H, int KV, int hd, int T_len, int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = attn::decode_smem_bytes(H / KV, hd, kTile);
  const int e = attn::allow_smem(decode_kernel<T>, smem);
  if (e) return e;
  const dim3 grid(KV, B);
  decode_kernel<T><<<grid, attn::kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(out), H, KV, hd, T_len, kv_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  `lens` may be null, and
// then every request attends `kv_len` rows.  Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream` and is not
// waited for.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lens, void* out, int B, int H, int KV,
                                       int hd, int T_len, int kv_len, float scale, int dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, lens, out, B, H, KV, hd, T_len, kv_len, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lens, out, B, H, KV, hd, T_len, kv_len, scale,
                                   st);
    case 2:
      return launch<__half>(q, k, v, lens, out, B, H, KV, hd, T_len, kv_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
