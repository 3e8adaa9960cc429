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
// Numerics mirror _decode_body (see attention_common.cuh, which holds the
// loop this kernel shares with decode_attention.cu).
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

#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(attn::kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int H, int KV,
                    int hd, int page, int NB, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int* tb = tables + (size_t)b * NB;
  const size_t page_stride = (size_t)page * KV * hd;
  const size_t head = (size_t)kvh * hd;
  attn::decode_attend<T>(q, k_pool, v_pool, out, b, kvh, H, KV, hd, page, lens[b], scale,
                         [=](int j) { return (size_t)tb[j] * page_stride + head; });
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lens, void* out, int B, int H, int KV, int hd, int page, int NB,
           float scale, cudaStream_t stream) {
  const size_t smem = attn::decode_smem_bytes(H / KV, hd, page);
  const int e = attn::allow_smem(paged_decode_kernel<T>, smem);
  if (e) return e;
  const dim3 grid(KV, B);
  paged_decode_kernel<T><<<grid, attn::kDecodeThreads, smem, stream>>>(
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
