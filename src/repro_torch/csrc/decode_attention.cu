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
// The kernels, their bound, design and numerics are decode_split.cuh's,
// with row r of request b at ((b * T + r) * KV + kvh) * hd.

#include "decode_split.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  `lens` may be null, and
// then every request attends `kv_len` rows.  split_rows (R, a multiple of
// 64) cuts each request's rows into ns = ceil(T / R) splits; acc (B, H,
// ns, hd), m and l (B, H, ns) are f32 scratch, tickets (B, KV,
// ceil(G / 16)) int32 counters that are zero before the launch and zero
// again after it (the last block of a group resets its own).  Launches
// on `stream` and does not wait; returns the launch's cudaError_t (0 on
// success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lens, void* out, void* acc, void* m,
                                       void* l, void* tickets, int B, int H, int KV, int hd,
                                       int T_len, int kv_len, int split_rows, float scale,
                                       int dtype, void* stream) {
  if (split_rows < 1) return (int)cudaErrorInvalidValue;
  const decode_split::Params p{
      q, k, v, lens, nullptr, out, static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<int*>(tickets), B, H, KV, hd, T_len, kv_len,
      split_rows, (T_len + split_rows - 1) / split_rows, 0, 0, scale};
  return decode_split::launch<decode_split::ContiguousRows>(p, dtype,
                                                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
