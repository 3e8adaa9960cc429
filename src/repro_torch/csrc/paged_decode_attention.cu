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
// The kernels, their bound, design and numerics are decode_split.cuh's,
// with row r of request b in block tables[b, r / page] at row r % page:
// the table capacity NB * page plays the role of the contiguous cache's
// T, each 16-byte chunk's address is computed row by row (a tile or a
// split may cross a page boundary), and a split that starts at or past
// kv_len exits at once, so the table slots past a request's prefix,
// which point at null block 0, are never looked up.

#include "decode_split.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  split_rows (R, a
// multiple of 64) cuts each request's NB * page rows into ns =
// ceil(NB * page / R) splits; acc, m, l and tickets as in
// decode_attention_launch.  Launches on `stream` and does not wait;
// returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const int* tables,
                                             const int* lens, void* out, void* acc, void* m,
                                             void* l, void* tickets, int B, int H, int KV,
                                             int hd, int page, int NB, int split_rows,
                                             float scale, int dtype, void* stream) {
  if (split_rows < 1 || page < 1 || lens == nullptr) return (int)cudaErrorInvalidValue;
  const int T_len = NB * page;
  const decode_split::Params p{
      q, k_pool, v_pool, lens, tables, out, static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<int*>(tickets), B, H, KV, hd, T_len, 0,
      split_rows, (T_len + split_rows - 1) / split_rows, page, NB, scale};
  return decode_split::launch<decode_split::PagedRows>(p, dtype,
                                                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
