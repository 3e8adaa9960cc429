// Tensor-core and copy helpers shared by the port's sm_90a kernels
// (mfma_gemm.cu, flash_attention.cu, decode_split.cuh, moe_gmm.cu).
//
// * Mma<T>::run: one mma.sync.aligned.m16n8k16 step, d = a.b + d, with
//   bf16 or f16 operands and f32 accumulators.  Fragment layouts (g =
//   lane / 4, t = lane % 4): the accumulator register r holds row
//   g + 8 (r >= 2), column 2 t + (r & 1) of the 16 x 8 tile; A register
//   r holds the two elements (row g + 8 (r & 1), columns 2 t + 8 (r >= 2)
//   and the next); B register r holds rows 2 t + 8 r and the next of
//   column g.  So two accumulator tiles side by side, rounded and packed
//   in pairs, are the A fragment of the next product over their 16
//   columns.
// * ldmatrix_x4 / ldmatrix_x4_trans: four 8 x 8 matrices of 16-bit
//   elements from shared memory.
// * cp_async16 / cp_async_commit / cp_async_wait: 16-byte copies from
//   global to shared memory that bypass the registers, zero-filled when
//   the source is not valid.
// * pack2 / split2: f32 pairs as fragment registers of T, rounded once
//   (pack2) or as a high and a low part whose sum keeps f32's precision
//   (split2); unpack2 the f32 pair a register of T holds.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace mma {

// d = a.b + d on one m16n8k16 fragment (f32 accumulators).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Two f32 values rounded to T (to nearest even) and packed as one 32-bit
// fragment register, the first in the low half (the lower column).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values as two fragment registers of T whose sum is the pair:
// hi rounds them to T, lo rounds the remainders x - hi (exact in f32), so
// hi + lo is within a relative 2^-16 (bf16) or 2^-22 (f16, short of its
// subnormals) of each value.  A product taken as hi.b + lo.b keeps an f32
// operand's precision on the tensor cores.
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo);

template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x0, float x1, uint32_t& hi,
                                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <>
__device__ __forceinline__ void split2<__half>(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 r = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The two elements of a fragment register of T as f32, the low half first.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t r) {
  return __half22float2(*reinterpret_cast<const __half2*>(&r));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, each row of
// 16 bytes named by one lane (lanes 8 q .. 8 q + 7 name matrix q's rows);
// thread l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each
// matrix, or with .trans the same of its transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from global to shared memory without passing through registers;
// when !valid nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
