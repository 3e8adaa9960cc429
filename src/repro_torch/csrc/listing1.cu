// The paper's Listing-1 microbenchmark on Hopper's tensor cores (sm_90a):
// two reads of the SM's cycle counter around N dependent mma.sync, each
// one's D the next one's C, as Listing 1 chains v_mfma through [C] "v"(d).
//
// Not a TPU kernel's twin: it is the card-side step of the reference's
// simulated stream (src/repro/core/microbench.py: build_listing1), which
// the paper ran on MI200 and MI300 hardware.  Eq. 1 reads its stamps
// (repro_torch.core.microbench.eq1_latency).
//
// Geometry: one block of one warp.  A variant per operand type of the
// paper's validated set (kind codes as in kernels/listing1.py):
//   0  f64   mma.m8n8k4   A (8, 4) f64,    B (4, 8) f64,    C/D (8, 8) f64
//   1  tf32  mma.m16n8k8  A (16, 8) f32,   B (8, 8) f32,    C/D (16, 8) f32
//   2  f16   mma.m16n8k16 A (16, 16) f16,  B (16, 8) f16,   C/D (16, 8) f32
//   3  bf16  mma.m16n8k16 A (16, 16) bf16, B (16, 8) bf16,  C/D (16, 8) f32
//   4  s8    mma.m16n8k32 A (16, 32) s8,   B (32, 8) s8,    C/D (16, 8) s32
// all row-major and contiguous.  The tf32 variant hands the f32 bits to
// the tensor core as they are (it reads the top 19 bits), so its operands
// are exact only when their low 13 mantissa bits are zero, as the
// integer-valued operands of the checks are.
//
// The stream (lines 2-10 of Listing 1):
//   * the fragments are loaded and folded into one word that is stored
//     before the first stamp, so the loads have landed when it is read
//     (Listing 1's s_waitcnt);
//   * start = %clock64;
//   * N x mma.sync with D == C: a true dependency chain, each waits for
//     the previous one's full latency;
//   * end = %clock64, which does not wait for the last mma (nothing reads
//     its D before the stamp), as the second s_memtime does not;
//   * D, then the stamps, are stored.
// So end - start = (N - 1) T_mma + T_probe, where T_probe (the paper's
// T_memtime + T_inst) is what the N = 0 variant measures.  wgmma is left
// out: it issues asynchronously and is waited on with a fence, which does
// not give Listing 1's in-order chain.
//
// Bound: latency, not bytes or operations.  One launch moves at most a
// few KB and does N x 2 m n k operations (N x 4096 for f16/bf16), which
// the card's peaks would finish in nanoseconds; the time is one warp's
// chain of dependent tensor-core latencies plus the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr int kMaxN = 8;

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// Two 16-bit elements p[0], p[1] as one fragment register, p[0] low.
__device__ __forceinline__ uint32_t pair16(const uint16_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 16);
}

// Four 8-bit elements p[0..3] as one fragment register, p[0] lowest.
__device__ __forceinline__ uint32_t quad8(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// g = lane / 4, t = lane % 4 name each lane's fragment elements.

template <int N>
__device__ void chain_f64(const double* A, const double* B, const double* C, double* D,
                          long long* stamps) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const double a = A[g * 4 + t];
  const double b = B[t * 8 + g];
  double d0 = C[g * 8 + 2 * t], d1 = C[g * 8 + 2 * t + 1];
  const unsigned long long fold = __double_as_longlong(a) ^ __double_as_longlong(b) ^
                                  __double_as_longlong(d0) ^ __double_as_longlong(d1);
  stamps[2 + lane] = static_cast<long long>(fold);
  const long long start = stamp();
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(d0), "+d"(d1)
                 : "d"(a), "d"(b));
  const long long end = stamp();
  D[g * 8 + 2 * t] = d0;
  D[g * 8 + 2 * t + 1] = d1;
  if (lane == 0) {
    stamps[0] = start;
    stamps[1] = end;
  }
}

// The f32-accumulator 16 x 8 C/D fragment: register r holds row g + 8 (r >= 2),
// column 2 t + (r & 1).
__device__ __forceinline__ int acc_index(int g, int t, int r) {
  return (g + 8 * (r >> 1)) * 8 + 2 * t + (r & 1);
}

template <int N>
__device__ void chain_tf32(const float* A, const float* B, const float* C, float* D,
                           long long* stamps) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  // A register r: row g + 8 (r & 1), column t + 4 (r >= 2); B register r: row t + 4 r, column g.
  uint32_t a[4], b[2];
  float d[4];
  for (int r = 0; r < 4; ++r) a[r] = bits(A[(g + 8 * (r & 1)) * 8 + t + 4 * (r >> 1)]);
  for (int r = 0; r < 2; ++r) b[r] = bits(B[(t + 4 * r) * 8 + g]);
  for (int r = 0; r < 4; ++r) d[r] = C[acc_index(g, t, r)];
  const uint32_t fold = a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1] ^ bits(d[0]) ^ bits(d[1]) ^
                        bits(d[2]) ^ bits(d[3]);
  stamps[2 + lane] = fold;
  const long long start = stamp();
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  const long long end = stamp();
  for (int r = 0; r < 4; ++r) D[acc_index(g, t, r)] = d[r];
  if (lane == 0) {
    stamps[0] = start;
    stamps[1] = end;
  }
}

// f16 / bf16 through mma::Mma<T> (mma_common.cuh): A register r holds row
// g + 8 (r & 1), columns 2 t + 8 (r >= 2) and the next; B register r holds
// rows 2 t + 8 r and the next of column g.
template <typename T, int N>
__device__ void chain_16(const uint16_t* A, const uint16_t* B, const float* C, float* D,
                         long long* stamps) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4], b[2];
  float d[4];
  for (int r = 0; r < 4; ++r) a[r] = pair16(A + (g + 8 * (r & 1)) * 16 + 2 * t + 8 * (r >> 1));
  for (int r = 0; r < 2; ++r) {
    const uint16_t lo = B[(2 * t + 8 * r) * 8 + g], hi = B[(2 * t + 8 * r + 1) * 8 + g];
    b[r] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
  for (int r = 0; r < 4; ++r) d[r] = C[acc_index(g, t, r)];
  const uint32_t fold = a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1] ^ bits(d[0]) ^ bits(d[1]) ^
                        bits(d[2]) ^ bits(d[3]);
  stamps[2 + lane] = fold;
  const long long start = stamp();
#pragma unroll
  for (int i = 0; i < N; ++i) mma::Mma<T>::run(d, a, b);
  const long long end = stamp();
  for (int r = 0; r < 4; ++r) D[acc_index(g, t, r)] = d[r];
  if (lane == 0) {
    stamps[0] = start;
    stamps[1] = end;
  }
}

// s8 m16n8k32: A register r holds row g + 8 (r & 1), columns 4 t + 16 (r >= 2)
// and the next three; B register r holds rows 4 t + 16 r .. + 3 of column g.
template <int N>
__device__ void chain_s8(const int8_t* A, const int8_t* B, const int* C, int* D,
                         long long* stamps) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint8_t* Au = reinterpret_cast<const uint8_t*>(A);
  const uint8_t* Bu = reinterpret_cast<const uint8_t*>(B);
  uint32_t a[4], b[2];
  int d[4];
  for (int r = 0; r < 4; ++r) a[r] = quad8(Au + (g + 8 * (r & 1)) * 32 + 4 * t + 16 * (r >> 1));
  for (int r = 0; r < 2; ++r) {
    uint8_t col[4];
    for (int i = 0; i < 4; ++i) col[i] = Bu[(4 * t + 16 * r + i) * 8 + g];
    b[r] = quad8(col);
  }
  for (int r = 0; r < 4; ++r) d[r] = C[acc_index(g, t, r)];
  const uint32_t fold = a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1] ^ d[0] ^ d[1] ^ d[2] ^ d[3];
  stamps[2 + lane] = fold;
  const long long start = stamp();
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  const long long end = stamp();
  for (int r = 0; r < 4; ++r) D[acc_index(g, t, r)] = d[r];
  if (lane == 0) {
    stamps[0] = start;
    stamps[1] = end;
  }
}

template <int KIND, int N>
__global__ void __launch_bounds__(32) listing1_kernel(const void* A, const void* B,
                                                      const void* C, void* D,
                                                      long long* stamps) {
  if constexpr (KIND == 0) {
    chain_f64<N>(static_cast<const double*>(A), static_cast<const double*>(B),
                 static_cast<const double*>(C), static_cast<double*>(D), stamps);
  } else if constexpr (KIND == 1) {
    chain_tf32<N>(static_cast<const float*>(A), static_cast<const float*>(B),
                  static_cast<const float*>(C), static_cast<float*>(D), stamps);
  } else if constexpr (KIND == 2) {
    chain_16<__half, N>(static_cast<const uint16_t*>(A), static_cast<const uint16_t*>(B),
                        static_cast<const float*>(C), static_cast<float*>(D), stamps);
  } else if constexpr (KIND == 3) {
    chain_16<__nv_bfloat16, N>(static_cast<const uint16_t*>(A),
                               static_cast<const uint16_t*>(B), static_cast<const float*>(C),
                               static_cast<float*>(D), stamps);
  } else {
    chain_s8<N>(static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
                static_cast<const int*>(C), static_cast<int*>(D), stamps);
  }
}

template <int KIND, int N>
int launch_n(int n, const void* A, const void* B, const void* C, void* D, long long* stamps,
             cudaStream_t st) {
  if constexpr (N > kMaxN) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_n<KIND, N + 1>(n, A, B, C, D, stamps, st);
    listing1_kernel<KIND, N><<<1, 32, 0, st>>>(A, B, C, D, stamps);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// One launch of the kind's stream with n in [0, 8] chained mma (n = 0: the
// probe overhead).  stamps holds 34 int64: start, end, then one word per
// lane that keeps the operand fold (no meaning of its own).
extern "C" int listing1_launch(int kind, int n, const void* A, const void* B, const void* C,
                               void* D, long long* stamps, void* stream) {
  if (n < 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_n<0, 0>(n, A, B, C, D, stamps, st);
    case 1:
      return launch_n<1, 0>(n, A, B, C, D, stamps, st);
    case 2:
      return launch_n<2, 0>(n, A, B, C, D, stamps, st);
    case 3:
      return launch_n<3, 0>(n, A, B, C, D, stamps, st);
    case 4:
      return launch_n<4, 0>(n, A, B, C, D, stamps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* listing1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
