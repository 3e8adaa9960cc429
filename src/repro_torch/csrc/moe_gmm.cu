// Grouped (per-expert) matmul for capacity-based MoE on Hopper (sm_90a):
// out[e] = x[e] @ w[e] for every expert e.
//
// Replaces the Pallas TPU kernel moe_gmm (src/repro/kernels/moe_gmm.py:
// _gmm_kernel), which an MoE layer runs three times on every step: the
// gate and up projections over the (E, C, d_model) slot buffer and the
// down projection over the (E, C, d_ff_expert) one.
//
// Operands (row-major, contiguous):
//   x    (E, C, K)   each expert's C capacity slots
//   w    (E, K, N)   each expert's weight
//   out  (E, C, N)   in x's dtype; rows >= C and columns >= N never written
//
// Design.  One block of 256 threads per (expert, tile of 64 slot rows,
// tile of 64 output columns); consecutive blocks share an expert and its
// x tile, so x is read from L2 after the first of them.  The block streams
// K through shared memory in slices of 32: the x slice (stored transposed,
// rows padded by one word so neither the stores nor the column reads
// collide in a bank) and the w slice, both as f32.  Each thread owns 4
// rows by 4 columns of the output tile (rows ty + 16 i, columns tx + 16 j)
// and keeps their sums in registers in f32.  Ragged C, K and N are masked
// here: a load past an edge reads zero and a store past it never happens,
// which is exact for a GEMM and computes what the TPU path's zero-pad and
// slice computes.  Loads are 16 bytes a thread when K and N are multiples
// of 16 bytes' worth of elements and the operands are 16-byte aligned,
// one element a thread otherwise.
//
// Numerics mirror _gmm_kernel: products and sums in f32
// (preferred_element_type=float32), one rounding to x's dtype at the store.
//
// Bound: bytes at the decode shapes.  A decode step of qwen3-moe
// (E = 128, C = 32 slots, K = 4096, N = 1536) moves 1.66 GB, almost all of
// it w, for 51.5 GFLOP: 31 flops per byte, far below the ~295 where an
// H100's bf16 tensor cores take over from memory, so its bound is the
// weight read (0.49 ms at 3.35 TB/s).  This first version is simple and
// right and runs its products on CUDA cores in f32 (67 TFLOP/s peak, not
// the 989 of the tensor cores), which at these shapes makes it compute-
// bound above the bytes bound; mma/wgmma on bf16 tiles fed by TMA is later
// work.

#include <cstddef>
#include <cstdint>

#include "attention_common.cuh"  // to_f32 / from_f32 over the storage types

namespace {

using attn::from_f32;
using attn::to_f32;

constexpr int kBM = 64;          // slot rows per block
constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 32;          // contraction depth per shared-memory slice
constexpr int kThreads = 256;    // 16 x 16 threads (ty, tx)
constexpr int kRows = kBM / 16;  // rows per thread: ty + 16 i
constexpr int kCols = kBN / 16;  // columns per thread: tx + 16 j

// V consecutive elements from p (16-byte aligned when V > 1) as f32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector load is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(v[j]);
  }
}

// V is the elements per load: 16 bytes' worth, or 1 for the ragged path.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int C,
               int K, int N) {
  __shared__ float xs[kBK][kBM + 1];  // xs[k][row]: the x slice, transposed
  __shared__ float ws[kBK][kBN + 1];  // ws[k][col]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const T* xe = x + (size_t)e * C * K;
  const T* we = w + (size_t)e * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  constexpr int kXVecs = kBM * kBK / V;  // loads per x slice
  constexpr int kWVecs = kBK * kBN / V;  // loads per w slice
  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x slice: rows m0.., depth k0.., V elements along K per load; when
    // V > 1, K % V == 0, so a load is wholly inside or wholly past K.
    for (int i = tid; i < kXVecs; i += kThreads) {
      const int r = i / (kBK / V);
      const int c = (i % (kBK / V)) * V;
      const int row = m0 + r;
      const int kk = k0 + c;
      float v[V];
      if (row < C && kk < K) {
        load_vec<T, V>(xe + (size_t)row * K + kk, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) xs[c + j][r] = v[j];
    }
    // w slice: depth k0.., columns n0.., V elements along N per load.
    for (int i = tid; i < kWVecs; i += kThreads) {
      const int r = i / (kBN / V);
      const int c = (i % (kBN / V)) * V;
      const int kk = k0 + r;
      const int col = n0 + c;
      float v[V];
      if (kk < K && col < N) {
        load_vec<T, V>(we + (size_t)kk * N + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) ws[r][c + j] = v[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* oe = out + (size_t)e * C * N;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) oe[(size_t)row * N + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int K, int N,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if (aligned && K % V == 0 && N % V == 0) {
    gmm_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, K, N);
  } else {
    gmm_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream` and is not
// waited for.
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int E, int C, int K,
                              int N, int dtype, void* stream) {
  if (E < 1 || C < 1 || K < 1 || N < 1 || E > 65535 || (C + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, out, E, C, K, N, st);
    case 1:
      return launch<__nv_bfloat16>(x, w, out, E, C, K, N, st);
    case 2:
      return launch<__half>(x, w, out, E, C, K, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
