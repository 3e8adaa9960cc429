// The MFMA contract at GEMM scale on Hopper (sm_90a): D = C + A @ B.
//
// Replaces the Pallas TPU kernel mfma_gemm (src/repro/kernels/mfma_gemm.py:
// _gemm_kernel), the paper's Matrix Core Engine contract tiled for the
// TPU's MXU.  Its counterpart of the MCE here is the tensor core: bf16 and
// f16 operands run on it through mma.sync.aligned.m16n8k16 with f32
// accumulator fragments loaded from C, which is one MFMA-style instruction
// D = C + A.B per 16 x 8 x 16 step.
//
// Operands (row-major, contiguous):
//   a  (M, K)   bf16, f16 or f32
//   b  (K, N)   a's dtype
//   c  (M, N)   f32, bf16 or f16; read once, seeds the f32 accumulator
//   d  (M, N)   c's dtype; rows >= M and columns >= N never written
//
// Numerics mirror _gemm_kernel: the f32 accumulator is seeded from C, the
// products are added in f32 (preferred_element_type=float32), and the
// result is rounded once to C's dtype.
//
// Design.  Hopper has no sequential grid axis, so where the TPU grid walks
// K as its innermost, "arbitrary" dimension with the accumulator in VMEM,
// each block here owns one output tile, keeps its accumulator in registers
// and loops over K itself, in 32-deep slices staged through shared memory.
// Ragged M, N and K are masked here: a load past an edge reads zero and a
// store past it never happens, which is exact for a GEMM and computes what
// the TPU path's zero-pad and slice computes
// (repro.kernels.ops.mfma_gemm(pad=True)), so no dimension has to be a
// multiple of anything.
//
// * bf16 / f16 operands run on the tensor cores.  When K and N are
//   multiples of 8 and a and b are 16-byte aligned (every 16-byte chunk of
//   a row is then wholly inside or wholly past an edge), mma_gemm_pipelined:
//   a 128 x 128 tile per block of 8 warps (2 x 4, each 64 x 32 as 4 x 4
//   m16n8 fragments, 64 f32 accumulators a thread), the slices copied
//   global -> shared by cp.async (zero-filled past an edge) through a ring
//   of 4 stages, so three slices are in flight while one is multiplied.
//   Otherwise mma_gemm_kernel: a 64 x 64 tile per block of 4 warps (2 x 2,
//   each 32 x 32), the slices loaded one element a thread into registers,
//   the next slice's loads issued before the current slice's products.  In both, slices are kept
//   row-major with rows padded (A to 40 elements, B to 72 or 136) so that
//   the eight 16-byte rows an ldmatrix phase reads fall in different
//   banks; ldmatrix.x4 loads the A fragments and ldmatrix.x4.trans the B
//   fragments, transposing them on the way.
// * f32 operands (CUDA cores): TF32 is off by convention in the port
//   (src/repro_torch/device.py), so f32 products are exact f32 FMAs: 256
//   threads, 4 x 4 outputs each, the A slice stored transposed.
//
// Bound (H100 SXM: 3.35 TB/s HBM3, 989 TFLOP/s dense bf16; bf16 a and b,
// f32 c and d; each operand read once, d written once):
//   256 x 256 x 256:           786,432 B, 33.6 MFLOP -> 0.23 us, bytes
//                              (a launch costs more: launch-bound)
//   decode, M 8, K 3584, N 18944 (qwen2-7b gate/up):
//                              137,060,352 B, 1.09 GFLOP -> 40.9 us, bytes
//   prefill, M 2048, K 3584, N 18944, and the down projection (K 18944,
//   N 3584):                   ~0.46 GB, 278 GFLOP -> 281 us, operations
// What the design does about it: at decode every weight element is read
// once from HBM in 16-byte chunks of coalesced rows, with three slices of
// cp.async copies in flight a block (at M = 8 a 128-row tile wastes most
// of each mma, which the bytes bound hides); at prefill the products run
// on the tensor cores at 16 x 8 x 16 per instruction, 16 of them per warp
// for every 6 ldmatrix.  mma.sync reaches a fraction of the rate that
// wgmma fed by TMA reaches on Hopper: that is later work.

#include <cstddef>
#include <cstdint>

#include "attention_common.cuh"  // to_f32 / from_f32 over the storage types
#include "mma_common.cuh"        // mma.sync, ldmatrix and cp.async

namespace {

using attn::from_f32;
using attn::to_f32;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::Mma;

constexpr int kBM = 64;  // output rows per block
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 32;  // contraction depth per shared-memory slice

// ---------------------------------------------------------------------------
// Tensor-core path for ragged or unaligned rows: bf16 / f16 operands.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2, each a 32 x 32 sub-tile
constexpr int kLdA = kBK + 8;     // A slice row: 40 elements (80 bytes)
constexpr int kLdB = kBN + 8;     // B slice row: 72 elements (144 bytes)

// Operands are moved as raw 16-bit patterns: zero bits are +0 in bf16 and
// f16 alike, and only the mma instruction reads them as numbers.
template <typename TA, typename TC>
__global__ void __launch_bounds__(kMmaThreads)
    mma_gemm_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                    const TC* __restrict__ c, TC* __restrict__ d, int M, int N, int K) {
  __shared__ __align__(16) uint16_t As[kBM][kLdA];  // As[row][k]
  __shared__ __align__(16) uint16_t Bs[kBK][kLdB];  // Bs[k][col]

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row (A, C) / column (B) within 8
  const int t = lane % 4;  // fragment column pair (A, C) / row pair (B)
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  // The accumulator fragments, seeded from C: register r of fragment
  // (mi, ni) holds row wm + 16 mi + g (+ 8 for r >= 2), column
  // wn + 8 ni + 2 t + (r & 1) of the tile.
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * mi + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * t + (r & 1);
        acc[mi][ni][r] = (row < M && col < N) ? to_f32(c[(size_t)row * N + col]) : 0.f;
      }

  // Each thread moves kLoads elements of each slice, element e = tid + j
  // kMmaThreads of the row-major slice (consecutive threads on consecutive
  // addresses of a row).
  constexpr int kLoads = kBM * kBK / kMmaThreads;
  static_assert(kBM * kBK == kBK * kBN, "the A and B slices have one size");
  uint16_t ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * kMmaThreads;
      const int ar = m0 + e / kBK, ak = k0 + e % kBK;
      ra[j] = (ar < M && ak < K) ? a[(size_t)ar * K + ak] : 0;
      const int bk = k0 + e / kBN, bc = n0 + e % kBN;
      rb[j] = (bk < K && bc < N) ? b[(size_t)bk * N + bc] : 0;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * kMmaThreads;
      As[e / kBK][e % kBK] = ra[j];
      Bs[e / kBN][e % kBN] = rb[j];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);  // in flight during the products

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[2][4], bf[4][2];
      // A: matrix q of x4 is rows 8 (q % 2), columns 8 (q / 2) of the
      // 16 x 16 fragment; lane l names row l % 16 at column 8 (l / 16).
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &As[wm + 16 * mi + lane % 16][ks + 8 * (lane / 16)]);
      // B, transposed on the way: matrix q of x4 is k rows 8 (q % 2) of
      // n8 tile ni + q / 2; lane l names k row l % 16 of tile ni + l / 16.
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[ks + lane % 16][wn + 8 * (ni + lane / 16)]);
        bf[ni][0] = r[0];
        bf[ni][1] = r[1];
        bf[ni + 1][0] = r[2];
        bf[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Mma<TA>::run(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * mi + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * t + (r & 1);
        if (row < M && col < N) d[(size_t)row * N + col] = from_f32<TC>(acc[mi][ni][r]);
      }
}

// ---------------------------------------------------------------------------
// Tensor-core path, pipelined: bf16 / f16 operands, K and N multiples of 8
// and a, b 16-byte aligned (every 16-byte chunk of a row is wholly inside
// or wholly past an edge).
// ---------------------------------------------------------------------------

constexpr int kPM = 128;          // output rows per block
constexpr int kPN = 128;          // output columns per block
constexpr int kPThreads = 256;    // 8 warps, 2 x 4, each a 64 x 32 sub-tile
constexpr int kStages = 4;        // slices in flight: 3 loading, 1 in use
constexpr int kPLdA = kBK + 8;    // A slice row: 40 elements (80 bytes)
constexpr int kPLdB = kPN + 8;    // B slice row: 136 elements (272 bytes)
constexpr int kStageA = kPM * kPLdA;
constexpr int kStageElems = kStageA + kBK * kPLdB;
constexpr size_t kPSmem = (size_t)kStages * kStageElems * sizeof(uint16_t);

template <typename TA, typename TC>
__global__ void __launch_bounds__(kPThreads)
    mma_gemm_pipelined(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                       const TC* __restrict__ c, TC* __restrict__ d, int M, int N, int K) {
  extern __shared__ __align__(16) uint16_t pipe_smem[];  // kStages x (A, B slices)

  const int m0 = blockIdx.y * kPM;
  const int n0 = blockIdx.x * kPN;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;

  // accumulator fragments as in mma_gemm_kernel, seeded from C
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * mi + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * t + (r & 1);
        acc[mi][ni][r] = (row < M && col < N) ? to_f32(c[(size_t)row * N + col]) : 0.f;
      }

  // One slice: the A tile (128 x 32) and the B tile (32 x 128) are 512
  // chunks of 16 bytes each, two of each per thread.
  auto load = [&](int stage, int k0) {
    uint16_t* As = pipe_smem + stage * kStageElems;
    uint16_t* Bs = As + kStageA;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kPThreads;
      const int ar = i / (kBK / 8), ak = (i % (kBK / 8)) * 8;
      const bool av = m0 + ar < M && k0 + ak < K;
      cp_async16(As + ar * kPLdA + ak, av ? a + (size_t)(m0 + ar) * K + k0 + ak : a, av);
      const int bk = i / (kPN / 8), bc = (i % (kPN / 8)) * 8;
      const bool bv = k0 + bk < K && n0 + bc < N;
      cp_async16(Bs + bk * kPLdB + bc, bv ? b + (size_t)(k0 + bk) * N + n0 + bc : b, bv);
    }
  };

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();  // one group per slice, empty past the end
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's part)
    __syncthreads();               // ... every thread's; slice kt - 1 is free
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    cp_async_commit();

    const uint16_t* As = pipe_smem + (kt % kStages) * kStageElems;
    const uint16_t* Bs = As + kStageA;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], As + (wm + 16 * mi + lane % 16) * kPLdA + ks + 8 * (lane / 16));
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (ks + lane % 16) * kPLdB + wn + 8 * (ni + lane / 16));
        bf[ni][0] = r[0];
        bf[ni][1] = r[1];
        bf[ni + 1][0] = r[2];
        bf[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Mma<TA>::run(acc[mi][ni], af[mi], bf[ni]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * mi + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * t + (r & 1);
        if (row < M && col < N) d[(size_t)row * N + col] = from_f32<TC>(acc[mi][ni][r]);
      }
}

// ---------------------------------------------------------------------------
// CUDA-core path: f32 operands, exact f32 FMAs.
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16 threads (ty, tx)
constexpr int kRows = kBM / 16;   // rows per thread: ty + 16 i
constexpr int kCols = kBN / 16;   // columns per thread: tx + 16 j

// V consecutive floats from p (16-byte aligned when V > 1).
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = *p;
  } else {
    static_assert(V == 4, "a vector load is 16 bytes");
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <typename TC, int V>
__global__ void __launch_bounds__(kFmaThreads)
    fma_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const TC* __restrict__ c, TC* __restrict__ d, int M, int N, int K) {
  __shared__ float As[kBK][kBM + 1];  // As[k][row]: the A slice, transposed
  __shared__ float Bs[kBK][kBN + 1];  // Bs[k][col]

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int row = m0 + ty + 16 * i;
      const int col = n0 + tx + 16 * j;
      acc[i][j] = (row < M && col < N) ? to_f32(c[(size_t)row * N + col]) : 0.f;
    }

  constexpr int kAVecs = kBM * kBK / V;
  constexpr int kBVecs = kBK * kBN / V;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kAVecs; i += kFmaThreads) {
      const int r = i / (kBK / V);
      const int k = (i % (kBK / V)) * V;
      float v[V] = {};
      if (m0 + r < M && k0 + k < K) load_f32<V>(a + (size_t)(m0 + r) * K + k0 + k, v);
#pragma unroll
      for (int j = 0; j < V; ++j) As[k + j][r] = v[j];
    }
    for (int i = tid; i < kBVecs; i += kFmaThreads) {
      const int k = i / (kBN / V);
      const int col = (i % (kBN / V)) * V;
      float v[V] = {};
      if (k0 + k < K && n0 + col < N) load_f32<V>(b + (size_t)(k0 + k) * N + n0 + col, v);
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[k][col + j] = v[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float x[kRows], y[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) x[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) y[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) d[(size_t)row * N + col] = from_f32<TC>(acc[i][j]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TA, typename TC>
int launch_mma(const void* a, const void* b, const void* c, void* d, int M, int N, int K,
               cudaStream_t stream) {
  const auto* ap = static_cast<const uint16_t*>(a);
  const auto* bp = static_cast<const uint16_t*>(b);
  const auto* cp = static_cast<const TC*>(c);
  auto* dp = static_cast<TC*>(d);
  if (aligned16(a) && aligned16(b) && K % 8 == 0 && N % 8 == 0) {
    const int e = attn::allow_smem(mma_gemm_pipelined<TA, TC>, kPSmem);
    if (e) return e;
    const dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
    mma_gemm_pipelined<TA, TC><<<grid, kPThreads, kPSmem, stream>>>(ap, bp, cp, dp, M, N, K);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    mma_gemm_kernel<TA, TC><<<grid, kMmaThreads, 0, stream>>>(ap, bp, cp, dp, M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename TC>
int launch_fma(const void* a, const void* b, const void* c, void* d, int M, int N, int K,
               cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* cp = static_cast<const TC*>(c);
  auto* dp = static_cast<TC*>(d);
  if (aligned16(a) && aligned16(b) && K % 4 == 0 && N % 4 == 0) {
    fma_gemm_kernel<TC, 4><<<grid, kFmaThreads, 0, stream>>>(ap, bp, cp, dp, M, N, K);
  } else {
    fma_gemm_kernel<TC, 1><<<grid, kFmaThreads, 0, stream>>>(ap, bp, cp, dp, M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename TC>
int launch_c(const void* a, const void* b, const void* c, void* d, int M, int N, int K,
             int ab_dtype, cudaStream_t stream) {
  switch (ab_dtype) {
    case 0:
      return launch_fma<TC>(a, b, c, d, M, N, K, stream);
    case 1:
      return launch_mma<__nv_bfloat16, TC>(a, b, c, d, M, N, K, stream);
    case 2:
      return launch_mma<__half, TC>(a, b, c, d, M, N, K, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; ab_dtype is a's and
// b's, c_dtype c's and d's.  Returns the launch's cudaError_t (0 on
// success); the kernel runs on `stream` and is not waited for.
extern "C" int mfma_gemm_launch(const void* a, const void* b, const void* c, void* d, int M,
                                int N, int K, int ab_dtype, int c_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case 0:
      return launch_c<float>(a, b, c, d, M, N, K, ab_dtype, st);
    case 1:
      return launch_c<__nv_bfloat16>(a, b, c, d, M, N, K, ab_dtype, st);
    case 2:
      return launch_c<__half>(a, b, c, d, M, N, K, ab_dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mfma_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
