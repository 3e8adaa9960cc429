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
// Numerics mirror _gmm_kernel: products and sums in f32
// (preferred_element_type=float32), one rounding to x's dtype at the store.
// Ragged C, K and N are masked here: a load past an edge reads zero and a
// store past it never happens, which is exact for a GEMM and computes what
// the TPU path's zero-pad and slice computes.
//
// Bound: bytes at the decode shapes.  A decode step of qwen3-moe
// (E = 128, C = 32 slots, K = 4096, N = 1536) moves 1.66 GB, almost all of
// it w, for 51.5 GFLOP: 31 flops per byte, far below the ~295 where an
// H100's bf16 tensor cores take over from memory, so its bound is the
// weight read (0.49 ms at 3.35 TB/s).  A 2000-row prefill (C = 160) does
// 5x the flops on the same bytes, still bound by them (0.53 ms against
// 0.26 ms of tensor-core time).  So the kernel has to keep every SM's
// share of w streaming, and no product may cost more than its bytes.
//
// Design.
// * bf16 / f16 with K and N multiples of 8 and x, w 16-byte aligned (every
//   16-byte chunk of a row is then wholly inside or wholly past an edge):
//   gmm_ring_kernel, on the tensor cores (mma.sync.m16n8k16, f32
//   accumulator fragments).  A block computes BM slot rows by 128 output
//   columns of one expert, BM the smallest of 16, 32, 64 and 128 that
//   covers C (128 above that): C = 4 (jamba's B = 1 decode) takes one m16
//   tile, C = 32 (qwen3-moe's decode) two, so no block multiplies a tile
//   of empty rows.  128 columns, not 64, so that x, which every column
//   tile of an expert reads again (from L2), is read N / 128 times and not
//   twice that, and each w slice row is a 256-byte run.  4 warps (8 at
//   BM = 128, 2 x 4) each own BM (64) rows by 32 columns.  The grid is
//   (N / 128, ceil(C / BM), E), so consecutive blocks share an expert's x.
//   w and x stream through a 4-stage cp.async ring of 32-deep slices (8 KB
//   of w a slice): three slices are in flight while one is multiplied, and
//   with 4-5 blocks an SM that is ~100 KB an SM in flight, past what 3.35
//   TB/s needs at the HBM's latency.  ldmatrix.x4 loads x's A fragments
//   and ldmatrix.x4.trans w's B fragments from rows padded to 40 and 136
//   elements, so an ldmatrix phase's eight rows fall in different banks.
//   Each k-step's 16 products are summed on the tensor cores from zero
//   and carried into the f32 accumulator by an f32 add, in k order, so
//   the sum over K rounds to nearest as an f32 sum does (an mma
//   accumulating all of K would round toward zero at every step); this is
//   as close as the tensor cores come to the f32 sum in k order that the
//   plain version's f32 GEMM takes.
// * Everything else (f32 operands; 16-bit operands that are unaligned or
//   whose K or N is not a multiple of 8): gmm_kernel, on CUDA cores in f32
//   (TF32 is off in the port): one block of 256 threads per (expert, 64
//   rows, 64 columns), K streamed through shared memory in slices of 32
//   as f32 (the x slice transposed, rows padded by one word), 4 x 4
//   outputs a thread; 16-byte loads for f32 when K, N are multiples of 4
//   and the operands aligned, one element a thread otherwise.
// The choice is made by dtype, alignment and shape, never on failure.

#include <cstddef>
#include <cstdint>

#include "attention_common.cuh"  // to_f32 / from_f32, allow_smem
#include "mma_common.cuh"        // mma.sync, ldmatrix, cp.async, pack2

namespace {

using attn::from_f32;
using attn::to_f32;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::Mma;
using mma::pack2;

// ---------------------------------------------------------------------------
// CUDA cores: f32, and 16-bit operands the ring does not take.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Tensor cores: bf16 / f16, K and N multiples of 8, x and w 16-byte aligned.
// ---------------------------------------------------------------------------

constexpr int kRN = 128;         // output columns per block
constexpr int kRK = 32;          // contraction depth per slice
constexpr int kStages = 4;       // slices in flight: 3 loading, 1 in use
constexpr int kLdX = kRK + 8;    // x slice row: 40 elements (80 bytes)
constexpr int kLdW = kRN + 8;    // w slice row: 136 elements (272 bytes)

template <int BM>
struct Ring {
  static constexpr int kWarpsM = BM >= 128 ? 2 : 1;   // warps along the rows
  static constexpr int kThreads = 32 * 4 * kWarpsM;   // 4 warps along the columns
  static constexpr int kMI = BM / kWarpsM / 16;       // m16 tiles of a warp
  // blocks an SM must hold at 128 registers a thread (2 at BM = 128, 4
  // below): one register more would cost a block an SM
  static constexpr int kMinBlocks = 65536 / (kThreads * 128);
  static constexpr int kStageElems = BM * kLdX + kRK * kLdW;
  static constexpr size_t kSmem = (size_t)kStages * kStageElems * sizeof(uint16_t);
};

// Operands are moved as raw 16-bit patterns: zero bits are +0 in bf16 and
// f16 alike, and only the mma instruction reads them as numbers.
template <typename T, int BM>
__global__ void __launch_bounds__(Ring<BM>::kThreads, Ring<BM>::kMinBlocks)
    gmm_ring_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                    T* __restrict__ out, int C, int K, int N) {
  using S = Ring<BM>;
  extern __shared__ __align__(16) uint16_t ring[];   // kStages x (x slice, w slice)

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kRN;
  const uint16_t* xe = x + (size_t)e * C * K;
  const uint16_t* we = w + (size_t)e * K * N;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 4) * (BM / S::kWarpsM);
  const int wn = (warp % 4) * 32;

  // register r of fragment (mi, ni) holds row wm + 16 mi + g (+ 8 for
  // r >= 2), column wn + 8 ni + 2 t + (r & 1) of the tile
  float acc[S::kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // one slice: x (BM x 32) and w (32 x 128) in 16-byte chunks, zero-filled
  // past C, K and N
  auto load = [&](int stage, int k0) {
    uint16_t* xs = ring + stage * S::kStageElems;
    uint16_t* ws = xs + BM * kLdX;
    for (int i = tid; i < BM * (kRK / 8); i += S::kThreads) {
      const int r = i / (kRK / 8), c = (i % (kRK / 8)) * 8;
      const bool ok = m0 + r < C && k0 + c < K;
      cp_async16(xs + r * kLdX + c, ok ? xe + (size_t)(m0 + r) * K + k0 + c : xe, ok);
    }
    for (int i = tid; i < kRK * (kRN / 8); i += S::kThreads) {
      const int r = i / (kRN / 8), c = (i % (kRN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(ws + r * kLdW + c, ok ? we + (size_t)(k0 + r) * N + n0 + c : we, ok);
    }
  };

  const int nk = (K + kRK - 1) / kRK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kRK);
    cp_async_commit();   // one group per slice, empty past the end
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // slice kt has landed (this thread's part)
    __syncthreads();                // ... every thread's; slice kt - 1 is free
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kRK);
    cp_async_commit();

    const uint16_t* xs = ring + (kt % kStages) * S::kStageElems;
    const uint16_t* ws = xs + BM * kLdX;
#pragma unroll
    for (int ks = 0; ks < kRK; ks += 16) {
      uint32_t af[S::kMI][4], bf[4][2];
      // A: lane l names row l % 16 of the m16 tile at column 8 (l / 16)
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi)
        ldmatrix_x4(af[mi], xs + (wm + 16 * mi + lane % 16) * kLdX + ks + 8 * (lane / 16));
      // B, transposed on the way: lane l names k row l % 16 of n8 tile
      // ni + l / 16
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + (ks + lane % 16) * kLdW + wn + 8 * (ni + lane / 16));
        bf[ni][0] = r[0];
        bf[ni][1] = r[1];
        bf[ni + 1][0] = r[2];
        bf[ni + 1][1] = r[3];
      }
      // The k-step's 16 products are summed on the tensor cores from
      // zero, and an f32 add (round to nearest) carries the partial sum
      // into the accumulator, k-step by k-step in order.  An mma that
      // accumulated all of K would round its sum toward zero at every
      // step, a bias that grows with K and moves the output's bf16
      // roundings off those of an f32 sum.
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          Mma<T>::run(part, af[mi], bf[ni]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[r];
        }
    }
  }

  // N is even and the column pair starts even: a pair is wholly inside or
  // wholly past N, and 4-byte aligned
  T* oe = out + (size_t)e * C * N;
#pragma unroll
  for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mi + g + 8 * h;
        const int col = n0 + wn + 8 * ni + 2 * t;
        if (row < C && col < N)
          *reinterpret_cast<uint32_t*>(oe + (size_t)row * N + col) =
              pack2<T>(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

template <typename T, int BM>
int launch_ring(const void* x, const void* w, void* out, int E, int C, int K, int N,
                cudaStream_t stream) {
  using S = Ring<BM>;
  const int e = attn::allow_smem(gmm_ring_kernel<T, BM>, S::kSmem);
  if (e) return e;
  const dim3 grid((N + kRN - 1) / kRN, (C + BM - 1) / BM, E);
  gmm_ring_kernel<T, BM><<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), static_cast<T*>(out),
      C, K, N);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int K, int N,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);   // elements in 16 bytes
  const bool vec = aligned16(x) && aligned16(w) && K % V == 0 && N % V == 0;
  if constexpr (V == 8) {             // bf16 / f16: the ring, its row tile sized to C
    if (vec) {
      if (C <= 16) return launch_ring<T, 16>(x, w, out, E, C, K, N, stream);
      if (C <= 32) return launch_ring<T, 32>(x, w, out, E, C, K, N, stream);
      if (C <= 64) return launch_ring<T, 64>(x, w, out, E, C, K, N, stream);
      return launch_ring<T, 128>(x, w, out, E, C, K, N, stream);
    }
  }
  const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if constexpr (V == 4) {             // f32: 16-byte loads where they fit
    if (vec) {
      gmm_kernel<T, V><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, K, N);
      return (int)cudaGetLastError();
    }
  }
  gmm_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, K, N);
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
