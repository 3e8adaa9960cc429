// Chunked SSD (Mamba-2, state-space duality) scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mamba2_ssd
// (src/repro/kernels/mamba2_ssd.py: _ssd_kernel), which every SSM layer
// runs on a prefill: twice per layer in the serving path (ssm_train for
// the layer's output, _ssm_prefill_cache for the state it hands to decode).
//
// Operands (row-major, contiguous):
//   x      (B, S, nh, hd)   T: float, bfloat16 or half
//   dt     (B, S, nh)       f32, after softplus
//   A      (nh,)            f32, negative
//   Bm, Cm (B, S, G, ds)    T; head h reads group h / (nh / G)
//   y      (B, S, nh, hd)   T; rows >= S are never written
//   state  (B, nh, hd, ds)  f32, the state after row S - 1
//
// Design.  One block of 256 threads per (request, head, slice of 16 state
// rows along hd) walks the sequence in chunks of 64 rows (kQ; CHUNK in
// mamba2_ssd.py), carrying its (16, ds) slice of the f32 state in shared
// memory.  The rows of y and of the state along hd are independent once a
// chunk's scores are known, so slicing hd gives hd / 16 times the blocks
// (mamba2-370m: 32 heads x 4 slices = 128 blocks at B = 1) and changes no
// result; each slice recomputes the chunk's (64, 64) scores.  Per chunk:
//   1. the chunk's C and B rows (64, ds), x slice (64, 16) and dt (64) go
//      to shared memory as f32; rows past S read zero, and dt = 0 makes
//      them identity steps (no decay, no input), so they add nothing to y
//      or the state (the TPU path pads ragged S with the same steps);
//   2. cum = inclusive prefix sum of dt * A (two warp scans);
//   3. W[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i, else 0:
//      the decay is masked inside the exp, since anti-causal entries are
//      positive log-decays whose exp overflows;
//   4. y_i = sum_j W[i][j] x_j + (C_i . h) * exp(cum_i), stored in T;
//   5. h = exp(total) h + sum_j (x_j * exp(total - cum_j) * dt_j) B_j^T.
// Each thread keeps its sums in registers in f32.  Shared-memory rows are
// padded by one word so the column reads of C, B and the state do not
// collide in a bank.
//
// Numerics mirror _ssd_kernel: everything in f32, each chunk's y rounded
// once to T, the state kept in f32 throughout.  The chunk differs from the
// TPU planner's, which changes only the rounding: chunked SSD is exact at
// any chunk.
//
// Bound: bytes at the serving shapes.  A 2048-row prefill of mamba2-370m
// (32 heads of 64, ds 128, bf16) reads x, dt, B and C and writes y and the
// state once: 19.1 MB, 5.7 us at 3.35 TB/s.  Its products at this chunk,
// counting only causal (i, j) pairs and the scores once per group, are
// 2.4 GFLOP, 2.5 us at the 989 TFLOP/s of the bf16 tensor cores.  This
// first version is simple and right and runs on CUDA cores in f32 with one
// block per head slice walking the chunks in order; overlapping the chunk
// loads, computing chunk states in parallel before a short scan, and
// tensor-core products are later work.

#include <cstddef>

#include "attention_common.cuh"  // to_f32 / from_f32, allow_smem

namespace {

using attn::from_f32;
using attn::to_f32;

constexpr int kQ = 64;          // rows per chunk (CHUNK in mamba2_ssd.py)
constexpr int kHS = 16;         // state rows along hd per block
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLW = kQ + 1;     // padded row of the W tile

template <int DS>
constexpr size_t smem_floats() {
  return 2 * (size_t)kQ * (DS + 1)   // C and B rows of the chunk
         + (size_t)kQ * kHS          // x slice
         + (size_t)kQ * kLW          // W
         + (size_t)kHS * (DS + 1)    // state slice
         + 3 * (size_t)kQ;           // cum, dt, decay
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
               T* __restrict__ y, float* __restrict__ state, int S, int nh, int hd, int G) {
  constexpr int LD = DS + 1;                 // padded row of C, B and the state
  constexpr int kBC = kQ * DS / kThreads;    // C (and B) elements per thread per chunk
  constexpr int kX = kQ * kHS / kThreads;    // x elements per thread per chunk
  static_assert(kQ * DS % kThreads == 0 && kQ * kHS % kThreads == 0, "even loads");
  extern __shared__ float smem[];
  float* Cs = smem;                // [kQ][LD]
  float* Bs = Cs + kQ * LD;        // [kQ][LD]
  float* Xs = Bs + kQ * LD;        // [kQ][kHS]
  float* Ws = Xs + kQ * kHS;       // [kQ][kLW]
  float* Hs = Ws + kQ * kLW;       // [kHS][LD]
  float* cum = Hs + kHS * LD;      // [kQ]
  float* dts = cum + kQ;           // [kQ]
  float* dec = dts + kQ;           // [kQ]

  const int p0 = blockIdx.x * kHS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (nh / G);
  const int tid = threadIdx.x;
  const float a = A[h];

  const size_t x_row = (size_t)nh * hd;    // x and y: stride of one sequence row
  const size_t bc_row = (size_t)G * DS;    // B and C: stride of one sequence row
  const T* xb = x + (size_t)b * S * x_row + (size_t)h * hd + p0;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * hd + p0;
  const float* dtb = dt + (size_t)b * S * nh + h;
  const T* Bb = Bm + (size_t)b * S * bc_row + (size_t)g * DS;
  const T* Cb = Cm + (size_t)b * S * bc_row + (size_t)g * DS;

  for (int i = tid; i < kHS * LD; i += kThreads) Hs[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int n = min(kQ, S - t0);   // valid rows of this chunk

    // 1. loads: every load of the chunk issued before the first store
    {
      float cv[kBC], bv[kBC], xv[kX];
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int i = tid + k * kThreads;
        const int r = i / DS, s = i % DS;
        const size_t off = (size_t)(t0 + r) * bc_row + s;
        cv[k] = r < n ? to_f32(Cb[off]) : 0.f;
        bv[k] = r < n ? to_f32(Bb[off]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kX; ++k) {
        const int i = tid + k * kThreads;
        const int r = i / kHS, p = i % kHS;
        xv[k] = r < n ? to_f32(xb[(size_t)(t0 + r) * x_row + p]) : 0.f;
      }
      float d = 0.f;
      if (tid < n) d = dtb[(size_t)(t0 + tid) * nh];
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int i = tid + k * kThreads;
        Cs[(i / DS) * LD + i % DS] = cv[k];
        Bs[(i / DS) * LD + i % DS] = bv[k];
      }
#pragma unroll
      for (int k = 0; k < kX; ++k) Xs[tid + k * kThreads] = xv[k];

      // 2. cum: an inclusive scan of dt * A in each of warps 0 and 1
      if (tid < kQ) {
        float c = d * a;
        const int lane = tid & 31;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, c, o);
          if (lane >= o) c += v;
        }
        dts[tid] = d;
        cum[tid] = c;
      }
    }
    __syncthreads();
    if (tid >= 32 && tid < kQ) cum[tid] += cum[31];
    __syncthreads();
    const float total = cum[kQ - 1];
    if (tid < kQ) dec[tid] = expf(total - cum[tid]) * dts[tid];

    // 3. W = (C B^T) * L * dt; thread (ty, tx) owns rows ty + 16 i,
    //    columns tx + 16 j
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < DS; ++s) {
        float c[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * LD + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * LD + s];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c[i], bb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          Ws[row * kLW + col] =
              col <= row ? acc[i][j] * expf(cum[row] - cum[col]) * dts[col] : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y: thread (r0, p) owns rows r0 + 16 i of state column p0 + p
    {
      const int p = tid % kHS, r0 = tid / kHS;
#pragma unroll
      for (int i = 0; i < kQ / 16; ++i) {
        const int row = r0 + 16 * i;
        float yi = 0.f;
        for (int j = 0; j <= row; ++j) yi = fmaf(Ws[row * kLW + j], Xs[j * kHS + p], yi);
        float ye = 0.f;
#pragma unroll 8
        for (int s = 0; s < DS; ++s) ye = fmaf(Cs[row * LD + s], Hs[p * LD + s], ye);
        if (row < n) yb[(size_t)(t0 + row) * x_row + p] = from_f32<T>(yi + ye * expf(cum[row]));
      }
    }
    __syncthreads();   // every read of the old state is done

    // 5. state: thread (p, lane) owns state row p, columns lane + 16 k
    {
      const float et = expf(total);
      const int p = tid / 16;
      for (int s = tid % 16; s < DS; s += 16) {
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < kQ; ++j) acc = fmaf(Xs[j * kHS + p] * dec[j], Bs[j * LD + s], acc);
        Hs[p * LD + s] = et * Hs[p * LD + s] + acc;
      }
    }
    __syncthreads();   // before the next chunk overwrites C, B, x
  }

  float* sb = state + (((size_t)b * nh + h) * hd + p0) * DS;
  for (int i = tid; i < kHS * DS; i += kThreads) sb[i] = Hs[(i / DS) * LD + i % DS];
}

template <typename T, int DS>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* state, int B, int S, int nh, int hd, int G, cudaStream_t stream) {
  const size_t smem = smem_floats<DS>() * sizeof(float);
  const int e = attn::allow_smem(ssd_kernel<T, DS>, smem);
  if (e) return e;
  const dim3 grid(hd / kHS, nh, B);
  ssd_kernel<T, DS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), state, S, nh, hd, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ds(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
              void* y, float* state, int B, int S, int nh, int hd, int G, int ds,
              cudaStream_t stream) {
  switch (ds) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, state, B, S, nh, hd, G, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, state, B, S, nh, hd, G, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, state, B, S, nh, hd, G, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, state, B, S, nh, hd, G, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, Bm, Cm and y); ds 16,
// 32, 64 or 128; hd a multiple of 16; G divides nh.  Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream` and is not
// waited for.
extern "C" int mamba2_ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, void* y, void* state, int B, int S, int nh,
                                 int hd, int G, int ds, int dtype, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || G < 1 || nh % G || hd < kHS || hd % kHS || B > 65535 ||
      nh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  switch (dtype) {
    case 0:
      return launch_ds<float>(x, dtf, Af, Bm, Cm, y, sf, B, S, nh, hd, G, ds, st);
    case 1:
      return launch_ds<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, B, S, nh, hd, G, ds, st);
    case 2:
      return launch_ds<__half>(x, dtf, Af, Bm, Cm, y, sf, B, S, nh, hd, G, ds, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
