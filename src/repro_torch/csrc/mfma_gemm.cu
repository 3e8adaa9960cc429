// The MFMA contract at GEMM scale on Hopper (sm_90a): D = C + A @ B.
//
// Replaces the Pallas TPU kernel mfma_gemm (src/repro/kernels/mfma_gemm.py:
// _gemm_kernel), the paper's Matrix Core Engine contract tiled for the
// TPU's MXU.  Its counterpart of the MCE here is the tensor core, driven by
// wgmma (a warpgroup's 64 x 256 x 16 product from shared memory) at
// prefill shapes and by mma.sync (one warp's 16 x 8 x 16) at decode.
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
// and loops over K itself, in 64-deep slices staged through shared memory.
// Ragged M, N and K are masked: a load past an edge reads zero and a store
// past it never happens, which is exact for a GEMM and computes what the
// TPU path's zero-pad and slice computes (repro.kernels.ops.mfma_gemm(
// pad=True)), so no dimension has to be a multiple of anything.
//
// * bf16 / f16 operands, K and N multiples of 8, a and b 16-byte aligned
//   (every 16-byte chunk of a row then lies wholly inside or past an edge):
//   - M > 64, wgmma_gemm_kernel: a 128 x 256 output tile per block of 3
//     warpgroups.  One thread of the first starts TMA loads of 64-deep
//     slices (A 128 x 64, B as four 64 x 64 boxes; a box past an edge is
//     zero-filled, a box wholly past N is skipped) into a ring of 4 stages,
//     each with a full and an empty mbarrier; the two others (setmaxnreg
//     gives them the producer's registers) each run wgmma m64n256k16 on 64
//     rows, 4 per slice, accumulators seeded from C; the products of one
//     slice stay in flight while the stage of the last goes back to the
//     producer.  C and D move in pairs of a row's neighbours (one 8-byte
//     f32 or 4-byte 16-bit access) when aligned for it.  Blocks walk M
//     first, so the blocks in flight share a few column tiles of b and
//     the large operand is read from HBM about once.
//   - M <= 64, mma_gemm_decode: wgmma's 64-row minimum would waste most of
//     each product, and the shape is bound by the bytes of b.  A block of 4
//     warps owns all M rows (16, 32 or 64) and 64 columns and streams b
//     through a 4-stage cp.async ring of 64-deep slices (8 KB of b each,
//     rows of 128 bytes), mma.sync on the fragments.  When the column tiles
//     are fewer than two blocks per SM the wrapper asks for a split over K:
//     each split adds its products into an f32 partial, and the last block
//     of a column tile (an atomic ticket the kernel resets) adds C and the
//     partials in split order in f32 and rounds once.
// * bf16 / f16 operands otherwise, mma_gemm_kernel: a 64 x 64 tile per
//   block of 4 warps (2 x 2, each 32 x 32), 32-deep slices loaded one
//   element a thread into registers, the next slice's loads started before
//   the current slice's products, rows padded so that the eight 16-byte
//   rows an ldmatrix phase reads fall in different banks.
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
// What the design does about it: at prefill the products run at the
// tensor cores' own granularity (wgmma from shared memory, no ldmatrix,
// one wait per 64 of K) with TMA keeping three slices in flight without
// spending a consumer instruction on a copy; at decode every weight
// element is read once from HBM in rows of 128 bytes, each block keeping
// 24 KB of b in flight (qwen2-7b's gate/up at decode: 296 column tiles
// in 3 splits over K, six blocks an SM).

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"  // to_f32 / from_f32 over the storage types
#include "mma_common.cuh"        // mma.sync, ldmatrix and cp.async
#include "wgmma_common.cuh"      // TMA, mbarriers and wgmma

namespace {

using attn::from_f32;
using attn::to_f32;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::Mma;

constexpr int kBM = 64;  // output rows per block (element-load and f32 kernels)
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
// Decode path (M <= 64): bf16 / f16 operands on mma.sync, K and N
// multiples of 8, a and b 16-byte aligned.
// ---------------------------------------------------------------------------

constexpr int kDN = 64;           // output columns per block
constexpr int kDK = 64;           // contraction depth per slice
constexpr int kDStages = 4;       // slices in flight: 3 loading, 1 in use
constexpr int kDThreads = 128;    // 4 warps, each 16 columns of all M rows
constexpr int kDLd = kDK + 8;     // A slice row: 72 elements (144 bytes)
constexpr int kDLdB = kDN + 8;    // B slice row: 72 elements

// One stage of the ring (A slice, then B slice) and the ring, for MT row
// fragments.
template <int MT>
struct DecodeRing {
  static constexpr int kStageA = 16 * MT * kDLd;
  static constexpr int kStage = kStageA + kDK * kDLdB;
  static constexpr size_t kBytes = (size_t)kDStages * kStage * sizeof(uint16_t);
};

// MT m16 fragments hold rows 0 .. 16 MT - 1 (rows >= M read zero).  Block
// (x, y) computes columns 64 x .. and K slices [y per_split, (y + 1)
// per_split); with one split it seeds from C and writes D, else it writes
// its f32 partial to part + y M N and the last block of the column tile
// writes D = C + the partials.
template <typename TA, typename TC, int MT>
__global__ void __launch_bounds__(kDThreads)
    mma_gemm_decode(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                    const TC* __restrict__ c, TC* __restrict__ d, int M, int N, int K,
                    int per_split, float* __restrict__ part, int* __restrict__ tickets) {
  extern __shared__ __align__(16) uint16_t dec_smem[];
  constexpr int kStage = DecodeRing<MT>::kStage;
  constexpr int kStageA = DecodeRing<MT>::kStageA;

  const int n0 = blockIdx.x * kDN;
  const int nsplit = gridDim.y;
  const int nk = (K + kDK - 1) / kDK;
  const int kt0 = blockIdx.y * per_split;
  const int kt1 = min(nk, kt0 + per_split);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wn = warp * 16;

  // accumulator fragments (mi, ni): register r holds row 16 mi + g (+ 8
  // for r >= 2), column n0 + wn + 8 ni + 2 t + (r & 1)
  float acc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * mi + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * t + (r & 1);
        acc[mi][ni][r] =
            (nsplit == 1 && row < M && col < N) ? to_f32(c[(size_t)row * N + col]) : 0.f;
      }

  auto load = [&](int stage, int k0) {
    uint16_t* As = dec_smem + stage * kStage;
    uint16_t* Bs = As + kStageA;
    for (int i = tid; i < 16 * MT * (kDK / 8); i += kDThreads) {
      const int r = i / (kDK / 8), kc = (i % (kDK / 8)) * 8;
      const bool v = r < M && k0 + kc < K;
      cp_async16(As + r * kDLd + kc, v ? a + (size_t)r * K + k0 + kc : a, v);
    }
#pragma unroll
    for (int j = 0; j < kDK * (kDN / 8) / kDThreads; ++j) {
      const int i = tid + j * kDThreads;
      const int kr = i / (kDN / 8), nc = (i % (kDN / 8)) * 8;
      const bool v = k0 + kr < K && n0 + nc < N;
      cp_async16(Bs + kr * kDLdB + nc, v ? b + (size_t)(k0 + kr) * N + n0 + nc : b, v);
    }
  };

#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (kt0 + s < kt1) load(s, (kt0 + s) * kDK);
    cp_async_commit();  // one group per slice, empty past the end
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<kDStages - 2>();  // slice i has landed (this thread's part)
    __syncthreads();                // ... every thread's; slice i - 1 is free
    if (kt + kDStages - 1 < kt1) load((i + kDStages - 1) % kDStages, (kt + kDStages - 1) * kDK);
    cp_async_commit();

    const uint16_t* As = dec_smem + (i % kDStages) * kStage;
    const uint16_t* Bs = As + kStageA;
#pragma unroll
    for (int ks = 0; ks < kDK; ks += 16) {
      uint32_t af[MT][4], bf[2][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(af[mi], As + (16 * mi + lane % 16) * kDLd + ks + 8 * (lane / 16));
      {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (ks + lane % 16) * kDLdB + wn + 8 * (lane / 16));
        bf[0][0] = r[0];
        bf[0][1] = r[1];
        bf[1][0] = r[2];
        bf[1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) Mma<TA>::run(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  float* mine = nsplit == 1 ? nullptr : part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * mi + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * t + (r & 1);
        if (row >= M || col >= N) continue;
        if (mine == nullptr)
          d[(size_t)row * N + col] = from_f32<TC>(acc[mi][ni][r]);
        else
          mine[(size_t)row * N + col] = acc[mi][ni][r];
      }
  if (mine == nullptr) return;

  // the last split of this column tile to finish adds C and the partials
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[blockIdx.x], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < M * kDN; i += kDThreads) {
    const int row = i / kDN, col = n0 + i % kDN;
    if (col >= N) continue;
    const size_t o = (size_t)row * N + col;
    float s = to_f32(c[o]);
    for (int sp = 0; sp < nsplit; ++sp) s += __ldcg(part + (size_t)sp * M * N + o);
    d[o] = from_f32<TC>(s);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

// ---------------------------------------------------------------------------
// Prefill path (M > 64): bf16 / f16 operands on wgmma fed by TMA, K and N
// multiples of 8, a and b 16-byte aligned.
// ---------------------------------------------------------------------------

constexpr int kWM = 128;                        // output rows per block
constexpr int kWN = 256;                        // output columns per block
constexpr int kWK = 64;                         // contraction depth per slice
constexpr int kWStages = 4;                     // ring of slices
constexpr int kWThreads = 384;                  // producer + 2 consumer warpgroups
constexpr uint32_t kWABytes = kWM * kWK * 2;    // A slice: 16 KB
constexpr uint32_t kWBoxBytes = kWK * 64 * 2;   // one 64-column box of B: 8 KB
constexpr uint32_t kWStageBytes = kWABytes + 4 * kWBoxBytes;
constexpr size_t kWSmem = (size_t)kWStages * kWStageBytes + 1024;  // + alignment

// Two neighbouring elements of a row of C or D as an f32 pair, in one
// access (p aligned to the pair).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack2<T>(lo, hi);
}

template <typename TA, typename TC>
__global__ void __launch_bounds__(kWThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b, const TC* __restrict__ c,
                      TC* __restrict__ d, int M, int N, int K, bool pairs) {
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[kWStages];
  __shared__ __align__(8) uint64_t empty[kWStages];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = wgmma::smem_u32(wg_smem_raw);
  uint8_t* ring = wg_smem_raw + ((1024 - raw % 1024) % 1024);

  const int m0 = blockIdx.x * kWM;
  const int n0 = blockIdx.y * kWN;
  const int nk = (K + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    wgmma::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    wgmma::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int boxes = min(4, (N - n0 + 63) / 64);  // B boxes with a column < N
      const uint32_t bytes = kWABytes + boxes * kWBoxBytes;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kWStages;
        if (kt >= kWStages) wgmma::mbar_wait(&empty[s], (kt / kWStages - 1) & 1);
        uint8_t* As = ring + s * kWStageBytes;
        uint8_t* Bs = As + kWABytes;
        wgmma::mbar_expect_tx(&full[s], bytes);
        wgmma::tma_load_2d(As, &tma_a, &full[s], kt * kWK, m0);
        for (int j = 0; j < boxes; ++j)
          wgmma::tma_load_2d(Bs + j * kWBoxBytes, &tma_b, &full[s], n0 + 64 * j, kt * kWK);
      }
    }
    return;
  }

  wgmma::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this consumer's rows: 64 cw .. 64 cw + 63 of the tile
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = m0 + 64 * cw + 16 * warp + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);

  // register 4 j + r: row row0 + 8 (r >= 2), column col0 + 8 j + (r & 1);
  // registers 2 q and 2 q + 1 are neighbours in a row (N is even here), so
  // with `pairs` (c and d aligned to two elements) each pair of C and D
  // moves in one access
  float acc[128];
#pragma unroll
  for (int q = 0; q < 64; ++q) {
    const int row = row0 + (q % 2 ? 8 : 0);
    const int col = col0 + 8 * (q / 2);
    const TC* src = c + (size_t)row * N + col;
    float2 v = make_float2(0.f, 0.f);
    if (row < M && col < N) v = pairs ? load_pair(src) : make_float2(to_f32(src[0]), to_f32(src[1]));
    acc[2 * q] = v.x;
    acc[2 * q + 1] = v.y;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kWStages;
    wgmma::mbar_wait(&full[s], (kt / kWStages) & 1);
    const uint8_t* As = ring + s * kWStageBytes + cw * 64 * 128;
    const uint8_t* Bs = ring + s * kWStageBytes + kWABytes;
    wgmma::fence_operands(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      // A: 16 of K is 32 bytes along a swizzled row; B: 16 rows of 128 bytes
      const uint64_t da = wgmma::desc_sw128(As + 32 * kk, 16, 1024);
      const uint64_t db = wgmma::desc_sw128(Bs + 2048 * kk, kWBoxBytes, 1024);
      wgmma::Wgmma256<TA>::run(acc, da, db);
    }
    wgmma::commit();
    // keep this slice's products in flight; the last slice's are done, so
    // its stage goes back to the producer
    wgmma::wait<1>();
    wgmma::fence_operands(acc);
    if (kt > 0 && tid == 0) wgmma::mbar_arrive(&empty[(kt - 1) % kWStages]);
  }
  wgmma::wait<0>();
  wgmma::fence_operands(acc);

#pragma unroll
  for (int q = 0; q < 64; ++q) {
    const int row = row0 + (q % 2 ? 8 : 0);
    const int col = col0 + 8 * (q / 2);
    if (row >= M || col >= N) continue;
    TC* dst = d + (size_t)row * N + col;
    if (pairs) {
      store_pair(dst, acc[2 * q], acc[2 * q + 1]);
    } else {
      dst[0] = from_f32<TC>(acc[2 * q]);
      dst[1] = from_f32<TC>(acc[2 * q + 1]);
    }
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

template <typename TA, typename TC, int MT>
int launch_decode(const uint16_t* a, const uint16_t* b, const TC* c, TC* d, int M, int N, int K,
                  int splits, float* part, int* tickets, cudaStream_t stream) {
  constexpr size_t smem = DecodeRing<MT>::kBytes;
  const int e = attn::allow_smem(mma_gemm_decode<TA, TC, MT>, smem);
  if (e) return e;
  const int nk = (K + kDK - 1) / kDK;
  const int per_split = (nk + splits - 1) / splits;
  const dim3 grid((N + kDN - 1) / kDN, (nk + per_split - 1) / per_split);
  if (grid.y > 1 && (part == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  mma_gemm_decode<TA, TC, MT><<<grid, kDThreads, smem, stream>>>(a, b, c, d, M, N, K, per_split,
                                                                 part, tickets);
  return (int)cudaGetLastError();
}

template <typename TA, typename TC>
int launch_wgmma(const void* a, const void* b, const TC* c, TC* d, int M, int N, int K,
                 cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<TA, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b;
  int e = wgmma::encode_tiled_2d(&map_a, a, type, M, K, kWM, kWK);
  if (!e) e = wgmma::encode_tiled_2d(&map_b, b, type, K, N, kWK, 64);
  if (!e) e = attn::allow_smem(wgmma_gemm_kernel<TA, TC>, kWSmem);
  if (e) return e;
  const dim3 grid((M + kWM - 1) / kWM, (N + kWN - 1) / kWN);
  const bool pairs = reinterpret_cast<uintptr_t>(c) % (2 * sizeof(TC)) == 0 &&
                     reinterpret_cast<uintptr_t>(d) % (2 * sizeof(TC)) == 0;
  wgmma_gemm_kernel<TA, TC>
      <<<grid, kWThreads, kWSmem, stream>>>(map_a, map_b, c, d, M, N, K, pairs);
  return (int)cudaGetLastError();
}

template <typename TA, typename TC>
int launch_mma(const void* a, const void* b, const void* c, void* d, int M, int N, int K,
               int splits, float* part, int* tickets, cudaStream_t stream) {
  const auto* ap = static_cast<const uint16_t*>(a);
  const auto* bp = static_cast<const uint16_t*>(b);
  const auto* cp = static_cast<const TC*>(c);
  auto* dp = static_cast<TC*>(d);
  if (aligned16(a) && aligned16(b) && K % 8 == 0 && N % 8 == 0) {
    if (M <= 16)
      return launch_decode<TA, TC, 1>(ap, bp, cp, dp, M, N, K, splits, part, tickets, stream);
    if (M <= 32)
      return launch_decode<TA, TC, 2>(ap, bp, cp, dp, M, N, K, splits, part, tickets, stream);
    if (M <= 64)
      return launch_decode<TA, TC, 4>(ap, bp, cp, dp, M, N, K, splits, part, tickets, stream);
    return launch_wgmma<TA, TC>(a, b, cp, dp, M, N, K, stream);
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mma_gemm_kernel<TA, TC><<<grid, kMmaThreads, 0, stream>>>(ap, bp, cp, dp, M, N, K);
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
             int ab_dtype, int splits, float* part, int* tickets, cudaStream_t stream) {
  switch (ab_dtype) {
    case 0:
      return launch_fma<TC>(a, b, c, d, M, N, K, stream);
    case 1:
      return launch_mma<__nv_bfloat16, TC>(a, b, c, d, M, N, K, splits, part, tickets, stream);
    case 2:
      return launch_mma<__half, TC>(a, b, c, d, M, N, K, splits, part, tickets, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; ab_dtype is a's and
// b's, c_dtype c's and d's.  splits: the split over K the decode path may
// take (1: none); part (splits x M x N f32) and tickets (ceil(N / 64)
// int32, zero, and zero again after every launch) are its scratch, which
// a launch of splits > 1 on the decode path needs.  Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream` and is not
// waited for.
extern "C" int mfma_gemm_launch(const void* a, const void* b, const void* c, void* d, int M,
                                int N, int K, int ab_dtype, int c_dtype, int splits, void* part,
                                void* tickets, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  switch (c_dtype) {
    case 0:
      return launch_c<float>(a, b, c, d, M, N, K, ab_dtype, splits, pf, tk, st);
    case 1:
      return launch_c<__nv_bfloat16>(a, b, c, d, M, N, K, ab_dtype, splits, pf, tk, st);
    case 2:
      return launch_c<__half>(a, b, c, d, M, N, K, ab_dtype, splits, pf, tk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mfma_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
