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
//   scratch                 f32: the scores (B, G, nc, kQ, kQ), the chunk
//                           states (B, nh, nc, hd, ds) and the chunk totals
//                           (B, nh, nc), nc = ceil(S / kQ)
//
// Design.  The TPU kernel walks the chunks of a (request, head) in order
// on its sequential grid axis, the state carried in VMEM.  Here the chunks
// run in parallel, in the SSD algorithm's own form: three kernels on the
// caller's stream, one wrapper call (one count).  Chunks are kQ = 128 rows
// (CHUNK in mamba2_ssd.py): a mamba2 prefill's chunk states then take
// 16.8 MB, which stay in the 50 MB L2 between the kernels that write and
// read them (at 64 rows, 33.5 MB, twice the traffic).  Rows past S read
// zero, and dt = 0 makes them identity steps (no decay, no input), so
// they add nothing to y or the state (the TPU path pads with such steps).
//   1. ssd_chunk_kernel, two kinds of block in one grid:
//      (a) per (request, group, chunk, 64 x 64 tile of the lower triangle):
//          the scores C_i . B_j, once per group (all heads of the group
//          read them), into scratch;
//      (b) per (request, head, chunk, 64 columns of hd): cum = the
//          inclusive scan of dt * A, and the chunk's state from zero,
//          sum_j (x_j * exp(total - cum_j) * dt_j) B_j^T, into scratch.
//   2. ssd_scan_kernel, one thread per state element of a (request,
//      head): h_c = exp(total_c) h_{c-1} + local_c over the chunks in
//      order; each chunk's slot is overwritten with the state it starts
//      from, and the last is the state output.
//   3. ssd_output_kernel, per (request, head, chunk, 64 columns of hd), a
//      warp per 16 rows (the whole chunk where ds >= 64, so its state is
//      read once; else 64-row blocks, which keep more warps in flight):
//      y = W x + (C h^T) * exp(cum), W = scores * exp(cum_i - cum_j) * dt_j
//      for j <= i, else 0 (the decay masked inside the exp: anti-causal
//      entries are positive log-decays whose exp overflows).
// bf16 / f16: the products run on the tensor cores (mma.sync m16n8k16,
// f32 accumulators).  C.B^T and C.h^T's C are exact in T; the f32
// operands (x * decay, W and h) reach them as a high and a low half in T
// (split2 in mma_common.cuh, within 2^-16), each product taken twice,
// each split where its fragment is built (W from score fragments read
// from global memory two steps ahead, h and x from shared memory).
// f32: the same passes with exact f32 FMAs on CUDA cores (TF32 stays off).
// Tiles reach shared memory by cp.async, all in flight at once.
//
// Numerics mirror _ssd_kernel: every sum in f32, the state f32 throughout,
// each y rounded once to T.  The chunk differs from the TPU planner's,
// which changes only the rounding: chunked SSD is exact at any chunk.
//
// Bound: bytes at the serving shapes.  A 2048-row prefill of mamba2-370m
// (32 heads of 64, ds 128, bf16) reads x, dt, B and C and writes y and the
// state once: 19.1 MB, 5.7 us at 3.35 TB/s.  Its products at this chunk,
// counting only causal (i, j) pairs and the scores once per group, are
// ~2.7 GFLOP, 2.8 us at 989 TFLOP/s.  What the design does about it: all
// chunks of all heads in flight at once (mamba2: 512 + 48 blocks, then
// 512), the scores formed once per group instead of once per head and
// column slice, the products on the tensor cores, the chunk states kept
// to what L2 holds.  What it costs beyond the bound: x is read twice
// (passes b and d) and the chunk states go through L2 three times, and a
// block's loads, scan of cum and products run in turn.  Leaving each part
// out on the card (PERF.md, Findings): no part of the output kernel takes
// more than 27% of it; the chunk kernel's loads of x take a third
// (mamba2) to a half (jamba) of it.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"  // to_f32 / from_f32, allow_smem
#include "mma_common.cuh"        // mma.sync, ldmatrix, split2

namespace {

using attn::from_f32;
using attn::to_f32;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::Mma;
using mma::split2;

constexpr int kQ = 128;             // rows per chunk (CHUNK in mamba2_ssd.py)
constexpr int kR = 64;              // rows of a score or output tile
constexpr int kRT = kQ / kR;        // row tiles per chunk
constexpr int kTiles = kRT * (kRT + 1) / 2;  // score tiles of a chunk's lower triangle
constexpr int kP = 64;              // columns of hd per block
constexpr int kThreads = 128;       // ssd_chunk_kernel: 4 warps
constexpr int kScanThreads = 256;
static_assert(kThreads == kQ, "one thread a chunk row scans cum");

// ssd_output_kernel's threads, a warp per 16 rows: where the state (ds
// columns) is wide, 8 warps own a whole chunk and read its state once;
// else 4 warps own 64 rows, and more, smaller blocks keep more warps in
// flight
__host__ __device__ constexpr int out_threads(int ds) { return ds >= 64 ? 256 : 128; }

template <typename T>
constexpr bool kTensor = !std::is_same<T, float>::value;

__device__ __forceinline__ const uint16_t* u16(const void* p) {
  return static_cast<const uint16_t*>(p);
}

// Rows [0, rows) x columns [0, cols) of a row-major tile at src (row stride
// `stride` elements) into dst (row stride LD): rows >= n and columns >=
// valid_cols read zero.  cols and valid_cols are multiples of 8.  With
// vec (src and stride allow 16-byte loads) and 16-byte rows in dst, the
// chunks go by cp.async, all in flight at once: the caller waits for them
// (cp_async_wait<0>, then a barrier).  Otherwise each thread loads four
// chunks into registers before it stores them.
template <typename T, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t stride, int rows, int cols,
                                          int n, int valid_cols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  const int total = rows * per_row;
  if constexpr (LD * sizeof(T) % 16 == 0) {
    if (vec) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int r = i / per_row, c0 = (i % per_row) * V;
        const bool ok = r < n && c0 < valid_cols;
        mma::cp_async16(reinterpret_cast<uint16_t*>(dst + r * LD + c0),
                        reinterpret_cast<const uint16_t*>(ok ? src + (size_t)r * stride + c0 : src),
                        ok);
      }
      return;
    }
  }
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
    uint4 u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      const int r = i / per_row, c0 = (i % per_row) * V;
      u[k] = make_uint4(0, 0, 0, 0);
      if (i >= total || r >= n || c0 >= valid_cols) continue;
      const T* p = src + (size_t)r * stride + c0;
      if (vec) {
        u[k] = *reinterpret_cast<const uint4*>(p);
      } else {
        T* e = reinterpret_cast<T*>(&u[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = p[j];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i >= total) break;
      const int r = i / per_row, c0 = (i % per_row) * V;
      const T* e = reinterpret_cast<const T*>(&u[k]);
      if constexpr (LD * sizeof(T) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst + r * LD + c0) = u[k];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[r * LD + c0 + j] = e[j];
      }
    }
  }
}

// cum[i] = sum_{r <= i} dt_r * a over the chunk's rows (one thread a row,
// the block's first kQ threads: a warp scan, then the earlier warps'
// totals in order); dts[i] = dt_i.  Rows >= n have dt = 0.  Ends with the
// block synchronised.
__device__ __forceinline__ void chunk_cum(const float* dtp, size_t stride, int n, float a,
                                          float* cum, float* dts, float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float c = 0.f;
  if (tid < kQ) {
    const float d = tid < n ? dtp[(size_t)tid * stride] : 0.f;
    c = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += v;
    }
    if (lane == 31) wsum[warp] = c;
    dts[tid] = d;
  }
  __syncthreads();
  if (tid < kQ) {
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off += wsum[w];
    cum[tid] = c + off;
  }
  __syncthreads();
}

// Shared-memory layouts.  16-bit tiles pad rows by 8 elements, so that the
// eight 16-byte rows an ldmatrix phase reads fall in different banks; f32
// tiles pad by 4 or 8 (16-byte rows; 8 where a warp reads float2 pairs
// from eight rows) or, where threads read down a column, 1.
template <typename T, int DS>
struct Layout {
  static constexpr bool kTC = kTensor<T>;
  // ssd_chunk_kernel, scores: C and B rows of two 64-row tiles
  static constexpr int kLdBC = kTC ? DS + 8 : DS + 1;
  static constexpr size_t kScores = 2 * (size_t)kR * kLdBC * sizeof(T);
  // ssd_chunk_kernel, chunk state: x and B rows of the chunk
  static constexpr int kLdX = kTC ? kP + 8 : kP + 4;
  static constexpr int kLdB = kTC ? DS + 8 : DS + 4;
  static constexpr size_t kStates = ((size_t)kQ * kLdX + (size_t)kQ * kLdB) * sizeof(T);
  static constexpr size_t kChunk =
      (kScores > kStates ? kScores : kStates) + (3 * kQ + 4) * sizeof(float);
  // ssd_output_kernel, kRows rows of a chunk: f32 only, their scores and
  // then W (the tensor-core path reads its score fragments from global
  // memory); x rows up to the block's last, its C rows, the f32 state
  static constexpr int kRows = out_threads(DS) / 32 * 16;  // rows of an output block
  static constexpr int kLdS = kQ + 4;
  static constexpr int kLdC = kTC ? DS + 8 : DS + 4;
  static constexpr int kLdH = kTC ? DS + 8 : DS + 1;
  static constexpr size_t kS = kTC ? 0 : (size_t)kRows * kLdS * sizeof(float);
  static constexpr size_t kX = (size_t)kQ * kLdX * sizeof(T);
  static constexpr size_t kC = (size_t)kRows * kLdC * sizeof(T);
  static constexpr size_t kH = (size_t)kP * kLdH * sizeof(float);
  static constexpr size_t kOutput = kS + kX + kC + kH + (2 * kQ + 4) * sizeof(float);
};

// ---------------------------------------------------------------------------
// 1. scores (once per group) and chunk states (per head), in parallel
// ---------------------------------------------------------------------------

// out (row stride kQ) = Cs . Bs^T, a 64 x 64 tile over K = DS.
template <typename T, int DS>
__device__ __forceinline__ void scores_tile(const T* Cs, const T* Bs, float* out) {
  constexpr int LD = Layout<T, DS>::kLdBC;
  const int tid = threadIdx.x;
  if constexpr (kTensor<T>) {
    const int lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
    float acc[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < DS; ks += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, u16(Cs) + (16 * warp + lane % 16) * LD + ks + 8 * (lane / 16));
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        // B = Bs^T: Bs rows are the n index, K contiguous (no transpose)
        uint32_t r[4];
        ldmatrix_x4(r, u16(Bs) + (8 * nt + lane % 8 + 8 * (lane / 16)) * LD + ks +
                           8 * ((lane / 8) % 2));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(acc[nt], af, b0);
        Mma<T>::run(acc[nt + 1], af, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(out + (16 * warp + g + 8 * hf) * kQ + 8 * nt + 2 * t) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  } else {
    const int ty = tid / 16, tx = tid % 16;  // rows ty + 8 i, columns tx + 16 j
    float acc[8][4] = {};
    for (int s = 0; s < DS; ++s) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Cs[(ty + 8 * i) * LD + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LD + s];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[(ty + 8 * i) * kQ + tx + 16 * j] = acc[i][j];
  }
}

// out (row stride DS) = (xs * dec)^T . bs over the chunk's kQ rows: rows p
// < pw of hd, all DS columns.  xs holds x rows (kQ x kP), bs B rows.  The
// f32 path scales xs in place.
template <typename T, int DS>
__device__ __forceinline__ void local_state(T* xs, const T* bs, const float* dec, float* out,
                                            int pw) {
  using L = Layout<T, DS>;
  constexpr int LX = L::kLdX, LB = L::kLdB;
  const int tid = threadIdx.x;
  if constexpr (kTensor<T>) {
    const int lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
    if (16 * warp >= pw) return;
    float acc[DS / 8][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kQ; ks += 16) {
      // A = (x dec)^T: x stored K-major, transposed on the way; each
      // register's pair (k, k + 1) scaled by dec and split into a high and
      // a low half
      uint32_t xr[4], ah[4], al[4];
      ldmatrix_x4_trans(xr, u16(xs) + (ks + lane % 8 + 8 * (lane / 16)) * LX + 16 * warp +
                                8 * ((lane / 8) % 2));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = ks + 2 * t + (r >= 2 ? 8 : 0);
        const float2 v = mma::unpack2<T>(xr[r]);
        split2<T>(v.x * dec[k], v.y * dec[k + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int nt = 0; nt < DS / 8; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, u16(bs) + (ks + lane % 16) * LB + 8 * (nt + lane / 16));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(acc[nt], ah, b0);
        Mma<T>::run(acc[nt], al, b0);
        Mma<T>::run(acc[nt + 1], ah, b1);
        Mma<T>::run(acc[nt + 1], al, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < DS / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = 16 * warp + g + 8 * hf;
        if (p < pw)
          *reinterpret_cast<float2*>(out + p * DS + 8 * nt + 2 * t) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
  } else {
    for (int i = tid; i < kQ * kP; i += kThreads) xs[(i / kP) * LX + i % kP] *= dec[i / kP];
    __syncthreads();
    constexpr int J = DS / 16;
    const int ty = tid / 16, tx = tid % 16;  // rows p = ty + 8 i, columns tx + 16 j
    float acc[8][J] = {};
    for (int q = 0; q < kQ; ++q) {
      float a[8], b[J];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[q * LX + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < J; ++j) b[j] = bs[q * LB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (ty + 8 * i < pw)
#pragma unroll
        for (int j = 0; j < J; ++j) out[(ty + 8 * i) * DS + tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, float* __restrict__ scores,
                     float* __restrict__ states, float* __restrict__ totals, int S, int nh, int hd,
                     int G, int nc, int n_score_blocks, bool vec) {
  using L = Layout<T, DS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t bc_row = (size_t)G * DS;  // B and C: stride of one sequence row
  int blk = blockIdx.x;

  if (blk < n_score_blocks) {  // (a) a 64 x 64 tile of a chunk's scores
    const int tile = blk % kTiles;
    blk /= kTiles;
    const int c = blk % nc;
    blk /= nc;
    const int g = blk % G, b = blk / G;
    int rt = 0, ct = tile;  // tiles (0, 0), (1, 0), (1, 1), ...
    while (ct > rt) ct -= ++rt;
    T* Cs = reinterpret_cast<T*>(smem);
    T* Bs = Cs + kR * L::kLdBC;
    const int r0 = c * kQ + rt * kR, j0 = c * kQ + ct * kR;
    const size_t base = (size_t)b * S * bc_row + (size_t)g * DS;
    load_tile<T, L::kLdBC>(Cs, Cm + base + (size_t)r0 * bc_row, bc_row, kR, DS, S - r0, DS, vec);
    load_tile<T, L::kLdBC>(Bs, Bm + base + (size_t)j0 * bc_row, bc_row, kR, DS, S - j0, DS, vec);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    scores_tile<T, DS>(Cs, Bs,
                       scores + (((size_t)b * G + g) * nc + c) * kQ * kQ + (size_t)rt * kR * kQ +
                           ct * kR);
    return;
  }

  // (b) a chunk's state from zero, 64 columns of hd
  blk -= n_score_blocks;
  const int nhs = (hd + kP - 1) / kP;
  const int hs = blk % nhs;
  blk /= nhs;
  const int c = blk % nc;
  blk /= nc;
  const int h = blk % nh, b = blk / nh;
  const int g = h / (nh / G);
  const int p0 = hs * kP, pw = min(kP, hd - p0);
  const int t0 = c * kQ, n = min(kQ, S - t0);
  float* cum = reinterpret_cast<float*>(smem + (L::kChunk - (3 * kQ + 4) * sizeof(float)));
  float* dts = cum + kQ;
  float* dec = dts + kQ;
  float* wsum = dec + kQ;
  T* xs = reinterpret_cast<T*>(smem);
  T* bs = xs + kQ * L::kLdX;
  load_tile<T, L::kLdX>(xs, x + (((size_t)b * S + t0) * nh + h) * hd + p0, (size_t)nh * hd, kQ,
                        kP, n, pw, vec);
  load_tile<T, L::kLdB>(bs, Bm + ((size_t)b * S + t0) * bc_row + (size_t)g * DS, bc_row, kQ, DS,
                        n, DS, vec);
  mma::cp_async_commit();
  chunk_cum(dt + ((size_t)b * S + t0) * nh + h, nh, n, A[h], cum, dts, wsum);
  const float total = cum[kQ - 1];
  dec[threadIdx.x] = expf(total - cum[threadIdx.x]) * dts[threadIdx.x];
  if (hs == 0 && threadIdx.x == 0) totals[((size_t)b * nh + h) * nc + c] = total;
  mma::cp_async_wait<0>();
  __syncthreads();
  local_state<T, DS>(xs, bs, dec, states + ((((size_t)b * nh + h) * nc + c) * hd + p0) * DS, pw);
}

// ---------------------------------------------------------------------------
// 2. the scan over chunks
// ---------------------------------------------------------------------------

// Element e of (request, head) bh's (hd, ds) state: h_c = exp(total_c)
// h_{c-1} + local_c, each chunk's slot overwritten with h_{c-1}, the state
// the chunk starts from; the last h is the state output.  Loads go eight
// chunks ahead of the sums.
__global__ void __launch_bounds__(kScanThreads)
    ssd_scan_kernel(float* __restrict__ states, const float* __restrict__ totals,
                    float* __restrict__ state_out, int nc, int per_head, long n_elems) {
  const long i = (long)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= n_elems) return;
  const long bh = i / per_head;
  float* st = states + bh * nc * per_head + i % per_head;
  const float* tot = totals + bh * nc;
  float h = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float v[8], e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        v[k] = st[(size_t)(c0 + k) * per_head];
        e[k] = expf(tot[c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        st[(size_t)(c0 + k) * per_head] = h;
        h = __fadd_rn(__fmul_rn(e[k], h), v[k]);
      }
  }
  state_out[i] = h;
}

// ---------------------------------------------------------------------------
// 3. outputs, per chunk in parallel
// ---------------------------------------------------------------------------

template <typename T, int DS, int NT = out_threads(DS)>
__global__ void __launch_bounds__(NT)
    ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Cm,
                      const float* __restrict__ scores, const float* __restrict__ states,
                      T* __restrict__ y, int S, int nh, int hd, int G, int nc, bool vec) {
  using L = Layout<T, DS>;
  constexpr int LS = L::kLdS, LX = L::kLdX, LC = L::kLdC, LH = L::kLdH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nhs = (hd + kP - 1) / kP;
  constexpr int kRows = L::kRows;
  int blk = blockIdx.x;
  const int hs = blk % nhs;
  blk /= nhs;
  const int rt = blk % (kQ / kRows);
  blk /= kQ / kRows;
  const int c = blk % nc;
  blk /= nc;
  const int h = blk % nh, b = blk / nh;
  const int g = h / (nh / G);
  const int p0 = hs * kP, pw = min(kP, hd - p0);
  const int t0 = c * kQ, n = min(kQ, S - t0);
  const int i0 = rt * kRows;    // the block's first row in the chunk
  const int cols = i0 + kRows;  // the columns j <= i of its rows: x rows 0 .. cols - 1

  float* Ss = reinterpret_cast<float*>(smem);  // f32 path only
  T* xs = reinterpret_cast<T*>(smem + L::kS);
  T* cs = reinterpret_cast<T*>(smem + L::kS + L::kX);
  float* Hs = reinterpret_cast<float*>(smem + L::kS + L::kX + L::kC);
  float* cum = Hs + kP * LH;
  float* dts = cum + kQ;
  float* wsum = dts + kQ;

  const size_t x_row = (size_t)nh * hd;
  const size_t bc_row = (size_t)G * DS;
  const float* Sg = scores + ((((size_t)b * G + g) * nc + c) * kQ + i0) * kQ;
  if constexpr (!L::kTC) load_tile<float, LS>(Ss, Sg, kQ, kRows, cols, kRows, cols, true);
  load_tile<T, LX>(xs, x + (((size_t)b * S + t0) * nh + h) * hd + p0, x_row, cols, kP, n, pw,
                   vec);
  load_tile<T, LC>(cs, Cm + ((size_t)b * S + t0 + i0) * bc_row + (size_t)g * DS, bc_row, kRows,
                   DS, n - i0, DS, vec);
  load_tile<float, LH>(Hs, states + ((((size_t)b * nh + h) * nc + c) * hd + p0) * DS, DS, kP, DS,
                       pw, DS, true);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  chunk_cum(dt + ((size_t)b * S + t0) * nh + h, nh, n, A[h], cum, dts, wsum);

  const int tid = threadIdx.x;
  T* yb = y + ((size_t)b * S + t0) * x_row + (size_t)h * hd + p0;
  if constexpr (L::kTC) {
    const int lane = tid % 32, warp = tid / 32, g8 = lane / 4, t = lane % 4;
    // W at chunk row i, column j from its score: 0 past the diagonal
    auto w = [&](float sc, int i, float ci, int j) {
      return j <= i ? sc * expf(ci - cum[j]) * dts[j] : 0.f;
    };
    const int ia = i0 + 16 * warp + g8, ib = ia + 8;  // this thread's rows of the chunk
    const float ca = cum[ia], cb = cum[ib];
    // this thread's scores of a 16-column step (rows ia and ib, columns
    // j, j + 1 and j + 8, j + 9), read from global memory two steps
    // ahead of their use
    const float* Sa = Sg + (size_t)(16 * warp + g8) * kQ + 2 * t;
    const float* Sb = Sa + 8 * kQ;
    auto fetch = [&](float2 (&f)[4], int kk) {
      f[0] = *reinterpret_cast<const float2*>(Sa + 16 * kk);
      f[1] = *reinterpret_cast<const float2*>(Sb + 16 * kk);
      f[2] = *reinterpret_cast<const float2*>(Sa + 16 * kk + 8);
      f[3] = *reinterpret_cast<const float2*>(Sb + 16 * kk + 8);
    };
    float yi[8][4] = {}, ye[8][4] = {};
    auto step = [&](const float2 (&f)[4], int kk) {
      const int j = 16 * kk + 2 * t;
      uint32_t ah[4], al[4];
      split2<T>(w(f[0].x, ia, ca, j), w(f[0].y, ia, ca, j + 1), ah[0], al[0]);
      split2<T>(w(f[1].x, ib, cb, j), w(f[1].y, ib, cb, j + 1), ah[1], al[1]);
      split2<T>(w(f[2].x, ia, ca, j + 8), w(f[2].y, ia, ca, j + 9), ah[2], al[2]);
      split2<T>(w(f[3].x, ib, cb, j + 8), w(f[3].y, ib, cb, j + 9), ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, u16(xs) + (16 * kk + lane % 16) * LX + 8 * (nt + lane / 16));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(yi[nt], ah, b0);
        Mma<T>::run(yi[nt], al, b0);
        Mma<T>::run(yi[nt + 1], ah, b1);
        Mma<T>::run(yi[nt + 1], al, b1);
      }
    };
    const int nks = (i0 + 16 * warp + 16) / 16;  // 16-column steps up to the diagonal
    float2 fa[4], fb[4];
    fetch(fa, 0);
    if (nks > 1) fetch(fb, 1);
    for (int kk = 0; kk < nks; kk += 2) {
      step(fa, kk);
      if (kk + 2 < nks) fetch(fa, kk + 2);
      if (kk + 1 < nks) {
        step(fb, kk + 1);
        if (kk + 3 < nks) fetch(fb, kk + 3);
      }
    }
#pragma unroll
    for (int ks = 0; ks < DS; ks += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, u16(cs) + (16 * warp + lane % 16) * LC + ks + 8 * (lane / 16));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // B = h^T: register r holds k = ks + 2 t + 8 r and the next of
        // column n = 8 nt + g8, the state's row n; as a high and low half
        const float* hrow = Hs + (8 * nt + g8) * LH + ks + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(hrow);
        const float2 v1 = *reinterpret_cast<const float2*>(hrow + 8);
        uint32_t bh[2], bl[2];
        split2<T>(v0.x, v0.y, bh[0], bl[0]);
        split2<T>(v1.x, v1.y, bh[1], bl[1]);
        Mma<T>::run(ye[nt], af, bh);
        Mma<T>::run(ye[nt], af, bl);
      }
    }
    const float ea = expf(ca), eb = expf(cb);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = hf ? ib : ia;
        const int col = 8 * nt + 2 * t;
        if (i >= n || col >= pw) continue;
        const float e = hf ? eb : ea;
        const float y0 = __fadd_rn(yi[nt][2 * hf], __fmul_rn(ye[nt][2 * hf], e));
        const float y1 = __fadd_rn(yi[nt][2 * hf + 1], __fmul_rn(ye[nt][2 * hf + 1], e));
        *reinterpret_cast<uint32_t*>(yb + (size_t)i * x_row + col) = mma::pack2<T>(y0, y1);
      }
  } else {
    // W in place of the scores
    for (int e = tid; e < kRows * cols; e += NT) {
      const int r = e / cols, j = e % cols, i = i0 + r;
      Ss[r * LS + j] = j <= i ? Ss[r * LS + j] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
    }
    __syncthreads();
    constexpr int TY = NT / 16;
    static_assert(8 * TY == kRows, "8 rows a thread");
    const int ty = tid / 16, tx = tid % 16;  // block rows ty + TY a, columns tx + 16 q
    float yi[8][4] = {}, ye[8][4] = {};
    for (int j = 0; j < cols; ++j) {
      float wv[8], xv[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) wv[a] = Ss[(ty + TY * a) * LS + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[j * LX + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) yi[a][q] = fmaf(wv[a], xv[q], yi[a][q]);
    }
    for (int s = 0; s < DS; ++s) {
      float cv[8], hv[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) cv[a] = cs[(ty + TY * a) * LC + s];
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[q] = Hs[(tx + 16 * q) * LH + s];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) ye[a][q] = fmaf(cv[a], hv[q], ye[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = i0 + ty + TY * a;
      if (i >= n) continue;
      const float e = expf(cum[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = tx + 16 * q;
        if (col < pw)
          yb[(size_t)i * x_row + col] =
              from_f32<T>(__fadd_rn(yi[a][q], __fmul_rn(ye[a][q], e)));
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int DS>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* state, float* scratch, int B, int S, int nh, int hd, int G,
           cudaStream_t stream) {
  using L = Layout<T, DS>;
  const int nc = (S + kQ - 1) / kQ;
  const int nhs = (hd + kP - 1) / kP;
  float* scores = scratch;
  float* states = scores + (size_t)B * G * nc * kQ * kQ;
  float* totals = states + (size_t)B * nh * nc * hd * DS;
  const bool vec = aligned16(x) && aligned16(Bm) && aligned16(Cm);
  const long n_score = (long)B * G * nc * kTiles;
  const long n_chunk = n_score + (long)B * nh * nc * nhs;
  const long n_out = (long)B * nh * nc * (kQ / L::kRows) * nhs;
  const long n_elems = (long)B * nh * hd * DS;
  const long n_scan = (n_elems + kScanThreads - 1) / kScanThreads;
  if (n_chunk > 0x7fffffffL || n_out > 0x7fffffffL || n_scan > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* Bp = static_cast<const T*>(Bm);
  const T* Cp = static_cast<const T*>(Cm);

  int e = attn::allow_smem(ssd_chunk_kernel<T, DS>, L::kChunk);
  if (e) return e;
  ssd_chunk_kernel<T, DS><<<(unsigned)n_chunk, kThreads, L::kChunk, stream>>>(
      xp, dt, A, Bp, Cp, scores, states, totals, S, nh, hd, G, nc, (int)n_score, vec);
  if ((e = (int)cudaGetLastError())) return e;
  ssd_scan_kernel<<<(unsigned)n_scan, kScanThreads, 0, stream>>>(states, totals, state, nc,
                                                                 hd * DS, n_elems);
  if ((e = (int)cudaGetLastError())) return e;
  e = attn::allow_smem(ssd_output_kernel<T, DS>, L::kOutput);
  if (e) return e;
  ssd_output_kernel<T, DS><<<(unsigned)n_out, out_threads(DS), L::kOutput, stream>>>(
      xp, dt, A, Cp, scores, states, static_cast<T*>(y), S, nh, hd, G, nc, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ds(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
              void* y, float* state, float* scratch, int B, int S, int nh, int hd, int G, int ds,
              cudaStream_t stream) {
  switch (ds) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, state, scratch, B, S, nh, hd, G, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, state, scratch, B, S, nh, hd, G, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, state, scratch, B, S, nh, hd, G, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, state, scratch, B, S, nh, hd, G, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, Bm, Cm and y); ds 16,
// 32, 64 or 128; hd a multiple of 16; G divides nh.  scratch holds
// B G nc kQ^2 + B nh nc (hd ds + 1) floats, nc = ceil(S / 128), 16-byte
// aligned.  Returns the first launch error (cudaError_t, 0 on success);
// the three kernels run on `stream` and are not waited for.
extern "C" int mamba2_ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, void* y, void* state, void* scratch, int B, int S,
                                 int nh, int hd, int G, int ds, int dtype, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || G < 1 || nh % G || hd < 16 || hd % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  float* scr = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return launch_ds<float>(x, dtf, Af, Bm, Cm, y, sf, scr, B, S, nh, hd, G, ds, st);
    case 1:
      return launch_ds<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, scr, B, S, nh, hd, G, ds, st);
    case 2:
      return launch_ds<__half>(x, dtf, Af, Bm, Cm, y, sf, scr, B, S, nh, hd, G, ds, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
