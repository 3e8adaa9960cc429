// Causal grouped-query flash attention for Hopper (sm_90a): a prefill (or
// training) step's S query rows against T key/value rows.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py: _flash_kernel), which the
// synchronous serve engine runs once per layer on every prefill.
//
// Operands (row-major, contiguous):
//   q        (B, S, H, hd)     queries, H = KV * G
//   k, v     (B, T, KV, hd)    keys and values; rows >= kv_len are masked
//   out      (B, S, H, hd)     in q's dtype; rows >= S are never written
//
// Bound: operations at full width.  A causal 2048-row prefill of qwen2-7b
// does 4 * H * S * T * hd / 2 = 30 GFLOP on 34 MB of q, k, v and out,
// ~900 flops per byte, above the ~295 where an H100's bf16 tensor cores
// take over from memory as the limit.  So the two products belong on the
// tensor cores, fed fast enough from shared memory that they do not wait.
//
// Design (bf16 / f16, FlashAttention-2's shape on mma.sync): one block of
// 4 warps per (request, query head, tile of 64 query rows); warp w owns
// query rows 16 w .. 16 w + 15 and keeps their online softmax -- running
// max, denominator and a 16 x hd f32 accumulator -- in registers.  The q
// tile is copied to shared memory once and read into A fragments with
// ldmatrix, where it stays.  The block reads the K/V rows of its KV head
// h / G straight from the cache (the TPU wrapper repeats K/V G times
// first) in 64-row tiles through a 2-stage cp.async ring of 16-byte
// chunks, so the next tile is in flight while this one is multiplied;
// rows past kv_len are zero-filled, never read.  Per tile, per warp:
//   S = Q.K^T on mma.sync.m16n8k16 (ldmatrix on the K rows gives the B
//   fragments directly), times the scale; the online softmax on the
//   accumulator fragments, a row's max and sum over its quad of lanes by
//   two shuffles; p packed straight into the A fragments of the PV
//   product as a high and a low half in V's dtype (split2; the m16n8
//   accumulator layout is the m16n8k16 A layout in pairs: no shared-memory
//   round trip); PV on mma.sync (ldmatrix.trans on the V rows),
//   hi.V + lo.V accumulated into the f32 output fragments.
// Tiles wholly past kv_len or (causal) wholly above the diagonal are
// never read, and only the tiles that cross kv_len or the diagonal are
// masked.  The grid runs the query tiles in reverse, so under a causal
// mask the longest ones start first.  Rows padded by 8 elements keep the
// eight rows of every ldmatrix phase in different banks.
//
// f32 operands (CUDA cores; TF32 is off in the port): one block of 256
// threads per (request, head, 64-row tile), each thread 4 query rows by 4
// score columns and 4 rows by hd / 16 output dims, the tiles in shared
// memory as f32.  Chosen by dtype; it is the f32 kernel, not a fallback.
//
// Numerics: the masks, the -0.7 * FLT_MAX of a masked score, the f32
// running max, denominator and accumulator and the output acc / max(l,
// 1e-30) are _flash_kernel's.  Two roundings differ, on purpose.  The score
// is (q . k) * scale (the reference: (q * scale) . k in f32), so that bf16
// products stay exact on the tensor cores and the scale multiplies the f32
// sum.  And p and each tile's PV product stay f32, where the reference
// rounds both to V's dtype (its dot returns V's dtype): split2 carries p
// onto the tensor cores to a relative 2^-16, and the mma accumulates PV into
// the f32 output fragments, as FlashAttention-2 does.  So the output is
// rounded once, as the model's plain path (_flash_sdpa, all f32) rounds
// its own.  The plain version (kernels/flash_attention.py) does the same.

#include <cstdint>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

using attn::kNegInf;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::Mma;
using mma::pack2;
using mma::split2;

constexpr int kBQ = 64;    // query rows per block
constexpr int kBKV = 64;   // key/value rows per step (TILE in flash_attention.py)

// ---------------------------------------------------------------------------
// Tensor cores: bf16 / f16.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

// q tile and a 2-stage ring of K and V tiles, rows padded to HD + 8
template <int HD>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kBQ + 2 * 2 * kBKV) * (HD + 8) * sizeof(uint16_t);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
mma_flash_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, T* __restrict__ out, int S, int T_len, int H,
                 int KV, int kv_len, int causal, float scale) {
  constexpr int LD = HD + 8;       // padded smem row: ldmatrix phases bank-free
  constexpr int KS = HD / 16;      // k-steps of the score product
  constexpr int ND = HD / 8;       // n8 tiles of the output
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;         // fragment row within 8
  const int t = lane & 3;          // fragment column pair

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;                 // (kBQ, LD)
  uint16_t* ring = qs + kBQ * LD;      // 2 stages x (K tile, V tile), (kBKV, LD) each

  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)KV * HD;
  const uint16_t* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const uint16_t* kb = k + (size_t)b * T_len * kv_row + (size_t)kvh * HD;
  const uint16_t* vb = v + (size_t)b * T_len * kv_row + (size_t)kvh * HD;

  const int n = min(kv_len, T_len);
  int n_tiles = n > 0 ? (n + kBKV - 1) / kBKV : 0;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, S) - 1) / kBKV + 1);

  // rows past S (q) or past kv_len (K, V) are zero-filled, never read
  for (int i = tid; i < kBQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = q0 + r < S;
    cp_async16(qs + r * LD + c, ok ? qb + (size_t)(q0 + r) * q_row + c : qb, ok);
  }
  auto load_tile = [&](int j) {
    uint16_t* ks = ring + (j & 1) * 2 * kBKV * LD;
    uint16_t* vs = ks + kBKV * LD;
    const int t0 = j * kBKV;
    for (int i = tid; i < kBKV * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = t0 + r < n;
      const size_t off = (size_t)(t0 + r) * kv_row + c;
      cp_async16(ks + r * LD + c, ok ? kb + off : kb, ok);
      cp_async16(vs + r * LD + c, ok ? vb + off : vb, ok);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  uint32_t qf[KS][4];   // the warp's 16 q rows as A fragments, loaded once
  float acc[ND][4];     // register r of tile nd: row row0 + 8 (r >> 1)
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * warp + g;   // this thread's rows: row0, row0 + 8

  if (n_tiles == 0) {
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j (and the q tile) landed, this thread's part
    __syncthreads();      // ... every thread's
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
    }
    const uint16_t* ks = ring + (j & 1) * 2 * kBKV * LD;
    const uint16_t* vs = ks + kBKV * LD;
    const int t0 = j * kBKV;

    // 1. S = Q.K^T: n8 tile nt holds keys t0 + 8 nt .. + 7; one x4 load
    //    gives its B fragments for two k-steps
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (8 * nt + (lane & 7)) * LD + 16 * kk + 8 * (lane >> 3));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(s[nt], qf[kk], b0);
        Mma<T>::run(s[nt], qf[kk + 1], b1);
      }
    }

    // 2. scale, mask (only a tile that crosses kv_len or the diagonal),
    //    online softmax per row over its quad
    const bool edge = t0 + kBKV > n || (causal && t0 + kBKV - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nt][r] * scale;
        if (edge) {
          const int col = t0 + 8 * nt + 2 * t + (r & 1);
          if (col >= n || (causal && col > row0 + 8 * (r >> 1))) x = kNegInf;
        }
        s[nt][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // p = hi + lo as the A fragments of the 4 k-steps of PV (split2: the
    // product keeps p in f32)
    uint32_t pa[4][4], pl[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      split2<T>(p0, p1, pa[nt >> 1][2 * (nt & 1)], pl[nt >> 1][2 * (nt & 1)]);
      split2<T>(p2, p3, pa[nt >> 1][2 * (nt & 1) + 1], pl[nt >> 1][2 * (nt & 1) + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }

    // 3. acc = acc * corr + p @ V, the product accumulated in the f32
    //    fragment itself: one x4.trans load gives an n8 tile's B fragments
    //    for two k-steps (32 keys)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nd][r] *= corr[r >> 1];
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (32 * kp + lane) * LD + 8 * nd);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(acc[nd], pa[2 * kp], b0);
        Mma<T>::run(acc[nd], pl[2 * kp], b0);
        Mma<T>::run(acc[nd], pa[2 * kp + 1], b1);
        Mma<T>::run(acc[nd], pl[2 * kp + 1], b1);
      }
    }
    __syncthreads();   // every warp is done with stage j & 1 before it refills
  }

  T* ob = out + (size_t)b * S * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * q_row + 8 * nd + 2 * t) =
          pack2<T>(acc[nd][2 * i] / den, acc[nd][2 * i + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: f32.
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16 threads (ty, tx)
constexpr int kRows = kBQ / 16;   // query rows per thread: ty + 16 i
constexpr int kCols = kBKV / 16;  // score columns per thread: tx + 16 c

template <int HD>
constexpr size_t fma_smem_bytes() {
  return ((size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) + (size_t)kBQ * (kBKV + 1)) *
         sizeof(float);
}

// Max over the 16 lanes that share a query row (one half of the warp).
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads, 2)
fma_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S, int T_len, int H,
                 int KV, int kv_len, int causal, float scale) {
  constexpr int LD = HD + 1;       // padded row of the q and K/V tiles
  constexpr int LDP = kBKV + 1;    // padded row of the p tile
  constexpr int kDims = HD / 16;   // output dims per thread: tx + 16 e
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float fsmem[];
  float* qs = fsmem;             // (kBQ, LD)  q
  float* kv = qs + kBQ * LD;     // (kBKV, LD) the K tile, then the V tile
  float* ps = kv + kBKV * LD;    // (kBQ, LDP) p rounded to T

  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)KV * HD;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const float* kb = k + (size_t)b * T_len * kv_row + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * T_len * kv_row + (size_t)kvh * HD;

  for (int i = tid; i < kBQ * HD; i += kFmaThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * LD + d] = q0 + r < S ? qb[(size_t)(q0 + r) * q_row + d] : 0.f;
  }

  // rows attended, and the tiles that hold any of them for these queries
  const int n = min(kv_len, T_len);
  int n_tiles = n > 0 ? (n + kBKV - 1) / kBKV : 0;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, S) - 1) / kBKV + 1);

  float m[kRows], l[kRows], corr[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kBKV;
    const int valid = min(kBKV, n - t0);
    __syncthreads();   // the q tile is stored; the last tile's readers are done
    for (int i = tid; i < kBKV * HD; i += kFmaThreads) {
      const int c = i / HD, d = i % HD;
      kv[c * LD + d] = c < valid ? kb[(size_t)(t0 + c) * kv_row + d] : 0.f;
    }
    __syncthreads();

    // 1. scores s = (q . k) * scale in f32, masked past kv_len and above
    //    the diagonal; then the online softmax of each row over its 16 lanes
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bk[c] = kv[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] += a[i] * bk[c];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = t0 + tx + 16 * c;
        s[i][c] *= scale;
        if (col >= n || (causal && col > row)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        s[i][c] = p;   // f32 operands: rounding p to f32 changes nothing
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();   // every thread is done with the K tile

    // 2. acc = acc * corr + p @ V
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) ps[(ty + 16 * i) * LDP + tx + 16 * c] = s[i][c];
    for (int i = tid; i < kBKV * HD; i += kFmaThreads) {
      const int c = i / HD, d = i % HD;
      kv[c * LD + d] = c < valid ? vb[(size_t)(t0 + c) * kv_row + d] : 0.f;
    }
    __syncthreads();
    float pv[kRows][kDims];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) pv[i][e] = 0.f;
    for (int c = 0; c < valid; ++c) {
      float a[kRows], bv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < kDims; ++e) bv[e] = kv[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kDims; ++e) pv[i][e] += a[i] * bv[e];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] = acc[i][e] * corr[i] + pv[i][e];
  }

  float* ob = out + (size_t)b * S * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      ob[(size_t)row * q_row + tx + 16 * e] = acc[i][e] / fmaxf(l[i], 1e-30f);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S,
               int T_len, int H, int KV, int kv_len, int causal, float scale,
               cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  constexpr size_t smem = mma_smem_bytes<HD>();
  const int e = attn::allow_smem(mma_flash_kernel<T, HD>, smem);
  if (e) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  mma_flash_kernel<T, HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<T*>(out), S, T_len, H, KV, kv_len, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* out, int B, int S,
               int T_len, int H, int KV, int kv_len, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD>();
  const int e = attn::allow_smem(fma_flash_kernel<HD>, smem);
  if (e) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fma_flash_kernel<HD><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_len, H, KV, kv_len, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int H, int KV, int kv_len, int causal, float scale, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fma<HD>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, stream);
    case 1:
      return launch_mma<__nv_bfloat16, HD>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal,
                                           scale, stream);
    case 2:
      return launch_mma<__half, HD>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; hd 32, 64 or 128.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream` and is not waited for.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int T_len, int H, int KV, int hd,
                                      int kv_len, int causal, float scale, int dtype,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, dtype, st);
    case 64:
      return launch<64>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, dtype, st);
    case 128:
      return launch<128>(q, k, v, out, B, S, T_len, H, KV, kv_len, causal, scale, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
