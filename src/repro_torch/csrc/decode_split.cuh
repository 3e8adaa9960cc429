// Split flash-decode for Hopper (sm_90a): one query token per request
// against its KV cache, grouped-query heads, each request's cache cut into
// splits that run on many blocks at once.  The body of both decode
// kernels: decode_attention.cu (a contiguous cache) and
// paged_decode_attention.cu (a block-paged pool).  They differ only in
// where row r of request b lives, which a Rows functor says:
//   ContiguousRows: ((b * T + r) * KV + kvh) * hd
//   PagedRows:      (tables[b * NB + r / page] * page + r % page) * KV * hd
//                   + kvh * hd
// Every address is computed row by row, so a 64-row tile or a split may
// cross a page boundary.
//
// Operands (row-major, contiguous):
//   q        (B, H, hd)       query of each request's new token
//   k, v     the cache: (B, T, KV, hd), or pools (P, page, KV, hd) with
//            tables (B, NB) int32 and T = NB * page; rows [0, len) written
//   lens     (B,) int32       tokens each request attends, or null (the
//                             contiguous cache only): then every request
//                             attends `kv_len` tokens
//   out      (B, H, hd)       in q's dtype
//   acc      (B, H, ns, hd)   f32 scratch: each split's unnormalised sum
//   m, l     (B, H, ns)       f32 scratch: each split's max, denominator
//   tickets  (B, KV, nf)      int32 counters, zero before and after
//
// Bound: bytes.  ~2 * G flops per byte of K/V in bf16, far below the ~295
// flops per byte where an H100's tensor cores become the limit; the floor
// is reading each attended K/V row once, sum_b len[b] * KV * hd * 2 *
// sizeof(T) bytes at 3.35 TB/s.  To come near it the card needs many
// blocks with bytes in flight: one block per (request, KV head), as the
// TPU grid's B * KV programs, leaves 100 of the 132 SMs idle at B = 8
// and 128 of them at B = 1, each walking its request's cache alone.
//
// Design (flash-decoding).  Each request's rows [0, len) are cut into ns
// splits of R rows (R a multiple of the 64-row tile and at least two
// tiles, chosen by the wrapper from T and B * KV alone, so that ~2 blocks
// an SM run when every split is live), and the grid is (split, KV head x
// head fragment, request).  A block whose split starts at or past its
// request's length exits at once, so table slots past a request's prefix
// (the paged engine points them at null block 0) are never looked up.  A
// block walks its split in 64-row tiles through a 2-stage cp.async ring
// of 16-byte chunks, rows past the length zero-filled and never read
// (stale or poisoned rows cannot leak in), from m = -inf, and writes its
// split's unnormalised f32 acc, running max m and denominator l to
// scratch.  Then it takes a ticket: the last live split of its (request,
// KV head, fragment) to finish resets the ticket for the next launch and
// merges the splits in f32: M = max m_s, L = sum l_s e^(m_s - M), out =
// sum acc_s e^(m_s - M) / max(L, 1e-30), rounded once to q's dtype.  With
// one split this is the single-block loop exactly.  One launch, no second
// kernel.
//
// bf16 / f16 (tensor cores): a block of 4 warps per 16-head fragment of
// the group (G <= 16 is one fragment; G = 7 leaves 9 rows of the A
// fragment zero; G > 16 is ceil(G / 16) blocks, each reading the split).
// Every warp forms the whole 16 x 64 score tile S = Q.K^T on
// mma.sync.m16n8k16 (Q's A fragments by ldmatrix from shared memory, K's
// B fragments by ldmatrix on the K rows), so the online softmax needs no
// exchange between warps: a row's max and sum take two shuffles in its
// quad.  p goes straight from the score accumulators into the A
// fragments of PV as a high and a low half in V's dtype (split2), and
// warp w accumulates hi.V + lo.V for head dims [w hd / 4, (w + 1) hd / 4)
// (ldmatrix.trans on the V rows) into its f32 accumulator fragment.
// f32 (CUDA cores; TF32 is off in the port): a block of 128 threads per
// split holds all G heads, the tile's row offsets in shared memory.
// Chosen by dtype; it is the f32 kernel, not a fallback.
//
// Numerics: the masks, the -0.7 * FLT_MAX of a masked score and the f32
// running max, denominator and accumulator are the reference's
// (_decode_body in src/repro/kernels/decode_attention.py).  Two roundings
// differ, on purpose.  The score is (q . k) * scale (the reference:
// (q * scale) . k): bf16 products are exact on the tensor cores and the
// scale multiplies the f32 sum.  And p and each tile's PV product stay
// f32, where the reference rounds both to V's dtype (its dot returns V's
// dtype): split2 carries p onto the tensor cores to a relative 2^-16, and
// the mma accumulates PV into the f32 fragment, as FlashAttention-2 keeps
// its output.  So only the output is rounded, and no tile adds a rounding
// of its own.  The plain versions (kernels/decode_attention.py) walk the
// same splits.

#pragma once

#include <cstdint>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace decode_split {

using attn::from_f32;
using attn::kNegInf;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::Mma;
using mma::split2;

// cache rows per step of the online softmax (TILE in kernels/decode_attention.py)
constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kFrag = 16;   // query heads per A fragment

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;     // (B,) or null: every request attends kv_len rows
  const int* tables;   // (B, NB) for a paged pool, else null
  void* out;
  float* acc;          // (B, H, n_splits, hd) scratch
  float* m;            // (B, H, n_splits) scratch
  float* l;            // (B, H, n_splits) scratch
  int* tickets;        // (B, KV, n_frag), zero between launches
  int B, H, KV, hd, T_len, kv_len, R, n_splits;
  int page, NB;        // T_len = NB * page for a paged pool
  float scale;
};

// Element offset, in k and v, of row r0 + r of request b's cache at KV
// head kvh, for the split that starts at row r0.  kAnyRow: whether the
// offset of a row past the request's length may be formed (the loader
// then computes it without a branch; a paged row past the length has no
// table slot to read).
struct ContiguousRows {
  static constexpr bool kAnyRow = true;
  size_t base, stride;
  __device__ ContiguousRows(const Params& p, int b, int kvh, int r0)
      : base((((size_t)b * p.T_len + r0) * p.KV + kvh) * p.hd), stride((size_t)p.KV * p.hd) {}
  __device__ size_t operator()(int r) const { return base + (size_t)r * stride; }
};

struct PagedRows {
  static constexpr bool kAnyRow = false;
  const int* table;   // request b's NB block ids
  int page, r0;
  size_t stride, head;
  __device__ PagedRows(const Params& p, int b, int kvh, int r0)
      : table(p.tables + (size_t)b * p.NB), page(p.page), r0(r0), stride((size_t)p.KV * p.hd),
        head((size_t)kvh * p.hd) {}
  __device__ size_t operator()(int r) const {
    r += r0;
    return ((size_t)__ldg(table + r / page) * page + r % page) * stride + head;
  }
};

__device__ __forceinline__ int request_len(const Params& p, int b) {
  return min(p.lens != nullptr ? p.lens[b] : p.kv_len, p.T_len);
}

// Heads [h0, h0 + nh) of request b once every live split has written its
// state: out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30),
// M = max m_s, over the splits in order.  One thread per (head, 8 dims),
// so that a block covers 16 heads of 64 dims or 8 of 128 in one round,
// with 16 (then 8) splits' loads in flight; the other blocks' state is
// read from L2 (__ldcg), past this SM's L1.
template <typename T>
__device__ void combine_splits(const Params& p, int b, int h0, int nh, int live) {
  T* out = static_cast<T*>(p.out);
  const int groups = p.hd / 8;
  for (int i = threadIdx.x; i < nh * groups; i += blockDim.x) {
    const int h = h0 + i / groups;
    const int d = (i % groups) * 8;
    const size_t base = ((size_t)b * p.H + h) * p.n_splits;
    float M = kNegInf;
#pragma unroll 16
    for (int s = 0; s < live; ++s) M = fmaxf(M, __ldcg(p.m + base + s));
    float L = 0.f, o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int s = 0; s < live; ++s) {
      const float w = expf(__ldcg(p.m + base + s) - M);
      L += __ldcg(p.l + base + s) * w;
      const float4* a = reinterpret_cast<const float4*>(p.acc + (base + s) * p.hd + d);
      const float4 a0 = __ldcg(a), a1 = __ldcg(a + 1);
      o[0] += a0.x * w;
      o[1] += a0.y * w;
      o[2] += a0.z * w;
      o[3] += a0.w * w;
      o[4] += a1.x * w;
      o[5] += a1.y * w;
      o[6] += a1.z * w;
      o[7] += a1.w * w;
    }
    const float den = fmaxf(L, 1e-30f);
    T* ob = out + ((size_t)b * p.H + h) * p.hd + d;
#pragma unroll
    for (int j = 0; j < 8; ++j) ob[j] = from_f32<T>(o[j] / den);
  }
}

// After a block has written its split's state: take a ticket, and if it
// is the last live split of its (request, KV head, fragment) reset the
// ticket for the next launch and combine the splits.
template <typename T>
__device__ void finish(const Params& p, int b, int kvh, int frag, int n_frag, int h0, int nh,
                       int n) {
  __shared__ int last;
  const int live = (n + p.R - 1) / p.R;
  __threadfence();   // this block's state is visible to every block
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + ((size_t)b * p.KV + kvh) * n_frag + frag;
    last = atomicAdd(ticket, 1) == live - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();   // ... and the last block sees every block's state
  combine_splits<T>(p, b, h0, nh, live);
}

// A request of length 0 has no live split: split 0 writes its zeros.
template <typename T>
__device__ void write_empty(const Params& p, int b, int h0, int nh) {
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.H + h0) * p.hd;
  for (int i = threadIdx.x; i < nh * p.hd; i += blockDim.x) out[i] = from_f32<T>(0.f);
}

// ---------------------------------------------------------------------------
// Tensor cores: bf16 / f16.
// ---------------------------------------------------------------------------

// the fragment's q rows and a 2-stage ring of K and V tiles, rows padded
// to HD + 8 elements
template <int HD>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kFrag + 2 * 2 * kTile) * (HD + 8) * sizeof(uint16_t);
}

template <typename Rows, typename T, int HD>
__global__ void __launch_bounds__(kThreads) mma_split_kernel(const Params p) {
  constexpr int LD = HD + 8;         // padded smem row: ldmatrix phases bank-free
  constexpr int KS = HD / 16;        // k-steps of the score product
  constexpr int NW = HD / 32;        // n8 tiles of PV per warp (hd / 4 dims)
  constexpr int kChunks = HD / 8;    // 16-byte chunks of a row
  const int G = p.H / p.KV;
  const int n_frag = (G + kFrag - 1) / kFrag;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_frag;
  const int frag = blockIdx.y % n_frag;
  const int b = blockIdx.z;
  const int h0 = kvh * G + frag * kFrag;   // first head of the fragment
  const int nh = min(kFrag, G - frag * kFrag);
  const int r0 = split * p.R;
  const int n = request_len(p, b);
  if (r0 >= n) {
    if (split == 0) write_empty<T>(p, b, h0, nh);
    return;
  }
  const int rows = min(p.R, n - r0);
  const int n_tiles = (rows + kTile - 1) / kTile;
  const Rows row_at(p, b, kvh, r0);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;                 // (16, LD): the fragment's heads, rows >= nh zero
  uint16_t* ring = qs + kFrag * LD;    // 2 stages x (K tile, V tile), (64, LD) each

  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + ((size_t)b * p.H + h0) * HD;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k);
  const uint16_t* vb = static_cast<const uint16_t*>(p.v);

  for (int i = tid; i < kFrag * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    cp_async16(qs + r * LD + c, r < nh ? qb + (size_t)r * HD + c : qb, r < nh);
  }
  auto load_tile = [&](int j) {
    uint16_t* ks = ring + (j & 1) * 2 * kTile * LD;
    uint16_t* vs = ks + kTile * LD;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int row = j * kTile + r;
      const bool ok = row < rows;
      const size_t off = (Rows::kAnyRow || ok) ? row_at(row) + c : 0;
      cp_async16(ks + r * LD + c, ok ? kb + off : kb, ok);
      cp_async16(vs + r * LD + c, ok ? vb + off : vb, ok);
    }
  };
  load_tile(0);
  cp_async_commit();

  float acc[NW][4];
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int d0 = warp * (HD / 4);   // this warp's head dims in PV

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j (and q) landed, this thread's part
    __syncthreads();      // ... every thread's
    const uint16_t* ks = ring + (j & 1) * 2 * kTile * LD;
    const uint16_t* vs = ks + kTile * LD;

    // 1. S = Q.K^T (16 heads x 64 rows), every warp the whole tile
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t qa0[4], qa1[4];   // Q's A fragments of k-steps kk, kk + 1
      ldmatrix_x4(qa0, qs + (lane & 15) * LD + 16 * kk + 8 * (lane >> 4));
      ldmatrix_x4(qa1, qs + (lane & 15) * LD + 16 * (kk + 1) + 8 * (lane >> 4));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (8 * nt + (lane & 7)) * LD + 16 * kk + 8 * (lane >> 3));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(s[nt], qa0, b0);
        Mma<T>::run(s[nt], qa1, b1);
      }
    }

    // 2. scale, mask rows past the split's length, online softmax per
    //    head row over its quad
    const bool edge = (j + 1) * kTile > rows;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nt][r] * p.scale;
        if (edge && j * kTile + 8 * nt + 2 * t + (r & 1) >= rows) x = kNegInf;
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

    // 3. acc = acc * corr + p @ V on this warp's head dims, the product
    //    accumulated in the f32 fragment itself: one x4.trans load gives an
    //    n8 tile's B fragments for 32 rows
#pragma unroll
    for (int nd = 0; nd < NW; ++nd) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nd][r] *= corr[r >> 1];
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (32 * kp + lane) * LD + d0 + 8 * nd);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(acc[nd], pa[2 * kp], b0);
        Mma<T>::run(acc[nd], pl[2 * kp], b0);
        Mma<T>::run(acc[nd], pa[2 * kp + 1], b1);
        Mma<T>::run(acc[nd], pl[2 * kp + 1], b1);
      }
    }
    __syncthreads();   // every warp is done with stage j & 1 before it refills
  }

  // the split's state: rows g and g + 8 of the fragment are heads h0 + g, h0 + g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int hr = g + 8 * i;
    if (hr >= nh) continue;
    const size_t sl = ((size_t)b * p.H + h0 + hr) * p.n_splits + split;
    float* ap = p.acc + sl * HD + d0 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < NW; ++nd)
      *reinterpret_cast<float2*>(ap + 8 * nd) = make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
    if (warp == 0 && t == 0) {
      p.m[sl] = m[i];
      p.l[sl] = l[i];
    }
  }
  finish<T>(p, b, kvh, frag, n_frag, h0, nh, n);
}

// ---------------------------------------------------------------------------
// CUDA cores: f32.  One block of 128 threads per (split, KV head, request)
// holds all G heads in shared memory.
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 8;   // hd <= 256: hd / 32 values per lane
constexpr int kGChunk = 8;       // query heads accumulated per PV pass

inline size_t fma_smem_bytes(int G, int hd) {
  return (size_t)(2 * G * hd + G * kTile + 3 * G) * sizeof(float);
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads) fma_split_kernel(const Params p) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int hd = p.hd;
  const int r0 = split * p.R;
  const int n = request_len(p, b);
  if (r0 >= n) {
    if (split == 0) write_empty<float>(p, b, kvh * G, G);
    return;
  }
  const int rows = min(p.R, n - r0);
  const int n_tiles = (rows + kTile - 1) / kTile;
  const Rows row_at(p, b, kvh, r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_lane = hd / 32;

  extern __shared__ float fsmem[];
  float* qs = fsmem;             // (G, hd)   q
  float* acc = qs + G * hd;      // (G, hd)   running PV accumulator
  float* s = acc + G * hd;       // (G, kTile) scores, then p
  float* m = s + G * kTile;      // (G,)      running max
  float* l = m + G;              // (G,)      running denominator
  float* corr = l + G;           // (G,)      this tile's rescale factor
  __shared__ size_t off[kTile];  // the tile's row offsets in k and v

  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = qb[i];
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const float* kp = static_cast<const float*>(p.k);
  const float* vp = static_cast<const float*>(p.v);
  for (int j = 0; j < n_tiles; ++j) {
    const int valid = min(kTile, rows - j * kTile);
    for (int c = tid; c < valid; c += kThreads) off[c] = row_at(j * kTile + c);
    __syncthreads();

    // 1. scores s[g, t] = (q_g . k_t) * scale: one warp per key row
    for (int c = warp; c < kTile; c += kWarps) {
      if (c >= valid) {
        for (int i = lane; i < G; i += 32) s[i * kTile + c] = kNegInf;
        continue;
      }
      const float* krow = kp + off[c];
      float kr[kMaxPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) kr[i] = i < per_lane ? krow[lane + 32 * i] : 0.f;
      for (int gi = 0; gi < G; ++gi) {
        const float* qg = qs + gi * hd;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i)
          if (i < per_lane) part += qg[lane + 32 * i] * kr[i];
        part = attn::warp_sum(part);
        if (lane == 0) s[gi * kTile + c] = part * p.scale;
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head
    for (int gi = warp; gi < G; gi += kWarps) {
      float* sg = s + gi * kTile;
      float mx = kNegInf;
      for (int c = lane; c < kTile; c += 32) mx = fmaxf(mx, sg[c]);
      mx = attn::warp_max(mx);
      const float m_prev = m[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        const float e = expf(sg[c] - m_new);
        sum += e;
        sg[c] = e;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[gi] = cr;
        l[gi] = l[gi] * cr + sum;
        m[gi] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p @ V, each thread a head dim for kGChunk heads
    for (int g0 = 0; g0 < G; g0 += kGChunk) {
      const int gn = min(kGChunk, G - g0);
      for (int d = tid; d < hd; d += kThreads) {
        float pv[kGChunk];
#pragma unroll
        for (int gi = 0; gi < kGChunk; ++gi) pv[gi] = 0.f;
        for (int c = 0; c < valid; ++c) {
          const float vv = vp[off[c] + d];
#pragma unroll
          for (int gi = 0; gi < kGChunk; ++gi)
            if (gi < gn) pv[gi] += s[(g0 + gi) * kTile + c] * vv;
        }
#pragma unroll
        for (int gi = 0; gi < kGChunk; ++gi) {
          if (gi < gn) {
            const int gg = g0 + gi;
            acc[gg * hd + d] = acc[gg * hd + d] * corr[gg] + pv[gi];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const int gi = i / hd, d = i % hd;
    p.acc[(((size_t)b * p.H + kvh * G + gi) * p.n_splits + split) * hd + d] = acc[i];
  }
  for (int gi = tid; gi < G; gi += kThreads) {
    const size_t sl = ((size_t)b * p.H + kvh * G + gi) * p.n_splits + split;
    p.m[sl] = m[gi];
    p.l[sl] = l[gi];
  }
  finish<float>(p, b, kvh, 0, 1, kvh * G, G, n);
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename Rows, typename T, int HD>
int launch_mma(const Params& p, cudaStream_t stream) {
  if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || !aligned16(p.acc))
    return (int)cudaErrorMisalignedAddress;
  constexpr size_t smem = mma_smem_bytes<HD>();
  const int e = attn::allow_smem(mma_split_kernel<Rows, T, HD>, smem);
  if (e) return e;
  const int G = p.H / p.KV;
  const dim3 grid(p.n_splits, p.KV * ((G + kFrag - 1) / kFrag), p.B);
  mma_split_kernel<Rows, T, HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Rows, typename T>
int launch_hd(const Params& p, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch_mma<Rows, T, 32>(p, stream);
    case 64: return launch_mma<Rows, T, 64>(p, stream);
    case 96: return launch_mma<Rows, T, 96>(p, stream);
    case 128: return launch_mma<Rows, T, 128>(p, stream);
    case 160: return launch_mma<Rows, T, 160>(p, stream);
    case 192: return launch_mma<Rows, T, 192>(p, stream);
    case 224: return launch_mma<Rows, T, 224>(p, stream);
    case 256: return launch_mma<Rows, T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Rows>
int launch_fma(const Params& p, cudaStream_t stream) {
  if (!aligned16(p.acc)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = fma_smem_bytes(p.H / p.KV, p.hd);
  const int e = attn::allow_smem(fma_split_kernel<Rows>, smem);
  if (e) return e;
  const dim3 grid(p.n_splits, p.KV, p.B);
  fma_split_kernel<Rows><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  p.R (a multiple of 64)
// cuts each request's T_len rows into p.n_splits = ceil(T_len / R)
// splits.  Launches on `stream` and does not wait; returns the launch's
// cudaError_t (0 on success).
template <typename Rows>
int launch(const Params& p, int dtype, cudaStream_t stream) {
  if (p.R < kTile || p.R % kTile) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_fma<Rows>(p, stream);
    case 1: return launch_hd<Rows, __nv_bfloat16>(p, stream);
    case 2: return launch_hd<Rows, __half>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decode_split
