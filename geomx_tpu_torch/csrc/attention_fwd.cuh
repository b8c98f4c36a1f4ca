// The online-softmax tile body of the flash forward (flash_attention.cu)
// and the ring hop (ring_hop.cu) on Hopper's tensor cores: split-TF32
// wgmma (attention_mma.cuh), fp32 accumulators.
//
// fold_keys() walks a block's key tiles and folds each into the state
// (m, l, o) of the G groups of 64 query rows the block owns, as the Pallas
// kernels fold a key tile (geomx_tpu/ops/flash_attention.py _fa_kernel,
// geomx_tpu/parallel/_fused_block.py _hop_kernel's _accumulate):
//   s = scale q k^T, -1e30 where masked (keys past Lk; under causal or
//   diag, col > row); m_new = max(m, max(-1e30, rowmax s)); p = exp(s -
//   m_new), set to 0 where masked (a row masked so far has m_new = -1e30,
//   where exp would give 1); corr = exp(m - m_new) (0, never NaN, for a
//   hop's first m = -inf); l = l corr + sum p; o = o corr + p V.
// The two kernels differ only at the ends: the forward starts from
// (-1e30, 0, 0) and normalises, the hop loads its carries and stores them
// back.
//
// K and V stream through shared memory two stages deep: fp32 tiles land
// by cp.async straight in their operand layouts (V transposed by 4-byte
// copies) and are split hi/lo in place once for all groups; Q stays in
// shared memory, split once.  For each staged tile and each group of 64
// rows:
//   S = Q K^T     wgmma SS, M 64 queries, N kBk keys, depth D (K as it
//                 lies: the head dim contiguous is K-major);
//   P             in the accumulators: row max and (per lane) row sum over
//                 the four lanes of an accumulator quad, exponentials by
//                 ex2 of one FFMA on log2(e)-prescaled scores; masks only
//                 on ragged and diagonal tiles;
//   O_t = P V     wgmma RS, M 64, N D, depth kBk: P as register A
//                 fragments (the slot permutation, no shuffle), split
//                 hi/lo; V^T with its key index in slot order;
//   o = o corr + O_t   in round-to-nearest (the tensor cores' sums
//                 truncate: summed in o, the error would grow with Lk).
// l stays a per-lane partial sum (corr scales every lane's alike) until
// the ends add the quad's four.  Every product is hi hi + hi lo + lo hi
// for fp32 inputs; bf16 inputs are exact in TF32, so S takes one product
// and P V two.  Each output element is summed by one warpgroup in a fixed
// order: a call gives the same bits every time.
//
// Q stays in shared memory rather than in register fragments, and the
// groups run one after another rather than pipelined (the next group's S
// issued under this one's softmax): both alternatives cost registers and
// so blocks an SM, and measured slower on the H100 (PERF.md).
//
// Head dims above 128 (fold_keys_wide, attention_wide.cuh): a block is two
// warpgroups, one 64-row group and two 128-wide output chunks, one a
// warpgroup.  Warpgroup w keeps depth half w of Q resident, raw, and
// streams the same half of each 32-key tile of K, 64 head elements a
// step, three stages deep, each thread splitting the next step's chunks it
// copied under this step's products; its partial S comes from RS products
// (A fragments split in registers).  The two trade their partial S through
// shared memory once a tile and add them in one order, so both hold the
// same bits of S, m, l and P; each then folds the tile into its output
// chunk with fold_tile(), from the tile's V^T for that chunk, which lands
// as it lies beside the K steps and is transposed and split at the tile's
// end.  What bounds it is latency: one block of 8 warps an SM, each phase
// a chain of dependent instructions (PERF.md).
#pragma once

#include <math.h>

#include "attention.cuh"
#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace gx_fwd {

using namespace gx_mma;
using gx_attn::kNegInf;

// key rows a stage: the registers of the score tile and of P's fragments
// shrink as the head widens (and so do the shared K and V^T tiles)
__host__ __device__ constexpr int fwd_keys(int D) {
  return D <= 32 ? 64 : (D == 64 ? 32 : 16);
}

// the shared memory of one block of G groups, in floats: Q (hi, lo), then
// two stages of the operand tiles [K hi | V^T hi | K lo | V^T lo] (fp32
// inputs land there by cp.async and are split in place; bf16 ones land in
// the raw tiles behind and are converted)
template <typename T, int D, int G>
struct FwdSmem {
  static constexpr int kBk = fwd_keys(D), kP = parts<T>();
  static constexpr int kQ = 0;
  static constexpr int kTile = kBk * D;               // one part of K or V^T
  static constexpr int kLo = 2 * kTile;               // hi to lo
  static constexpr int kOps = kP * G * kRows * D;     // stage 0
  static constexpr int kStage = 2 * kP * kTile;       // stage to stage
  static constexpr int kRawAt = kOps + 2 * kStage;    // bf16: [stage][k, v]
  static constexpr int kEnd = kRawAt + (sizeof(T) == 4 ? 0 : kTile);
  static constexpr int kBytes = kEnd * 4;
  static_assert(kBytes <= 227 * 1024, "forward tiles exceed shared memory");
};

// Starts the copies of rows [k0, k0 + Bk) of head (b, h) of fp32 K and V
// straight into their operand layouts at op: K as it lies (K-major), V
// transposed with its key index in slot order (4-byte copies); zeros past
// Lk.  K's 16-byte copies fall back to plain loads where K is not 16-byte
// aligned.
template <int D, int Bk>
__device__ __forceinline__ void stage_kv(const GxSeqOperand& k,
                                         const GxSeqOperand& v, int b, int h,
                                         int k0, int Lk, bool async16,
                                         float* op) {
  static_assert(Bk * D % (4 * kThreads) == 0, "a tile is whole chunks");
#pragma unroll
  for (int n = 0; n < Bk * D / 4 / kThreads; ++n) {
    const unsigned i = threadIdx.x + n * kThreads;
    const int r = i / (D / 4), c = i % (D / 4);
    const bool live = k0 + r < Lk;
    const float* src = live ? row_ptr<float>(k, b, k0 + r, h) + 4 * c
                            : static_cast<const float*>(k.ptr);
    float* dst = op + kmaj(r, 4 * c, D);
    if (async16) {
      cp_async16(dst, src, live);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = live ? src[e] : 0.f;
    }
  }
#pragma unroll
  for (int n = 0; n < Bk * D / kThreads; ++n) {
    const unsigned i = threadIdx.x + n * kThreads;
    const int r = i / D, d = i % D;
    const bool live = k0 + r < Lk;
    cp_async4(op + Bk * D + kmaj(d, slot(r), Bk),
              live ? row_ptr<float>(v, b, k0 + r, h) + d
                   : static_cast<const float*>(v.ptr),
              live);
  }
}

// The query rows of this thread in a group starting at r0: 16 warp + g
// and 8 below (accumulator rows w = 0, 1), warp in the thread's warpgroup.
__device__ __forceinline__ int my_row(int r0, int w) {
  const int tid = threadIdx.x % kThreads;  // in its warpgroup
  return r0 + 16 * (tid / 32) + tid % 32 / 4 + 8 * w;
}

// Folds one tile's scores s (accumulator layout; unscaled q k^T, keys [k0,
// k0 + Bk) of the group of rows [r0, r0 + 64)) into the state (o, m, l):
// the masks, the online softmax, and this tile's P V from V^T (depth Bk
// in slot order, N = Dv) with its hi part at vt and its lo part at vt +
// vlo.
template <int P, int Dv, int Bk>
__device__ __forceinline__ void fold_tile(float (&s)[Bk / 2], const float* vt,
                                          int vlo, const GxAttnDims& dims,
                                          int k0, int r0, float (&o)[Dv / 2],
                                          float (&m)[2], float (&l)[2]) {
  constexpr int NB = Bk / 8;
  const int t4 = threadIdx.x % 4;
  const float c = dims.scale * kLog2e;
  // the rows' maxima over the live scores; a masked score is -inf
  // here and its p is set to 0 below
  const bool whole = k0 + Bk <= dims.Lk &&
                     (!dims.causal || k0 + Bk - 1 <= r0);
  if (!whole) {
#pragma unroll
    for (int e = 0; e < Bk / 2; ++e) {
      const int col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
      if (col >= dims.Lk ||
          (dims.causal && col > my_row(r0, (e >> 1) & 1))) {
        s[e] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < Bk / 2; ++e) {
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  }
  float corr[2], mb[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    mx[w] = fmaxf(mx[w], __shfl_xor_sync(0xffffffffu, mx[w], 1));
    mx[w] = fmaxf(mx[w], __shfl_xor_sync(0xffffffffu, mx[w], 2));
    // the tile's running max starts at the sentinel
    const float m_new = fmaxf(m[w], fmaxf(mx[w] * dims.scale, kNegInf));
    corr[w] = ex2((m[w] - m_new) * kLog2e);
    mb[w] = m_new * kLog2e;
    m[w] = m_new;
  }
  if (whole) {
#pragma unroll
    for (int e = 0; e < Bk / 2; ++e) {
      s[e] = ex2(fmaf(s[e], c, -mb[(e >> 1) & 1]));
      psum[(e >> 1) & 1] += s[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < Bk / 2; ++e) {
      const float p = ex2(fmaf(s[e], c, -mb[(e >> 1) & 1]));
      s[e] = s[e] == -INFINITY ? 0.f : p;
      psum[(e >> 1) & 1] += s[e];
    }
  }
#pragma unroll
  for (int w = 0; w < 2; ++w) l[w] = fmaf(l[w], corr[w], psum[w]);

  // this tile's P V: depth Bk (slot order), N = Dv
  uint32_t ph[NB][4], pl[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) a_frag(s, i, ph[i], pl[i]);
  float ot[Dv / 2];
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float* vi = vt + i * 64;
    Wgmma<Dv>::rs(ot, ph[i], desc(vi, Bk), i > 0);
    Wgmma<Dv>::rs(ot, pl[i], desc(vi, Bk), 1);
    if (P == 2) Wgmma<Dv>::rs(ot, ph[i], desc(vi + vlo, Bk), 1);
  }
  wgmma_commit();
  wgmma_wait();
  reg_fence(ot);
  // the tile's (truncated) tensor-core sum, added in round-to-nearest
#pragma unroll
  for (int e = 0; e < Dv / 2; ++e) {
    o[e] = fmaf(o[e], corr[(e >> 1) & 1], ot[e]);
  }
}

// Folds keys [0, kend) of head (b, h) into the state of the G groups of
// rows [q0, q0 + 64 G): o (accumulator layout: element e is row w = (e >>
// 1) & 1, column 8 (e >> 2) + 2 t + (e & 1)), m in natural-log units,
// l this lane's partial row sums.  Under causal, keys past a group's last
// row are in all its rows' future: those tiles are skipped, the diagonal
// ones masked element by element.
template <typename T, int D, int G>
__device__ __forceinline__ void fold_keys(
    const GxSeqOperand& q, const GxSeqOperand& k, const GxSeqOperand& v,
    const GxAttnDims& dims, int b, int h, int q0, int async16, float* sm,
    float (&o)[G][D / 2], float (&m)[G][2], float (&l)[G][2]) {
  using S = FwdSmem<T, D, G>;
  constexpr int Bk = S::kBk, P = S::kP;
  T* raw = reinterpret_cast<T*>(sm + S::kRawAt);
  const int kend = dims.causal ? min(dims.Lk, q0 + G * kRows) : dims.Lk;
  const int ntiles = (kend + Bk - 1) / Bk;
  // tile t's rows of K and V into stage t % 2
  auto stage = [&](int t) {
    const int k0 = t * Bk, st = t & 1;
    if constexpr (sizeof(T) == 4) {
      stage_kv<D, Bk>(k, v, b, h, k0, dims.Lk, async16,
                      sm + S::kOps + st * S::kStage);
    } else {
      stage_rows<T, D, Bk>(k, b, h, k0, dims.Lk, async16, raw);
      stage_rows<T, D, Bk>(v, b, h, k0, dims.Lk, async16, raw + Bk * D);
    }
  };
  if (ntiles > 0) stage(0);
  cp_async_commit();
  load_fixed<T, D, G * kRows>(q, b, h, q0, dims.Lq, sm + S::kQ,
                              sm + S::kQ + G * kRows * D);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * Bk;
    float* kt = sm + S::kOps + (t & 1) * S::kStage;  // K hi; V^T hi behind
    if constexpr (sizeof(T) == 4) {
      if (t + 1 < ntiles) stage(t + 1);
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
      split_tile<2 * Bk * D>(kt);
    } else {
      // bf16 (exact in TF32, no lo part): converted from the raw tiles,
      // whose next copy starts once they are read
      cp_async_wait_all();
      __syncthreads();
      convert<T, D, Bk>(raw, kt, nullptr);
      convert<T, D, Bk>(raw + Bk * D, nullptr, kt + Bk * D);
      __syncthreads();
      if (t + 1 < ntiles) stage(t + 1);
      cp_async_commit();
    }
    fence_async_smem();
    __syncthreads();

#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int r0 = q0 + u * kRows;  // this group's first row
      if (r0 >= dims.Lq || (dims.causal && k0 > r0 + kRows - 1)) continue;
      // S = Q K^T: [64 queries][Bk keys]
      float s[Bk / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float* kj = kt + j * 64;
        const float* qj = sm + S::kQ + u * kRows * D + j * 64;
        Wgmma<Bk>::ss(s, desc(qj, D), desc(kj, D), j > 0);
        if (P == 2) {
          Wgmma<Bk>::ss(s, desc(qj, D), desc(kj + S::kLo, D), 1);
          Wgmma<Bk>::ss(s, desc(qj + G * kRows * D, D), desc(kj, D), 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(s);

      fold_tile<P, D, Bk>(s, kt + Bk * D, S::kLo, dims, k0, r0, o[u], m[u],
                          l[u]);
    }
    __syncthreads();  // tile t + 2's copies rewrite this stage
  }
}

// key rows a tile of fold_keys_wide() (16 measured 25% slower at D = 256
// on the H100: m64n16k8 products run at half the tensor cores' rate), and
// the stages of its K steps
constexpr int kWideKeys = 32;
constexpr int kKStages = 3;

// The shared memory of fold_keys_wide(), in floats: Q's resident pieces (R
// a warpgroup, each 64 rows x 64 head elements, raw), kKStages stages x 2
// warpgroups of K steps ([N][64], P parts), a V^T tile a warpgroup ([128][N],
// P parts), and the bf16 staging of both
template <typename T>
struct WideFwdSmem {
  static constexpr int N = kWideKeys, KD = gx_wide::kStepDepth;
  static constexpr int kStep = parts<T>() * N * KD;
  static constexpr int kVt = parts<T>() * gx_attn::kChunk * N;
  static constexpr int kRawStep = sizeof(T) == 4 ? 0 : N * KD / 2;
  static constexpr int kRawVt = sizeof(T) == 4 ? 0 : N * gx_attn::kChunk / 2;
  static constexpr int kStream = 2 * kKStages * (kStep + kRawStep) +
                                 2 * (kVt + kRawVt);
  // one piece for both warpgroups
  static constexpr int kPiece = 2 * kRows * KD * sizeof(T) / 4;
  // the pieces a warpgroup keeps at most: the rest of 227 KB
  static constexpr int kMaxPieces = (227 * 1024 / 4 - kStream) / kPiece;
  static_assert(kMaxPieces >= 2, "D = 256 keeps Q resident");
  static constexpr int bytes(int R) { return (R * kPiece + kStream) * 4; }
};

// A warpgroup copies a tile of 32 rows of K or V (kWideKeys), KD head
// elements of each, a row a lane: lane l copies row l, 16-byte columns
// w + 4 n for its warp w (a phase's 8 accesses fill one 128-byte line of a
// K-major tile), and, for K, splits the same chunks once they have landed,
// so the split waits only on its own copies.  Every address is the
// thread's row and column base plus a constant.
template <typename T, int KD>
__host__ __device__ constexpr int row_chunks() {
  return KD * static_cast<int>(sizeof(T)) / 16 / 4;
}

// Starts the copies of the thread's chunks of its row, whose head
// elements of the tile start at src (live: the row is below the sequence
// end; else zeros): fp32 into op's hi part as K-major, bf16 into raw (the
// thread's chunk n at tid + 128 n); 16-byte cp.async where the operand is
// 16-byte aligned, plain loads otherwise.
template <typename T, int KD>
__device__ __forceinline__ void stage_row(const T* src, bool live,
                                          bool async16, float* op, T* raw,
                                          int tid) {
  constexpr int E = 16 / sizeof(T);
  const int lane = tid % 32, warp = tid / 32;
  T* dst = sizeof(T) == 4
               ? reinterpret_cast<T*>(op + kmaj(lane, 4 * warp, KD))
               : raw + tid * E;
  constexpr int kDst = sizeof(T) == 4 ? 128 : kThreads * E;  // chunk to chunk
  src += warp * E;
  if (async16) {
#pragma unroll
    for (int n = 0; n < row_chunks<T, KD>(); ++n) {
      cp_async16(dst + n * kDst, src + 4 * n * E, live);
    }
  } else {
#pragma unroll
    for (int n = 0; n < row_chunks<T, KD>(); ++n) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dst[n * kDst + e] = live ? src[4 * n * E + e] : T();
      }
    }
  }
}

// Splits chunk n of the thread's K chunks once it has landed: fp32 in
// place (hi, lo N KD floats behind), bf16 converted from raw into op
template <typename T, int N, int KD>
__device__ __forceinline__ void split_row(float* op, const T* raw, int tid,
                                          int n) {
  const int lane = tid % 32, warp = tid / 32;
  if constexpr (sizeof(T) == 4) {
    const int at = kmaj(lane, 4 * warp, KD) + 128 * n;
    const float4 v = *reinterpret_cast<const float4*>(op + at);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
    split4<2>(x, hi, lo);
    store4<2>(hi, lo, op, op + N * KD, at);
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(raw)[tid + kThreads * n];
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    const int at = kmaj(lane, 8 * warp, KD) + 256 * n;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w4[2 * q]));
      const float2 e = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w4[2 * q + 1]));
      *reinterpret_cast<float4*>(op + at + 32 * q) =
          make_float4(a.x, a.y, e.x, e.y);
    }
  }
}

// A V tile of N keys, 128 head elements, lands as it lies (stage_row()):
// fp32 into the lo part of its V^T tile ([N][128] K-major; 4-byte copies
// straight into the transposed layout measured slower on the H100), bf16
// into raw.  vt_load() reads a thread's share of it into x, vt_store()
// writes that share transposed ([128][N], the keys as depth in slot()
// order) and split into the hi and lo parts: stored only once every thread
// of the warpgroup has read, as the lo part is rewritten.
template <int N>
__host__ __device__ constexpr int vt_groups() {
  return N * gx_attn::kChunk / 4 / kThreads;
}

// Thread tid's share: groups n = 0 .. 7 of 4 head elements, row (key) 8 (n
// / 2) + tid % 8, head elements 4 (tid / 8) + 64 (n % 2) on: the
// addresses are the thread's first plus constants.
template <typename T, int N>
__device__ __forceinline__ void vt_load(const float* vt, const T* raw, int tid,
                                        float (&x)[vt_groups<N>()][4]) {
  static_assert(N == 32 && vt_groups<N>() == 8, "a row a lane");
  constexpr int C = gx_attn::kChunk;
  const int r = tid % 8, g = tid / 8;
#pragma unroll
  for (int n = 0; n < vt_groups<N>(); ++n) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(
          vt + C * N + kmaj(r, 4 * g, C) + 1024 * (n / 2) + 512 * (n % 2));
      x[n][0] = v.x, x[n][1] = v.y, x[n][2] = v.z, x[n][3] = v.w;
    } else {
      // 16-byte chunk g / 2 of row r is the copying thread's (stage_row())
      const uint2 p = reinterpret_cast<const uint2*>(
          raw)[2 * (g / 2 * 32 + r) + g % 2 + 512 * (n % 2) + 16 * (n / 2)];
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&p.x));
      const float2 e = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&p.y));
      x[n][0] = a.x, x[n][1] = a.y, x[n][2] = e.x, x[n][3] = e.y;
    }
  }
}

// vt_store() stores as convert_group() does, each lane starting at
// another of its 4 elements (rot) so that a warp's 32 stores meet 32
// banks, but rotates the 4 values before the split rather than its 8
// parts after it.
template <typename T, int N>
__device__ __forceinline__ void vt_store(float* vt, int tid,
                                         const float (&x)[vt_groups<N>()][4]) {
  constexpr int C = gx_attn::kChunk, P = parts<T>();
  const int rot = lane_rot();
  const int base = kmaj(4 * (tid / 8), slot(tid % 8), N);
  int off[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) off[c] = base + 4 * ((c + rot) & 3);
#pragma unroll
  for (int n = 0; n < vt_groups<N>(); ++n) {
    float a[4], y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = rot & 1 ? x[n][(c + 1) & 3] : x[n][c];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = rot & 2 ? a[(c + 2) & 3] : a[c];
    uint32_t hi[4], lo[4];
    split4<P>(y, hi, lo);
    // head elements + 64 (n % 2), keys + 8 (n / 2)
    const int at = 64 * N * (n % 2) + 64 * (n / 2);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      vt[off[c] + at] = __uint_as_float(hi[c]);
      if (P == 2) vt[N * C + off[c] + at] = __uint_as_float(lo[c]);
    }
  }
}

// fold_keys for a head above 128 (attention_wide.cuh), by two warpgroups:
// folds keys [0, kend) of head (b, h) into the state of the group of rows
// [q0, q0 + 64) for head elements [128 oc, 128 oc + 128) of o, oc = oc0 +
// w for warpgroup w (past the last chunk, a copy of the last, which the
// caller does not store).  Warpgroup w keeps head elements [w D / 2, (w +
// 1) D / 2) of the rows of Q, R pieces of 64 in shared memory (all when
// kAll, else the rest from L2), and streams the same elements of each
// N-key tile of K, 64 a step, kKStages deep: under each step's products
// every thread splits its own chunks of the next step, which have landed.
// Its partial S sums the steps in round-to-nearest.  The V tile of chunk
// oc is copied from the tile's first step on (the previous tile's P V
// done) and transposed and split at its end.  vec: the operands'
// alignment bits (gx_wide::vec_bits).
template <typename T, bool kAll>
__device__ __forceinline__ void fold_keys_wide(
    const GxSeqOperand& q, const GxSeqOperand& k, const GxSeqOperand& v,
    const GxAttnDims& dims, int b, int h, int q0, int oc0, int vec, float* sm,
    float (&o)[gx_attn::kChunk / 2], float (&m)[2], float (&l)[2]) {
  using S = WideFwdSmem<T>;
  constexpr int N = S::N, KD = S::KD, C = gx_attn::kChunk, P = parts<T>();
  constexpr int kChunks = row_chunks<T, KD>(), kPairs = KD / 16;
  static_assert(N == 32, "a row a lane");
  const int w = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int nc = dims.D / C;  // also the steps a warpgroup takes a tile
  const int half = w * (dims.D / 2);
  // by value: a reference to one of two operands would put them on the
  // stack
  const GxSeqOperand qw{static_cast<const T*>(q.ptr) + half, q.sb, q.sl, q.sh};
  const GxSeqOperand kw{static_cast<const T*>(k.ptr) + half, k.sb, k.sl, k.sh};
  const int oc = min(oc0 + w, nc - 1);
  const int R = kAll ? nc : S::kMaxPieces, W = R * KD;
  T* res = reinterpret_cast<T*>(sm) + w * kRows * W;
  float* stg = sm + R * S::kPiece;  // [stage][warpgroup]
  float* vt = stg + 2 * kKStages * S::kStep + w * S::kVt;
  T* rawk = reinterpret_cast<T*>(stg + 2 * kKStages * S::kStep + 2 * S::kVt);
  T* rawv = rawk + 2 * kKStages * N * KD + w * N * C;
  const int kend = dims.causal ? min(dims.Lk, q0 + kRows) : dims.Lk;
  const int ntiles = (kend + N - 1) / N, steps = ntiles * nc;
  // the thread's rows of K (its half) and V (chunk oc): row `lane` of each
  // tile
  const int lane = tid % 32;
  const T* krow = static_cast<const T*>(kw.ptr) + b * k.sb + h * k.sh +
                  lane * k.sl;
  const T* vrow = static_cast<const T*>(v.ptr) + b * v.sb + h * v.sh +
                  oc * C + lane * v.sl;
  // step (tile t, head elements [KD u, KD u + KD) of the half) into stage
  // step % kKStages
  auto at = [&](int step) { return 2 * (step % kKStages) + w; };
  auto stage = [&](int step) {
    const int t = step / nc, u = step - t * nc;
    const bool live = t * N + lane < dims.Lk;
    stage_row<T, KD>(live ? krow + t * N * k.sl + u * KD
                          : static_cast<const T*>(k.ptr),
                     live, vec & 2, stg + at(step) * S::kStep,
                     rawk + at(step) * N * KD, tid);
  };
  auto stage_v = [&](int t) {
    const bool live = t * N + lane < dims.Lk;
    stage_row<T, C>(live ? vrow + t * N * v.sl : static_cast<const T*>(v.ptr),
                    live, vec & 4, vt + C * N, rawv, tid);
  };
  // One commit group a step, step s's copies in the s-th (V's of tile t
  // in its first step's), the first kKStages here: when all but the newest
  // group have landed, the next step's have.
  for (int s = 0; s < kKStages; ++s) {
    if (s < steps) stage(s);
    if (s == 0 && steps > 0) stage_v(0);
    cp_async_commit();
  }
  gx_wide::load_resident<T>(qw, b, h, q0, dims.Lq, W, res, tid);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kKStages - 1) : "memory");
  if (steps > 0) {
#pragma unroll
    for (int n = 0; n < kChunks; ++n) {
      split_row<T, N, KD>(stg + w * S::kStep, rawk + w * N * KD, tid, n);
    }
  }
  fence_async_smem();
  __syncthreads();  // Q and step 0's split in place for every thread
  auto from_smem = [&](int r, int s, float (&x)[4]) {
    gx_wide::res_frag<T>(res, r, s, W, x);
  };
  auto from_l2 = [&](int r, int s, float (&x)[4]) {
    gx_wide::l2_frag<T>(qw, b, h, q0 + r, dims.Lq, s, x);
  };
  for (int t = 0, step = 0; t < ntiles; ++t) {
    const int k0 = t * N;
    float d[N / 2];
    for (int u = 0; u < nc; ++u, ++step) {
      const float* mine = stg + at(step) * S::kStep;
      // this thread's copies of step + 1 have landed: split them under
      // this step's products
      cp_async_wait_prior();
      float* nop = stg + at(step + 1) * S::kStep;
      const T* nraw = rawk + at(step + 1) * N * KD;
      const bool more = step + 1 < steps;
      auto side = [&](int sp) {
        if (more) {
#pragma unroll
          for (int n = sp; n < kChunks; n += kPairs) {
            split_row<T, N, KD>(nop, nraw, tid, n);
          }
        }
      };
      float e[N / 2];
      if constexpr (kAll) {
        gx_wide::step_scores<T, N, KD>(from_smem, u * (KD / 16), tid, mine,
                                       e, side);
      } else if (u < R) {
        gx_wide::step_scores<T, N, KD>(from_smem, u * (KD / 16), tid, mine,
                                       e, side);
      } else {
        gx_wide::step_scores<T, N, KD>(from_l2, u * (KD / 16), tid, mine, e,
                                       side);
      }
#pragma unroll
      for (int j = 0; j < N / 2; ++j) d[j] = u == 0 ? e[j] : d[j] + e[j];
      fence_async_smem();
      if (u + 1 < nc) {
        // step + 1's split in place for every thread, and no product
        // reads this step's stage any more; in a tile's first step, every
        // P V of the previous tile is done, so its V^T tile is free
        __syncthreads();
        if (step + kKStages < steps) stage(step + kKStages);
        if (u == 0 && t > 0) stage_v(t);
        cp_async_commit();
      }
    }
    // The partial scores traded through the V^T tiles' hi parts, which no
    // product reads until the transposed tile is stored; a + b is b + a,
    // so both warpgroups hold the same bits of S.  Tile t's V has landed
    // once every group (nc > 2: all but the newest) has.
#pragma unroll
    for (int j = 0; j < N / 2; ++j) vt[j * kThreads + tid] = d[j];
    if (nc > 2) {
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (step - 1 + kKStages < steps) stage(step - 1 + kKStages);
    cp_async_commit();
    const float* theirs = vt + (w ? -S::kVt : S::kVt);
    float s[N / 2], x[vt_groups<N>()][4];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) s[j] = d[j] + theirs[j * kThreads + tid];
    vt_load<T, N>(vt, rawv, tid, x);
    __syncthreads();  // every thread has read both V^T tiles
    vt_store<T, N>(vt, tid, x);
    fence_async_smem();
    // the warpgroup's V^T tile in place for its products
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kThreads) : "memory");
    fold_tile<P, C, N>(s, vt, C * N, dims, k0, q0, o, m, l);
  }
}

// the row sum of the quad's four partial sums, in a fixed order
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// float offset of accumulator element e of row `row` in a contiguous [B,
// L, H, D] tensor
template <int D>
__device__ __forceinline__ long long acc_offset(const GxAttnDims& dims,
                                                int b, int h, int row,
                                                int e) {
  return (static_cast<long long>(b) * dims.Lq + row) * dims.H * D +
         static_cast<long long>(h) * D + 8 * (e >> 2) + 2 * (threadIdx.x % 4);
}

}  // namespace gx_fwd
