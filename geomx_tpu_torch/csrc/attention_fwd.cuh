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
// and 8 below (accumulator rows w = 0, 1).
__device__ __forceinline__ int my_row(int r0, int w) {
  return r0 + 16 * (threadIdx.x / 32) + threadIdx.x % 32 / 4 + 8 * w;
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

// The shared memory of fold_keys_wide, in floats: a chunk of Q, of a K
// tile and of a V^T tile, each P parts, and the bf16 staging
template <typename T>
constexpr int wide_fwd_floats() {
  return parts<T>() * (kRows + 2 * gx_wide::kTileRows) * gx_attn::kChunk +
         gx_wide::raw_floats<T, gx_wide::kTileRows>();
}

// fold_keys for a head above 128 (attention_wide.cuh): folds keys [0,
// kend) of head (b, h) into the state of the group of rows [q0, q0 + 64)
// for head elements [128 oc, 128 oc + 128) of o; each 16-key tile's scores
// over the whole head from wide_scores(), then its V^T chunk oc.  vec: the
// operands' alignment bits (gx_wide::vec_bits).
template <typename T>
__device__ __forceinline__ void fold_keys_wide(
    const GxSeqOperand& q, const GxSeqOperand& k, const GxSeqOperand& v,
    const GxAttnDims& dims, int b, int h, int q0, int oc, int vec, float* sm,
    float (&o)[gx_attn::kChunk / 2], float (&m)[2], float (&l)[2]) {
  constexpr int Bk = gx_wide::kTileRows, P = parts<T>();
  constexpr int C = gx_attn::kChunk;
  float* sq = sm;
  float* sk = sq + P * kRows * C;
  float* svt = sk + P * Bk * C;
  float* raw = svt + P * Bk * C;
  const int kend = dims.causal ? min(dims.Lk, q0 + kRows) : dims.Lk;
  for (int k0 = 0; k0 < kend; k0 += Bk) {
    float s[Bk / 2];
    // V^T chunk oc comes beside the scores' last chunk
    T* rv = gx_wide::raw_more<T, Bk>(raw);
    gx_wide::wide_scores<T, Bk>(
        q, q0, dims.Lq, vec & 1, k, k0, dims.Lk, vec & 2, b, h, dims.D / C,
        sq, sk, raw, s,
        [&] {
          gx_wide::stage_chunk<T, Bk, true>(v, b, h, k0, dims.Lk, oc * C,
                                            vec & 4, svt, rv, threadIdx.x);
        },
        [&] { gx_wide::finish_chunk<T, Bk, true>(svt, rv); });
    fold_tile<P, C, Bk>(s, svt, Bk * C, dims, k0, q0, o, m, l);
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
