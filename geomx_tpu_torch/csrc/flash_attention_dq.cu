// The flash backward's dq pass for Hopper, on the tensor cores: wgmma in
// split TF32 (3 TF32 products for each fp32 one), fp32 accumulators.
//
// Replaces geomx_tpu/ops/flash_attention.py flash_attention_bwd's
// _dq_kernel (pallas_call :339): for the query rows of a block,
//   s = (q k^T) scale, p = exp(s - lse) (0 where masked: keys past Lk,
//   the causal triangle), ds = p (dO v^T - delta), dq = sum_k ds k scale.
//
// Design.  A block is one warpgroup and owns 128 query rows of one (b, h)
// (64 for head dims above 16): their Q and dO rows stay in shared memory,
// split hi/lo, and each thread keeps the lse and delta of its rows.  It
// walks the key tiles of kBk rows (64; 32 and 16 for head dims 64 and
// 128), staged by cp.async one tile ahead and split once into K, V (the B
// operands of the score products, as they are) and K^T (the B operand of
// dS K, depth permuted, attention_mma.cuh); then, for each group of 64
// rows,
//   S = Q K^T, dP = dO V^T   (wgmma SS, M 64 queries, N kBk, depth D)
//   P, dS in the accumulators (exp2 of one FFMA; masks only on ragged and
//                              diagonal tiles)
//   dQ += dS K               (wgmma RS: dS as register A fragments, M 64,
//                              N D, depth kBk; a tile's sum added to the
//                              fp32 total in round-to-nearest).
// Every product is hi hi + hi lo + lo hi for fp32 inputs; for bf16 inputs
// (exact in TF32) S and dP take one product and dS K two.  No atomics:
// each dq element is summed by one warpgroup in a fixed order, so a call
// gives the same bits every time.
//
// Bound: operations.  At seq_flash's shape (B 16, L 4096, H 4, D 16) the
// three products are 6 B H L^2 D = 103 GFLOP, 309 GFLOP of TF32 with the
// split: 625 us at the card's 495 TFLOP/s; the 1.07 G exponentials take
// 257 us of the MUFU unit; the bytes take 10 us.  As for dk/dv (see
// flash_attention_dkv.cu) the score products from two shared operands
// also fill the shared-memory port.
#include "attention.cuh"  // dims_ok and the dispatch
#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace {

using namespace gx_mma;

// key rows a stage (64, fewer for wide heads) and the 64-row groups a
// block owns (two for narrow heads: each staged key tile then serves 128
// query rows, which halves the copies and splits a row pays for)
__host__ __device__ constexpr int dq_rows(int D) {
  return D <= 32 ? 64 : (D == 64 ? 32 : 16);
}
__host__ __device__ constexpr int dq_groups(int D) {
  return D <= 16 ? 2 : 1;
}

// the shared memory of one block, in floats
template <typename T, int D>
struct DqSmem {
  static constexpr int kBk = dq_rows(D), kG = dq_groups(D);
  static constexpr int kP = parts<T>();
  static constexpr int kFixed = kP * kG * kRows * D;  // Q or dO, all parts
  static constexpr int kOp = kP * kBk * D;  // one layout of K or V
  static constexpr int kRaw = kBk * D * sizeof(T) / 4;  // a staged tile
  static constexpr int kQ = 0, kDO = kFixed, kKn = 2 * kFixed,
                       kKt = kKn + kOp, kVn = kKt + kOp,
                       kRawAt = kVn + kOp,  // [stage][k, v]
                       kEnd = kRawAt + 4 * kRaw;
  static constexpr int kBytes = kEnd * 4;
  static_assert(kBytes <= 227 * 1024, "dq tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                GxSeqOperand dout, const float* __restrict__ lse,
                const float* __restrict__ delta, GxAttnDims dims, int async16,
                float* __restrict__ dq) {
  using S = DqSmem<T, D>;
  constexpr int Bk = S::kBk, G = S::kG, P = S::kP, NB = Bk / 8;
  constexpr int kRowsAll = G * kRows;  // query rows a block owns
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRowsAll;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            tq = threadIdx.x % 4;
  T* raw = reinterpret_cast<T*>(sm + S::kRawAt);
  // causal: keys past the block's last row are in every row's future
  const int kend = dims.causal ? min(dims.Lk, q0 + kRowsAll) : dims.Lk;
  const int ntiles = (kend + Bk - 1) / Bk;
  // tile t's rows of K and V into raw stage t % 2
  auto stage = [&](int t) {
    const int k0 = t * Bk, st = t & 1;
    stage_rows<T, D, Bk>(k, b, h, k0, dims.Lk, async16,
                         raw + 2 * st * Bk * D);
    stage_rows<T, D, Bk>(v, b, h, k0, dims.Lk, async16,
                         raw + (2 * st + 1) * Bk * D);
  };
  if (ntiles > 0) stage(0);
  cp_async_commit();
  load_fixed<T, D, kRowsAll>(q, b, h, q0, dims.Lq, sm + S::kQ,
                             sm + S::kQ + kRowsAll * D);
  load_fixed<T, D, kRowsAll>(dout, b, h, q0, dims.Lq, sm + S::kDO,
                             sm + S::kDO + kRowsAll * D);
  // the thread's rows of each group: 16 warp + g and 8 below
  float lse2[G][2], dlt[G][2];
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int row = q0 + u * kRows + 16 * warp + g + 8 * w;
      const long long r = static_cast<long long>(bh) * dims.Lq + row;
      lse2[u][w] = row < dims.Lq ? lse[r] * kLog2e : 0.f;
      dlt[u][w] = row < dims.Lq ? delta[r] : 0.f;
    }
  }

  float acc[G][D / 2];
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[u][e] = 0.f;
  }
  const float c = dims.scale * kLog2e;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * Bk, st = t & 1;
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    convert<T, D, Bk>(raw + 2 * st * Bk * D, sm + S::kKn, sm + S::kKt);
    convert<T, D, Bk>(raw + (2 * st + 1) * Bk * D, sm + S::kVn, nullptr);
    fence_async_smem();
    __syncthreads();

#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int r0 = q0 + u * kRows;  // this group's first row
      // S = Q K^T and dP = dO V^T: [64 queries][Bk keys]
      float s[Bk / 2], dp[Bk / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float* qj = sm + S::kQ + u * kRows * D + j * 64;
        const float* oj = sm + S::kDO + u * kRows * D + j * 64;
        const float* kj = sm + S::kKn + j * 64;
        const float* vj = sm + S::kVn + j * 64;
        Wgmma<Bk>::ss(s, desc(qj, D), desc(kj, D), j > 0);
        Wgmma<Bk>::ss(dp, desc(oj, D), desc(vj, D), j > 0);
        if (P == 2) {
          Wgmma<Bk>::ss(s, desc(qj, D), desc(kj + Bk * D, D), 1);
          Wgmma<Bk>::ss(s, desc(qj + kRowsAll * D, D), desc(kj, D), 1);
          Wgmma<Bk>::ss(dp, desc(oj, D), desc(vj + Bk * D, D), 1);
          Wgmma<Bk>::ss(dp, desc(oj + kRowsAll * D, D), desc(vj, D), 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(s);
      reg_fence(dp);

      // dS in place of dP; accumulator e is (query row, key column)
      const bool whole = k0 + Bk <= dims.Lk &&
                         (!dims.causal || k0 + Bk - 1 <= r0);
#pragma unroll
      for (int e = 0; e < Bk / 2; ++e) {
        const int w = (e >> 1) & 1;
        float p = ex2(fmaf(s[e], c, -lse2[u][w]));
        if (!whole) {
          const int col = k0 + 8 * (e >> 2) + 2 * tq + (e & 1),
                    row = r0 + 16 * warp + g + 8 * w;
          if (col >= dims.Lk || (dims.causal && col > row)) p = 0.f;
        }
        dp[e] = p * (dp[e] - dlt[u][w]);
      }
      uint32_t dh[NB][4], dl[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i) a_frag(dp, i, dh[i], dl[i]);

      // this tile's dS K: depth Bk (slot order), N = D
      float tq_[D / 2];
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float* ki = sm + S::kKt + i * 64;
        Wgmma<D>::rs(tq_, dh[i], desc(ki, Bk), i > 0);
        Wgmma<D>::rs(tq_, dl[i], desc(ki, Bk), 1);
        if (P == 2) Wgmma<D>::rs(tq_, dh[i], desc(ki + Bk * D, Bk), 1);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(tq_);
      // a tile's (truncated) tensor-core sum, added in round-to-nearest
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[u][e] += tq_[e];
    }
    __syncthreads();  // the operand tiles are rewritten next tile
  }

  // accumulator e of dQ is (query row, head element)
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int row = q0 + u * kRows + 16 * warp + g + (e & 2) * 4;
      if (row >= dims.Lq) continue;
      const long long off =
          (static_cast<long long>(b) * dims.Lq + row) * dims.H * D +
          static_cast<long long>(h) * D + 8 * (e >> 2) + 2 * tq;
      *reinterpret_cast<float2*>(dq + off) =
          make_float2(acc[u][e] * dims.scale, acc[u][e + 1] * dims.scale);
    }
  }
}

template <typename T, int D>
int launch_dq(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
              GxSeqOperand dout, const float* lse, const float* delta,
              GxAttnDims dims, float* dq, cudaStream_t stream) {
  constexpr int bytes = DqSmem<T, D>::kBytes;
  const int err = allow_smem(flash_dq_kernel<T, D>, bytes);
  if (err != 0) return err;
  const int async16 = aligned16<T>(k) && aligned16<T>(v);
  constexpr int rows = dq_groups(D) * kRows;
  const dim3 grid((dims.Lq + rows - 1) / rows, dims.B * dims.H);
  flash_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dims, async16, dq);
  return static_cast<int>(cudaGetLastError());
}

// Head dims above 128 (attention_wide.cuh): block (x, bh, z) owns 64
// query rows and head elements [256 z, 256 z + 256) of their dq (two
// output chunks).  Its Q and dO rows stay in shared memory, raw, for the
// whole walk over the key tiles (resident_walk): warpgroup 0 keeps Q and
// computes S = Q K^T, warpgroup 1 keeps dO and computes dP = dO V^T, each
// over the whole head with its fixed rows as register A fragments; they
// trade the scores, both form dS, and warpgroup j sums dQ_j += dS K_j for
// output chunk j.  The first version re-staged Q and dO, chunk by chunk,
// for every 16-key tile (128 of the 168 KB a tile staged) and recomputed
// the scores for each output chunk: 161 ms at D = 256 on the H100
// against a 10.0 ms bound; this one takes 52 ms.  What bounds it now is
// issue, as for dk/dv (flash_attention_dkv.cu), one 192 KB block an SM.
template <typename T, bool kAll>
__global__ void __launch_bounds__(gx_wide::kWalkThreads, 1)
flash_dq_wide_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                     GxSeqOperand dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, GxAttnDims dims,
                     int vec, float* __restrict__ dq) {
  constexpr int C = gx_attn::kChunk, Bk = gx_wide::kTileRows;
  constexpr int P = parts<T>(), NB = Bk / 8, G = gx_wide::kOutChunks;
  constexpr int Ch = C / 2;  // head elements a half of an output chunk
  constexpr int kTr = gx_wide::WalkSmem<T, 1>::kTr;
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows, oc0 = G * blockIdx.z;
  const int nc = dims.D / C;
  // warpgroup w: S (Q resident) or dP (dO resident), then output chunk
  // oc0 + w of dq
  const int w = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  float lse2[2], dlt[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = q0 + 16 * warp + g + 8 * u;
    const long long r = static_cast<long long>(bh) * dims.Lq + row;
    lse2[u] = row < dims.Lq ? lse[r] * kLog2e : 0.f;
    dlt[u] = row < dims.Lq ? delta[r] : 0.f;
  }
  float acc[C / 2];
#pragma unroll
  for (int e = 0; e < C / 2; ++e) acc[e] = 0.f;
  const float c = dims.scale * kLog2e;
  const int kend = dims.causal ? min(dims.Lk, q0 + kRows) : dims.Lk;
  auto grad = [&](int k0, float (&s)[Bk / 2], float (&dp)[Bk / 2],
                  const float* trs, const float*) {
    const bool whole = k0 + Bk <= dims.Lk &&
                       (!dims.causal || k0 + Bk - 1 <= q0);
#pragma unroll
    for (int e = 0; e < Bk / 2; ++e) {
      const int u = (e >> 1) & 1;
      float p = ex2(fmaf(s[e], c, -lse2[u]));
      if (!whole) {
        const int col = k0 + 8 * (e >> 2) + 2 * tq + (e & 1),
                  row = q0 + 16 * warp + g + 8 * u;
        if (col >= dims.Lk || (dims.causal && col > row)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dlt[u]);
    }
    // this tile's dS K_w: depth Bk (slot order), summed into acc in
    // round-to-nearest
    uint32_t dh[NB][4], dl[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) a_frag(dp, i, dh[i], dl[i]);
    // K^T_w in its two halves of 64 head elements: accumulator e of half
    // u is element 32 u + e of the chunk's
    const float* kt = trs + w * kTr;
    float t[2][Ch / 2];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float* ki = kt + u * P * Bk * Ch + i * 64;
        Wgmma<Ch>::rs(t[u], dh[i], desc(ki, Bk), i > 0);
        Wgmma<Ch>::rs(t[u], dl[i], desc(ki, Bk), 1);
        if (P == 2) Wgmma<Ch>::rs(t[u], dh[i], desc(ki + Bk * Ch, Bk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      reg_fence(t[u]);
#pragma unroll
      for (int e = 0; e < Ch / 2; ++e) acc[Ch / 2 * u + e] += t[u][e];
    }
  };
  gx_wide::resident_walk<T, kAll, 1>(
      q, dout, q0, dims.Lq, k, v, vec & 2, vec & 4, 0, (kend + Bk - 1) / Bk,
      dims.Lk, b, h, nc, oc0, sm, [](int, float*, bool) {}, grad);

  // accumulator e is (query row, head element)
  if (oc0 + w >= nc) return;
#pragma unroll
  for (int e = 0; e < C / 2; e += 2) {
    const int row = q0 + 16 * warp + g + (e & 2) * 4;
    if (row >= dims.Lq) continue;
    *reinterpret_cast<float2*>(
        dq + gx_wide::chunk_offset(dims, dims.Lq, b, h, row, oc0 + w, e)) =
        make_float2(acc[e] * dims.scale, acc[e + 1] * dims.scale);
  }
}

template <typename T>
int launch_dq_wide(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                   GxSeqOperand dout, const float* lse, const float* delta,
                   GxAttnDims dims, float* dq, cudaStream_t stream) {
  const int nc = dims.D / gx_attn::kChunk;
  const bool all = nc <= gx_wide::max_resident<T>();
  const int bytes = gx_wide::WalkSmem<T, 1>::bytes(
      all ? nc : gx_wide::max_resident<T>());
  auto kernel = all ? flash_dq_wide_kernel<T, true>
                    : flash_dq_wide_kernel<T, false>;
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  constexpr int G = gx_wide::kOutChunks;
  const dim3 grid((dims.Lq + kRows - 1) / kRows, dims.B * dims.H,
                  (nc + G - 1) / G);
  kernel<<<grid, gx_wide::kWalkThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dims, gx_wide::vec_bits<T>(q, k, v, &dout),
      dq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_flash_bwd_dq(GxSeqOperand q, GxSeqOperand k,
                               GxSeqOperand v, GxSeqOperand dout,
                               const float* lse, const float* delta,
                               GxAttnDims dims, float* dq,
                               cudaStream_t stream) {
  if (!gx_attn::dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  if (dims.B == 0 || dims.Lq == 0) return 0;
  GX_ATTN_DISPATCH(launch_dq, launch_dq_wide, q, k, v, dout, lse, delta, dims,
                   dq, stream)
}
