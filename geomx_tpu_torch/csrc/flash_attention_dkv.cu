// The flash backward's dk/dv pass for Hopper, on the tensor cores: wgmma
// in split TF32 (3 TF32 products for each fp32 one), fp32 accumulators.
//
// Replaces geomx_tpu/ops/flash_attention.py flash_attention_bwd's
// _dkv_kernel (pallas_call :353): for the keys of a block,
//   s = (q k^T) scale, p = exp(s - lse) (0 where masked: queries past Lq,
//   the causal triangle), dp = dO v^T, ds = p (dp - delta),
//   dk = sum_q ds^T q scale, dv = sum_q p^T dO.
//
// Design.  A block is one warpgroup and owns 192 keys of one (b, h) (64
// for head dims above 16): their K and V rows stay in shared memory, split
// hi/lo.  It walks the query tiles of kBq rows (32 for head dims up to 16,
// 64, 32, 16 for 32, 64, 128), staged by cp.async one tile ahead and split
// once into Q, dO (the B operands of the score products, as they are) and
// Q^T, dO^T (the B operands of the gradient products, depth permuted,
// attention_mma.cuh); then, for each group of 64 keys,
//   S^T = K Q^T, dP^T = V dO^T     (wgmma SS, M 64 keys, N kBq, depth D)
//   P^T, dS^T in the accumulators  (exp2 of one FFMA: the scale and lse
//                                   folded with log2(e); masks only on
//                                   ragged and diagonal tiles)
//   dV += P^T dO, dK += dS^T Q     (wgmma RS: P^T, dS^T as register A
//                                   fragments, M 64, N D, depth kBq; a
//                                   tile's sum added to the fp32 total in
//                                   round-to-nearest, since the tensor
//                                   cores' own sums truncate).
// The staged tile's copy and split are the kernel's largest cost after
// the products, and three key groups share each.
// Every product is hi hi + hi lo + lo hi (fp32 inputs) or, for bf16
// inputs (exact in TF32), one product for S^T and dP^T and the two of the
// fp32 P^T and dS^T against the exact operand.  No atomics: each dk/dv
// element is summed by one warpgroup in a fixed order, so a call gives the
// same bits every time.
//
// Bound: operations.  At seq_flash's shape (B 16, L 4096, H 4, D 16) the
// four products are 8 B H L^2 D = 137 GFLOP, 412 GFLOP of TF32 with the
// split: 833 us at the card's 495 TFLOP/s; the B H L^2 = 1.07 G
// exponentials take 257 us of the MUFU unit (16 a clock an SM); the bytes
// (q, k, v, dO read, dk, dv written) take 12 us.  Shared memory feeds
// wgmma at 128 bytes a clock an SM, which a 64 x 64 x 8 TF32 product from
// two shared operands already uses in full; the conversion pass's stores
// share that port.
#include "attention.cuh"  // dims_ok and the dispatch
#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace {

using namespace gx_mma;

// query rows a stage and the 64-key groups a block owns: for narrow heads
// three groups share each staged query tile, which cuts the copies and
// splits a key pays for to a third; 32 rows keep the registers of three
// groups' accumulators without spills (on the H100 this measured faster
// than two groups of 64 rows)
__host__ __device__ constexpr int dkv_rows(int D) {
  return D <= 16 ? 32 : (D <= 32 ? 64 : (D == 64 ? 32 : 16));
}
__host__ __device__ constexpr int dkv_groups(int D) {
  return D <= 16 ? 3 : 1;
}

// the shared memory of one block, in floats
template <typename T, int D>
struct DkvSmem {
  static constexpr int kBq = dkv_rows(D), kG = dkv_groups(D);
  static constexpr int kP = parts<T>();
  static constexpr int kFixed = kP * kG * kRows * D;  // K or V, all parts
  static constexpr int kOp = kP * kBq * D;  // one layout of Q or dO
  static constexpr int kRaw = kBq * D * sizeof(T) / 4;  // a staged tile
  static constexpr int kK = 0, kV = kFixed, kQn = 2 * kFixed,
                       kQt = kQn + kOp, kDOn = kQt + kOp, kDOt = kDOn + kOp,
                       kLse = kDOt + kOp, kDelta = kLse + kBq,
                       kRawAt = kDelta + kBq,       // [stage][q, dO]
                       kVecAt = kRawAt + 4 * kRaw,  // [stage][lse, delta]
                       kEnd = kVecAt + 4 * kBq;
  static constexpr int kBytes = kEnd * 4;
  static_assert(kBytes <= 227 * 1024, "dk/dv tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                 GxSeqOperand dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, GxAttnDims dims,
                 int async16, float* __restrict__ dk,
                 float* __restrict__ dv) {
  using S = DkvSmem<T, D>;
  constexpr int Bq = S::kBq, G = S::kG, P = S::kP, NB = Bq / 8;
  constexpr int kKeys = G * kRows;  // keys a block owns
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int c0 = blockIdx.x * kKeys;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            tq = threadIdx.x % 4;
  T* raw = reinterpret_cast<T*>(sm + S::kRawAt);
  float* vec = sm + S::kVecAt;
  const long long rbase = static_cast<long long>(bh) * dims.Lq;
  // causal: query rows before the block's first key attend to none of it
  const int istart = dims.causal ? min(c0, dims.Lq) / Bq * Bq : 0;
  const int ntiles = (dims.Lq - istart + Bq - 1) / Bq;
  // tile t's rows of Q, dO, lse and delta into raw stage t % 2
  auto stage = [&](int t) {
    const int i0 = istart + t * Bq, st = t & 1;
    stage_rows<T, D, Bq>(q, b, h, i0, dims.Lq, async16,
                         raw + 2 * st * Bq * D);
    stage_rows<T, D, Bq>(dout, b, h, i0, dims.Lq, async16,
                         raw + (2 * st + 1) * Bq * D);
    stage_vec(lse + rbase, i0, dims.Lq, Bq, vec + 2 * st * Bq);
    stage_vec(delta + rbase, i0, dims.Lq, Bq, vec + (2 * st + 1) * Bq);
  };
  if (ntiles > 0) stage(0);
  cp_async_commit();
  load_fixed<T, D, kKeys>(k, b, h, c0, dims.Lk, sm + S::kK,
                          sm + S::kK + kKeys * D);
  load_fixed<T, D, kKeys>(v, b, h, c0, dims.Lk, sm + S::kV,
                          sm + S::kV + kKeys * D);

  float dka[G][D / 2], dva[G][D / 2];
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dka[u][e] = dva[u][e] = 0.f;
  }
  const float c = dims.scale * kLog2e;
  for (int t = 0; t < ntiles; ++t) {
    const int i0 = istart + t * Bq, st = t & 1;
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    convert<T, D, Bq>(raw + 2 * st * Bq * D, sm + S::kQn, sm + S::kQt);
    convert<T, D, Bq>(raw + (2 * st + 1) * Bq * D, sm + S::kDOn,
                      sm + S::kDOt);
    for (int i = threadIdx.x; i < Bq; i += kThreads) {
      sm[S::kLse + i] = vec[2 * st * Bq + i] * kLog2e;
      sm[S::kDelta + i] = vec[(2 * st + 1) * Bq + i];
    }
    fence_async_smem();
    __syncthreads();

#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int k0 = c0 + u * kRows;  // this group's first key
      // S^T = K Q^T and dP^T = V dO^T: [64 keys][Bq queries]
      float s[Bq / 2], dp[Bq / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float* kj = sm + S::kK + u * kRows * D + j * 64;
        const float* vj = sm + S::kV + u * kRows * D + j * 64;
        const float* qj = sm + S::kQn + j * 64;
        const float* oj = sm + S::kDOn + j * 64;
        Wgmma<Bq>::ss(s, desc(kj, D), desc(qj, D), j > 0);
        Wgmma<Bq>::ss(dp, desc(vj, D), desc(oj, D), j > 0);
        if (P == 2) {
          Wgmma<Bq>::ss(s, desc(kj, D), desc(qj + Bq * D, D), 1);
          Wgmma<Bq>::ss(s, desc(kj + kKeys * D, D), desc(qj, D), 1);
          Wgmma<Bq>::ss(dp, desc(vj, D), desc(oj + Bq * D, D), 1);
          Wgmma<Bq>::ss(dp, desc(vj + kKeys * D, D), desc(oj, D), 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(s);
      reg_fence(dp);

      // P^T and dS^T in place; accumulator e is (key row, query column)
      const bool whole = i0 + Bq <= dims.Lq &&
                         (!dims.causal || i0 >= k0 + kRows - 1);
      const float* ls = sm + S::kLse;
      const float* dts = sm + S::kDelta;
#pragma unroll
      for (int e = 0; e < Bq / 2; ++e) {
        const int col = 8 * (e >> 2) + 2 * tq + (e & 1);
        float p = ex2(fmaf(s[e], c, -ls[col]));
        if (!whole) {
          const int row = i0 + col, key = k0 + 16 * warp + g + (e & 2) * 4;
          if (row >= dims.Lq || (dims.causal && key > row)) p = 0.f;
        }
        s[e] = p;
        dp[e] = p * (dp[e] - dts[col]);
      }
      // this tile's P^T dO, then dS^T Q: depth Bq (slot order), N = D;
      // one set of A fragments at a time keeps the registers down
      uint32_t fh[NB][4], fl[NB][4];
      float tv[D / 2], tk[D / 2];
#pragma unroll
      for (int i = 0; i < NB; ++i) a_frag(s, i, fh[i], fl[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float* oi = sm + S::kDOt + i * 64;
        Wgmma<D>::rs(tv, fh[i], desc(oi, Bq), i > 0);
        Wgmma<D>::rs(tv, fl[i], desc(oi, Bq), 1);
        if (P == 2) Wgmma<D>::rs(tv, fh[i], desc(oi + Bq * D, Bq), 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < NB; ++i) a_frag(dp, i, fh[i], fl[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float* qi = sm + S::kQt + i * 64;
        Wgmma<D>::rs(tk, fh[i], desc(qi, Bq), i > 0);
        Wgmma<D>::rs(tk, fl[i], desc(qi, Bq), 1);
        if (P == 2) Wgmma<D>::rs(tk, fh[i], desc(qi + Bq * D, Bq), 1);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(tv);
      reg_fence(tk);
      // the tensor cores' fp32 sums truncate; a tile's sum is added in
      // round-to-nearest, so the error does not grow with Lq
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        dva[u][e] += tv[e];
        dka[u][e] += tk[e];
      }
    }
    __syncthreads();  // the operand tiles are rewritten next tile
  }

  // accumulator e of dK/dV is (key row, head element)
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int key = c0 + u * kRows + 16 * warp + g + (e & 2) * 4;
      if (key >= dims.Lk) continue;
      const long long off =
          (static_cast<long long>(b) * dims.Lk + key) * dims.H * D +
          static_cast<long long>(h) * D + 8 * (e >> 2) + 2 * tq;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[u][e] * dims.scale, dka[u][e + 1] * dims.scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[u][e], dva[u][e + 1]);
    }
  }
}

template <typename T, int D>
int launch_dkv(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
               GxSeqOperand dout, const float* lse, const float* delta,
               GxAttnDims dims, float* dk, float* dv, cudaStream_t stream) {
  constexpr int bytes = DkvSmem<T, D>::kBytes;
  const int err = allow_smem(flash_dkv_kernel<T, D>, bytes);
  if (err != 0) return err;
  const int async16 = aligned16<T>(q) && aligned16<T>(dout);
  constexpr int keys = dkv_groups(D) * kRows;
  const dim3 grid((dims.Lk + keys - 1) / keys, dims.B * dims.H);
  flash_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dims, async16, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

// Head dims above 128 (attention_wide.cuh): block (x, bh, z) owns 64 keys
// and head elements [256 z, 256 z + 256) of their dk and dv (two output
// chunks).  Its K and V rows stay in shared memory, raw, for the whole
// walk over the query tiles (resident_walk): warpgroup 0 keeps K and
// computes S^T = K Q^T, warpgroup 1 keeps V and computes dP^T = V dO^T,
// each over the whole head with its fixed rows as register A fragments;
// they trade the scores, and then warpgroup 0 sums dV_j += P^T dO_j and
// warpgroup 1 dK_j += dS^T Q_j for both output chunks j.  The first
// version re-staged K and V, chunk by chunk, for every 16-row tile (128 of
// the 180 KB a tile staged) and recomputed the scores for each output
// chunk: 178 ms at D = 256 on the H100 against a 13.3 ms bound; this one
// takes 65 ms.  What bounds it now is issue, not bandwidth: a 224 KB
// block an SM, two warpgroups, each splitting its A fragments and
// staging, splitting and transposing its tiles between N = 16 products
// that run at half the tensor cores' rate (tools/wgmma_rate.cu).
template <typename T, bool kAll>
__global__ void __launch_bounds__(gx_wide::kWalkThreads, 1)
flash_dkv_wide_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                      GxSeqOperand dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, GxAttnDims dims,
                      int vec, float* __restrict__ dk,
                      float* __restrict__ dv) {
  constexpr int C = gx_attn::kChunk, Bq = gx_wide::kTileRows;
  constexpr int P = parts<T>(), NB = Bq / 8, G = gx_wide::kOutChunks;
  constexpr int Ch = C / 2;  // head elements a half of an output chunk
  constexpr int kTr = gx_wide::WalkSmem<T, 2>::kTr;
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int c0 = blockIdx.x * kRows, oc0 = G * blockIdx.z;
  const int nc = dims.D / C;
  // warpgroup w: 0 sums dV (S^T, K resident), 1 dK (dP^T, V resident)
  const int w = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const long long rbase = static_cast<long long>(bh) * dims.Lq;
  float acc[G][C / 2];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < C / 2; ++e) acc[j][e] = 0.f;
  }
  const float c = dims.scale * kLog2e;
  // causal: query rows before the block's first key attend to none of it
  const int istart = dims.causal ? min(c0, dims.Lq) / Bq * Bq : 0;
  // the tile's lse * log2(e) and delta: loaded in its first step, stored
  // for grad in its last
  float pl = 0.f, pd = 0.f;
  auto prep = [&](int i0, float* vecs, bool store) {
    const int i = threadIdx.x;
    if (i >= Bq) return;
    if (store) {
      vecs[i] = pl;
      vecs[Bq + i] = pd;
    } else if (i0 + i < dims.Lq) {
      pl = lse[rbase + i0 + i] * kLog2e;
      pd = delta[rbase + i0 + i];
    } else {
      pl = pd = 0.f;
    }
  };
  auto grad = [&](int i0, float (&s)[Bq / 2], float (&dp)[Bq / 2],
                  const float* trs, const float* vecs) {
    // P^T and dS^T in place; accumulator e is (key row, query column)
    const bool whole = i0 + Bq <= dims.Lq &&
                       (!dims.causal || i0 >= c0 + kRows - 1);
#pragma unroll
    for (int e = 0; e < Bq / 2; ++e) {
      const int col = 8 * (e >> 2) + 2 * tq + (e & 1);
      float p = ex2(fmaf(s[e], c, -vecs[col]));
      if (!whole) {
        const int row = i0 + col, key = c0 + 16 * warp + g + (e & 2) * 4;
        if (row >= dims.Lq || (dims.causal && key > row)) p = 0.f;
      }
      s[e] = p;
      dp[e] = p * (dp[e] - vecs[Bq + col]);
    }
    // this tile's P^T dO_j (warpgroup 0) or dS^T Q_j (1): depth Bq (slot
    // order), summed into acc[j] in round-to-nearest
    float a[Bq / 2];
#pragma unroll
    for (int e = 0; e < Bq / 2; ++e) a[e] = w ? dp[e] : s[e];
    uint32_t fh[NB][4], fl[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) a_frag(a, i, fh[i], fl[i]);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      // dO^T_j (staged by warpgroup 1) or Q^T_j (by 0), in its two halves
      // of 64 head elements: accumulator e of half u is element 32 u + e
      // of the chunk's
      const float* bt = trs + ((1 - w) * G + j) * kTr;
      float t[2][Ch / 2];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float* bi = bt + u * P * Bq * Ch + i * 64;
          Wgmma<Ch>::rs(t[u], fh[i], desc(bi, Bq), i > 0);
          Wgmma<Ch>::rs(t[u], fl[i], desc(bi, Bq), 1);
          if (P == 2) Wgmma<Ch>::rs(t[u], fh[i], desc(bi + Bq * Ch, Bq), 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        reg_fence(t[u]);
#pragma unroll
        for (int e = 0; e < Ch / 2; ++e) acc[j][Ch / 2 * u + e] += t[u][e];
      }
    }
  };
  gx_wide::resident_walk<T, kAll, 2>(
      k, v, c0, dims.Lk, q, dout, vec & 1, vec & 8, istart,
      (dims.Lq - istart + Bq - 1) / Bq, dims.Lq, b, h, nc, oc0, sm, prep,
      grad);

  // accumulator e is (key row, head element)
  float* out = w ? dk : dv;
  const float scale = w ? dims.scale : 1.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (oc0 + j >= nc) break;
#pragma unroll
    for (int e = 0; e < C / 2; e += 2) {
      const int key = c0 + 16 * warp + g + (e & 2) * 4;
      if (key >= dims.Lk) continue;
      *reinterpret_cast<float2*>(
          out + gx_wide::chunk_offset(dims, dims.Lk, b, h, key, oc0 + j,
                                      e)) =
          make_float2(acc[j][e] * scale, acc[j][e + 1] * scale);
    }
  }
}

template <typename T>
int launch_dkv_wide(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                    GxSeqOperand dout, const float* lse, const float* delta,
                    GxAttnDims dims, float* dk, float* dv,
                    cudaStream_t stream) {
  const int nc = dims.D / gx_attn::kChunk;
  const bool all = nc <= gx_wide::max_resident<T>();
  const int bytes = gx_wide::WalkSmem<T, 2>::bytes(
      all ? nc : gx_wide::max_resident<T>());
  auto kernel = all ? flash_dkv_wide_kernel<T, true>
                    : flash_dkv_wide_kernel<T, false>;
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  constexpr int G = gx_wide::kOutChunks;
  const dim3 grid((dims.Lk + kRows - 1) / kRows, dims.B * dims.H,
                  (nc + G - 1) / G);
  kernel<<<grid, gx_wide::kWalkThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dims, gx_wide::vec_bits<T>(q, k, v, &dout),
      dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_flash_bwd_dkv(GxSeqOperand q, GxSeqOperand k,
                                GxSeqOperand v, GxSeqOperand dout,
                                const float* lse, const float* delta,
                                GxAttnDims dims, float* dk, float* dv,
                                cudaStream_t stream) {
  if (!gx_attn::dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  if (dims.B == 0 || dims.Lk == 0) return 0;
  GX_ATTN_DISPATCH(launch_dkv, launch_dkv_wide, q, k, v, dout, lse, delta,
                   dims, dk, dv, stream)
}
