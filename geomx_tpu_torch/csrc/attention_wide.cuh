// Head dims above 128 on the attention kernels (the wide route): the
// forward and the ring hop (attention_fwd.cuh fold_keys_wide), dq
// (flash_attention_dq.cu) and dk/dv (flash_attention_dkv.cu).
//
// The reference runs any head dim its gates admit (D % 8 == 0) through
// Pallas; the built instances stop at 128, where the output accumulators
// already take 64 registers a thread (dk and dv together 128).  So a head
// D = 128 nc (the wrappers zero-pad any other D above 128 to the next
// multiple of 128) is split into output chunks of 128 head elements, two
// a block (O or the hop's o, dq, dk and dv), one a warpgroup, over the
// grid's z, and no accumulator set is wider than at D = 128.  Every block
// still needs the full-depth scores (S = Q K^T, and dP = dO V^T for the
// backward), summed a piece of the depth at a time: each piece's
// tensor-core sum is added to the scores in round-to-nearest, in head
// order, so the blocks of all output chunks compute the same bits of m,
// l, P and dS; only chunk 0 writes lse (and the hop's m and l).
//
// Every wide kernel keeps its block's fixed 64 rows in shared memory for
// the whole walk over the streamed rows, raw (128 KB at D = 256 fp32 for
// the backward's two operands: split hi/lo they would need 256 KB, more
// than a block has): K and V for dk/dv, Q and dO for dq (resident_walk(),
// one operand a warpgroup), Q for the forward and the hop (fold_keys_wide,
// a depth half a warpgroup).  In every score product the fixed rows are
// wgmma's A operand, so each thread reads its A fragments from them (one
// 16-byte load covers two k8 steps, res_at()), splits them into hi/lo in
// registers and issues the products in the RS form.  The streamed
// operands (each warpgroup its own) come N rows by 64 head elements a step
// by cp.async (16 rows into two stages for the backward, 32 into three for
// the forward), the next step's copies landing under this step's
// products.  A block sums two output chunks, so the scores are
// computed once for both; the two warpgroups trade their scores (S and dP
// for the backward, the two depth halves of S for the forward) through
// shared memory once a tile.  Past the resident limit (max_resident() for
// the backward, D >= 384 fp32 and D >= 640 bf16; WideFwdSmem for the
// forward, D >= 384 fp32 and D >= 896 bf16) the fixed rows' further chunks
// give their A fragments from L2.
#pragma once

#include "attention.cuh"
#include "attention_mma.cuh"

namespace gx_wide {

using namespace gx_mma;
using gx_attn::kChunk;

constexpr int kTileRows = 16;  // streamed rows a tile of the backward

// Starts the copies of rows [l0, l0 + R) of head (b, h) of t, head
// elements [c0, c0 + KD) (zeros past len), for the K-major [R][KD] operand
// tile op.  fp32 lands straight in op's hi part by cp.async (16-byte
// copies where t is 16-byte aligned, plain loads otherwise), bf16 in raw
// (R rows of KD, as stage_rows() lays them, for the conversion);
// finish_step() then splits or converts, after the copies have landed and
// a barrier.  tid: the thread's index in the warpgroup that stages the
// tile.
template <typename T, int R, int KD>
__device__ __forceinline__ void stage_chunk(const GxSeqOperand& t, int b,
                                            int h, int l0, int len, int c0,
                                            bool async16, float* op, T* raw,
                                            int tid) {
  const GxSeqOperand tc{static_cast<const T*>(t.ptr) + c0, t.sb, t.sl, t.sh};
  if constexpr (sizeof(T) != 4) {
    constexpr int E = 16 / sizeof(T), G = KD / E;  // a row's 16 bytes
    for (int i = tid; i < R * G; i += kThreads) {
      const int r = i / G, c = i % G;
      const bool live = l0 + r < len;
      const T* src = live ? row_ptr<T>(tc, b, l0 + r, h) + c * E
                          : static_cast<const T*>(t.ptr);
      T* dst = raw + raw_chunk<T, KD>(r, c) * E;
      if (async16) {
        cp_async16(dst, src, live);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) dst[e] = live ? src[e] : T();
      }
    }
  } else {
    // lanes over rows: a phase's 8 stores fill one 128-byte line of op
    for (int i = tid; i < R * KD / 4; i += kThreads) {
      const int r = i % R, c = i / R;
      const bool live = l0 + r < len;
      const float* src = live ? row_ptr<float>(tc, b, l0 + r, h) + 4 * c
                              : static_cast<const float*>(t.ptr);
      float* dst = op + kmaj(r, 4 * c, KD);
      if (async16) {
        cp_async16(dst, src, live);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = live ? src[e] : 0.f;
      }
    }
  }
}

// ---- the fixed rows resident -----------------------------------------------

// all but the newest of this thread's wgmma commit groups are done
__device__ __forceinline__ void wgmma_wait_prior() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// chunks of the two fixed operands a block keeps in shared memory (128 KB
// of raw rows): every chunk up to D = 256 fp32 and D = 512 bf16
template <typename T>
__host__ __device__ constexpr int max_resident() {
  return 128 * 1024 /
         (2 * kRows * kChunk * static_cast<int>(sizeof(T)));
}

constexpr int kStepDepth = 64;  // head elements a walk step streams
constexpr int kOutChunks = 2;   // output chunks a walk block sums

// Offset of element (r, col) of a resident [64][W] operand.  Each 16-column
// segment is stored as 4 x 4 transposed, so that a thread's A fragment
// elements (t, t + 4) of two k8 steps, t = lane % 4, are the 4 contiguous
// elements at 4 t; the segments of the rows of one shared-memory phase (2
// rows of fp32 16-byte loads, 4 of bf16 8-byte loads) are XOR-swizzled
// apart, so those loads meet no bank conflict.
template <typename T>
__device__ __forceinline__ int res_at(int r, int col, int W) {
  constexpr int kMask = 8 / sizeof(T) - 1;
  return r * W + 16 * ((col >> 4) ^ (r & kMask)) + 4 * (col & 3) +
         ((col >> 2) & 3);
}

// rows [r0, r0 + 64) of head (b, h) of t, head elements [0, W) (zeros past
// len), into res as it lies (T), by the warpgroup of thread tid
template <typename T>
__device__ __forceinline__ void load_resident(const GxSeqOperand& t, int b,
                                              int h, int r0, int len, int W,
                                              T* res, int tid) {
#pragma unroll 4
  for (int i = tid; i < kRows * W / 4; i += kThreads) {
    const int r = i / (W / 4), c = i % (W / 4) * 4;
    const bool live = r0 + r < len;
    const T* p = row_ptr<T>(t, b, live ? r0 + r : 0, h) + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      res[res_at<T>(r, c + e, W)] = live ? p[e] : T();
    }
  }
}

// x = elements 16 s + t + 4 q (q = 0..3, t = lane % 4) of resident row r
template <typename T>
__device__ __forceinline__ void res_frag(const T* res, int r, int s, int W,
                                         float (&x)[4]) {
  const T* p = res + res_at<T>(r, 16 * s + threadIdx.x % 4, W);
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x, x[1] = a.y, x[2] = c.x, x[3] = c.y;
  }
}

// the same elements of row `row` of head (b, h) of t, from L2 (zeros past
// len): the chunks past max_resident()
template <typename T>
__device__ __forceinline__ void l2_frag(const GxSeqOperand& t, int b, int h,
                                        int row, int len, int s,
                                        float (&x)[4]) {
  const T* p = row_ptr<T>(t, b, row < len ? row : 0, h) + 16 * s +
               threadIdx.x % 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = row < len ? to_f32(p[4 * q]) : 0.f;
}

// Splits (fp32: hi in place, lo behind) or converts (bf16) a [R][KD] tile
// stage_chunk() has landed, and where tr is given also writes it
// transposed, as convert() does: [KD][R], the rows as depth in slot()
// order, lo R * KD on.
template <typename T, int R, int KD>
__device__ __forceinline__ void finish_step(float* op, const T* raw,
                                            float* tr, int tid) {
  const int rot = lane_rot();
  for (int i = tid; i < R * KD / 4; i += kThreads) {
    const int r = group_row<KD>(i), g = group_col<KD>(i);
    float x[4];
    if constexpr (sizeof(T) == 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(op + kmaj(r, 4 * g, KD));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
      load4<T, KD>(raw, r, g, x);
    }
    convert_group<parts<T>(), KD, R>(x, r, g, op, tr, rot);
  }
}

// The scores of one step, d = A B^T (unscaled) over its KD head elements
// from segment s0 on, for the warpgroup's 64 fixed rows (A) against the N
// streamed ones (B).  frag(r, s, x) gives A's elements of row r for
// segment s (res_frag() or l2_frag()); bs is the step's split B (K-major
// [N][KD], hi then lo).  Products are hi hi + hi lo + lo hi (one for
// bf16); one commit group a 16-byte load of A (two k8 steps), the
// previous one still in flight; the next group's A loads are issued
// before the wait, and side(sp) runs under group sp's products (work of
// the caller's that touches neither d nor bs).
struct NoSide {
  __device__ __forceinline__ void operator()(int) const {}
};

template <typename T, int N, int KD, typename Frag, typename Side = NoSide>
__device__ __forceinline__ void step_scores(Frag frag, int s0, int tid,
                                            const float* bs,
                                            float (&d)[N / 2],
                                            Side side = Side()) {
  constexpr int P = parts<T>(), kPairs = KD / 16;
  const int r = 16 * (tid / 32) + tid % 32 / 4;
  // the descriptor's low word: + 16 a k8 step (256 bytes)
  const uint32_t bd = desc_lo(bs);
  float x[2][4];                     // rows r, r + 8
  frag(r, s0, x[0]);
  frag(r + 8, s0, x[1]);
#pragma unroll
  for (int sp = 0; sp < kPairs; ++sp) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float a[4] = {x[0][2 * k], x[1][2 * k], x[0][2 * k + 1],
                          x[1][2 * k + 1]};
      split4<P>(a, hi[k], lo[k]);
    }
    if (sp + 1 < kPairs) {
      frag(r, s0 + sp + 1, x[0]);
      frag(r + 8, s0 + sp + 1, x[1]);
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = 2 * sp + k;
      const uint32_t bj = bd + 16 * j;
      Wgmma<N>::rs(d, hi[k], desc_hi(KD) | bj, j > 0);
      if constexpr (P == 2) {
        Wgmma<N>::rs(d, hi[k], desc_hi(KD) | (bj + N * KD / 4), 1);
        Wgmma<N>::rs(d, lo[k], desc_hi(KD) | bj, 1);
      }
    }
    wgmma_commit();
    side(sp);
    wgmma_wait_prior();
  }
  wgmma_wait();
  reg_fence(d);
}

// threads a block of resident_walk(): two warpgroups
constexpr int kWalkThreads = 2 * kThreads;

// The shared memory of resident_walk(), in floats: the two resident
// operands (R chunks), 2 stages x 2 streamed tiles ([16][64], P parts),
// NT x 2 transposed chunks (two halves, each [64][16] and P parts, one
// from each of the chunk's steps), 2 x 16 floats for the epilogue's
// vectors, and the bf16 staging of the 2 x 2 streamed tiles
template <typename T, int NT>
struct WalkSmem {
  static constexpr int kStep = parts<T>() * kTileRows * kStepDepth;
  static constexpr int kTr = parts<T>() * kTileRows * kChunk;
  static constexpr int kRaw =
      sizeof(T) == 4 ? 0 : kTileRows * kStepDepth * sizeof(T) / 4;
  static constexpr int kStream =
      4 * (kStep + kRaw) + NT * kOutChunks * kTr + 2 * kTileRows;
  static __host__ __device__ constexpr int res_floats(int R) {
    return 2 * kRows * R * kChunk * static_cast<int>(sizeof(T)) / 4;
  }
  static constexpr int bytes(int R) { return (res_floats(R) + kStream) * 4; }
};

// The walk of the backward's wide route, by two warpgroups, for output
// chunks oc0 and oc0 + 1 of the block's 64 fixed rows.  Warpgroup w keeps
// fixed operand a_w (rows [a0, a0 + 64), zeros past alen; R chunks in
// shared memory, all when kAll) and stages streamed operand b_w (tiles of
// 16 rows from row `first`, ntiles of them, zeros past blen; v_w its
// 16-byte alignment), 64 head elements a step into two stages; the steps
// of the block's output chunks also go, transposed, to the gradient
// products' tiles (of b_0, and with NT = 2 of b_1).  For each tile,
// warpgroup w computes d = A_w B_w^T over the whole head, step by step in
// round-to-nearest; the two trade them through shared memory, and
// grad(row0, s, dp, tr, vecs) gets both in each warpgroup: s = A_0 B_0^T,
// dp = A_1 B_1^T; tr the transposed tiles, [operand][output chunk]; vecs
// 32 floats for prep(row0, vecs, store): called in the tile's first step
// (store false: it may load what it will store) and in its last (true).
template <typename T, bool kAll, int NT, typename Prep, typename Grad>
__device__ __forceinline__ void resident_walk(
    const GxSeqOperand& a0p, const GxSeqOperand& a1p, int a0, int alen,
    const GxSeqOperand& b0p, const GxSeqOperand& b1p, bool v0, bool v1,
    int first, int ntiles, int blen, int b, int h, int nc, int oc0,
    float* sm, Prep prep, Grad grad) {
  using S = WalkSmem<T, NT>;
  constexpr int N = kTileRows, KD = kStepDepth, kHalves = kChunk / KD;
  const int w = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  // by value: a reference to one of two parameters would put them on
  // the stack
  const GxSeqOperand a = w ? a1p : a0p, bo = w ? b1p : b0p;
  const bool vo = w ? v1 : v0;
  const int R = kAll ? nc : max_resident<T>(), W = R * kChunk;
  T* res = reinterpret_cast<T*>(sm) + w * kRows * W;
  float* stg = sm + S::res_floats(R);  // [stage][warpgroup]
  float* trs = stg + 4 * S::kStep;     // [operand][output chunk]
  float* vecs = trs + NT * kOutChunks * S::kTr;
  T* raw = reinterpret_cast<T*>(vecs + 2 * N);
  const int spt = nc * kHalves, steps = ntiles * spt;  // steps a tile, all
  // step (tile t, head elements [KD u, KD u + KD)) into stage step % 2
  auto stage = [&](int step) {
    const int t = step / spt, u = step - t * spt, i = 2 * (step & 1) + w;
    stage_chunk<T, N, KD>(bo, b, h, first + t * N, blen, u * KD, vo,
                                 stg + i * S::kStep, raw + i * N * KD, tid);
  };
  if (steps > 0) stage(0);
  cp_async_commit();
  load_resident<T>(a, b, h, a0, alen, W, res, tid);
  auto from_smem = [&](int r, int s, float (&x)[4]) {
    res_frag<T>(res, r, s, W, x);
  };
  auto from_l2 = [&](int r, int s, float (&x)[4]) {
    l2_frag<T>(a, b, h, a0 + r, alen, s, x);
  };
  for (int t = 0, step = 0; t < ntiles; ++t) {
    const int r0 = first + t * N;
    float d[N / 2];
    float* mine = stg;  // this warpgroup's tile of the tile's last step
    for (int u = 0; u < spt; ++u, ++step) {
      const int i = 2 * (step & 1) + w, j = u / kHalves - oc0;
      mine = stg + i * S::kStep;
      cp_async_wait_all();
      // this step's tiles have landed for every thread, and every product
      // that read the other stage (and, in a tile's first step, the
      // transposed tiles) is done
      __syncthreads();
      finish_step<T, N, KD>(
          mine, raw + i * N * KD,
          w < NT && j >= 0 && j < kOutChunks
              ? trs + (w * kOutChunks + j) * S::kTr + u % kHalves * S::kStep
              : nullptr,
          tid);
      if (u == 0 || u == spt - 1) prep(r0, vecs, u != 0);
      fence_async_smem();
      // the next step's copies go after the proxy fence: issued before
      // it, the kernels measured slower on the H100
      if (step + 1 < steps) stage(step + 1);
      cp_async_commit();
      __syncthreads();
      float e[N / 2];
      const int c = u / kHalves, s0 = u * (KD / 16);
      if constexpr (kAll) {
        step_scores<T, N, KD>(from_smem, s0, tid, mine, e);
      } else if (c < R) {
        step_scores<T, N, KD>(from_smem, s0, tid, mine, e);
      } else {
        step_scores<T, N, KD>(from_l2, s0, tid, mine, e);
      }
#pragma unroll
      for (int k = 0; k < N / 2; ++k) d[k] = u == 0 ? e[k] : d[k] + e[k];
    }
    // the scores traded through this step's B tiles, which only their own
    // warpgroup's products (now done) read
#pragma unroll
    for (int k = 0; k < N / 2; ++k) mine[k * kThreads + tid] = d[k];
    __syncthreads();
    const float* theirs = mine + (w ? -S::kStep : S::kStep);
    float s[N / 2], dp[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float o = theirs[k * kThreads + tid];
      s[k] = w ? o : d[k];
      dp[k] = w ? d[k] : o;
    }
    grad(r0, s, dp, trs, vecs);
  }
}

// float offset of accumulator element e of row `row` of output chunk oc in
// a contiguous [B, L, H, D] tensor
__device__ __forceinline__ long long chunk_offset(const GxAttnDims& dims,
                                                  int L, int b, int h,
                                                  int row, int oc, int e) {
  return (static_cast<long long>(b) * L + row) * dims.H * dims.D +
         static_cast<long long>(h) * dims.D + oc * kChunk + 8 * (e >> 2) +
         2 * (threadIdx.x % 4);
}

// the operands' 16-byte alignment, one bit each: q 1, k 2, v 4, dO 8
template <typename T>
inline int vec_bits(const GxSeqOperand& q, const GxSeqOperand& k,
                    const GxSeqOperand& v, const GxSeqOperand* dout) {
  return (aligned16<T>(q) ? 1 : 0) | (aligned16<T>(k) ? 2 : 0) |
         (aligned16<T>(v) ? 4 : 0) |
         (dout != nullptr && aligned16<T>(*dout) ? 8 : 0);
}

}  // namespace gx_wide
