// Head dims above 128 on the attention kernels (the wide route): the
// forward and the ring hop (attention_fwd.cuh fold_keys_wide), dq
// (flash_attention_dq.cu) and dk/dv (flash_attention_dkv.cu).
//
// The reference runs any head dim its gates admit (D % 8 == 0) through
// Pallas; the built instances stop at 128, where the output accumulators
// already take 64 registers a thread (dk and dv together 128).  So a head
// D = 128 nc (the wrappers zero-pad any other D above 128 to the next
// multiple of 128) is split over the grid: block z owns head elements
// [128 z, 128 z + 128) of its output (O, dq, dk and dv, or the hop's o),
// and no accumulator is wider than at D = 128.  Every block still needs
// the full-depth scores (S = Q K^T, and dP = dO V^T for the backward):
// wide_scores() streams the depth through shared memory in nc chunks of
// 128, each chunk's tensor-core sum added to the scores in round-to-
// nearest.  The blocks of all chunks run the same code on the same
// inputs, so each recomputes the same bits of m, l, P and dS; only chunk
// 0 writes lse (and the hop's m and l).
//
// The streamed tiles are 16 rows (as at D = 128).  Each chunk comes by
// cp.async, all of a tile's copies in flight at once: fp32 straight into
// the K-major operand layouts of attention_mma.cuh, split there in place;
// bf16 through a staging buffer, converted.  Nothing is double buffered.
// This route costs the score products once per output chunk and re-reads
// the fixed operand's chunks (Q, or K and V) from L2 for every streamed
// tile: it is the simple first version of head dims the SeqClassifier
// paths do not run.
#pragma once

#include "attention.cuh"
#include "attention_mma.cuh"

namespace gx_wide {

using namespace gx_mma;
using gx_attn::kChunk;

constexpr int kTileRows = 16;  // streamed rows a tile

// Starts the copies of rows [l0, l0 + R) of head (b, h) of t, head
// elements [c0, c0 + 128) (zeros past len), for the K-major operand tile
// op: nat ([R][128], as they lie) or, with kTr, tr ([128][R], the rows as
// depth in slot() order).  fp32 lands straight in op's hi part by
// cp.async (16-byte copies for nat where t is 16-byte aligned, 4-byte for
// tr), bf16 in raw (R rows of 128, for convert()); finish_chunk() then
// splits or converts, after the copies have landed and a barrier.
template <typename T, int R, bool kTr>
__device__ __forceinline__ void stage_chunk(const GxSeqOperand& t, int b,
                                            int h, int l0, int len, int c0,
                                            bool async16, float* op, T* raw) {
  const GxSeqOperand tc{static_cast<const T*>(t.ptr) + c0, t.sb, t.sl, t.sh};
  if constexpr (sizeof(T) != 4) {
    stage_rows<T, kChunk, R>(tc, b, h, l0, len, async16, raw);
  } else if constexpr (kTr) {
    for (int i = threadIdx.x; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk, d = i % kChunk;
      const bool live = l0 + r < len;
      cp_async4(op + kmaj(d, slot(r), R),
                live ? row_ptr<float>(tc, b, l0 + r, h) + d
                     : static_cast<const float*>(t.ptr),
                live);
    }
  } else {
    for (int i = threadIdx.x; i < R * kChunk / 4; i += kThreads) {
      const int r = i / (kChunk / 4), c = i % (kChunk / 4);
      const bool live = l0 + r < len;
      const float* src = live ? row_ptr<float>(tc, b, l0 + r, h) + 4 * c
                              : static_cast<const float*>(t.ptr);
      float* dst = op + kmaj(r, 4 * c, kChunk);
      if (async16) {
        cp_async16(dst, src, live);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = live ? src[e] : 0.f;
      }
    }
  }
}

template <typename T, int R, bool kTr>
__device__ __forceinline__ void finish_chunk(float* op, const T* raw) {
  if constexpr (sizeof(T) == 4) {
    split_tile<R * kChunk>(op);  // hi in place, lo behind
  } else {
    convert<T, kChunk, R>(raw, kTr ? nullptr : op, kTr ? op : nullptr);
  }
}

// The bf16 staging floats a wide kernel needs: the 64 + N rows of a
// wide_scores() chunk and `more` tiles of N rows staged beside its last
// chunk (fp32 lands in place: none)
template <typename T, int N, int more>
__host__ __device__ constexpr int raw_floats() {
  return sizeof(T) == 4 ? 0
                        : (kRows + (1 + more) * N) * kChunk * sizeof(T) / 4;
}

// the bf16 staging of the tile staged beside the last chunk as the i-th
template <typename T, int N>
__device__ __forceinline__ T* raw_more(float* raw, int i) {
  return reinterpret_cast<T*>(raw) + (kRows + (1 + i) * N) * kChunk;
}

struct NoMore {
  __device__ void operator()() const {}
};

// The scores s = A B^T (unscaled) of rows [a0, a0 + 64) of a against rows
// [b0, b0 + N) of bo over the whole head, nc chunks of 128: each chunk's
// rows are staged into sa (P * 64 * 128 floats) and sb (P * N * 128; bf16
// through raw, raw_floats()), multiplied in split TF32 (hi hi + hi lo +
// lo hi; one product for bf16), and the chunk's (truncated) tensor-core
// sum is added to s in round-to-nearest.  Starts with a barrier, so the
// caller's last reads of sa, sb and raw are done.  stage_more() starts
// the copies of further tiles beside the last chunk's (the tr tiles of
// the gradient or P V products), and finish_more() splits them, so they
// cost no round trip of their own.
template <typename T, int N, typename Stage = NoMore,
          typename Finish = NoMore>
__device__ __forceinline__ void wide_scores(
    const GxSeqOperand& a, int a0, int alen, bool avec,
    const GxSeqOperand& bo, int b0, int blen, bool bvec, int b, int h,
    int nc, float* sa, float* sb, float* raw, float (&s)[N / 2],
    Stage stage_more = {}, Finish finish_more = {}) {
  constexpr int P = parts<T>();
  T* ra = reinterpret_cast<T*>(raw);
  T* rb = ra + kRows * kChunk;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();
    stage_chunk<T, kRows, false>(a, b, h, a0, alen, c * kChunk, avec, sa, ra);
    stage_chunk<T, N, false>(bo, b, h, b0, blen, c * kChunk, bvec, sb, rb);
    if (c == nc - 1) stage_more();
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    finish_chunk<T, kRows, false>(sa, ra);
    finish_chunk<T, N, false>(sb, rb);
    if (c == nc - 1) finish_more();
    fence_async_smem();
    __syncthreads();
    float sc[N / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const float* aj = sa + j * 64;
      const float* bj = sb + j * 64;
      Wgmma<N>::ss(sc, desc(aj, kChunk), desc(bj, kChunk), j > 0);
      if (P == 2) {
        Wgmma<N>::ss(sc, desc(aj, kChunk), desc(bj + N * kChunk, kChunk), 1);
        Wgmma<N>::ss(sc, desc(aj + kRows * kChunk, kChunk), desc(bj, kChunk),
                     1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    reg_fence(sc);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) s[e] = c == 0 ? sc[e] : s[e] + sc[e];
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
