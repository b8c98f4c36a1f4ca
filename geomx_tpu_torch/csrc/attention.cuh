// Device helpers of the CUDA-core attention kernels (flash_attention.cu,
// ring_hop.cu): operand access, tile staging, the online-softmax tile step;
// and, for those and the tensor-core backward (flash_attention_dq.cu,
// flash_attention_dkv.cu, attention_mma.cuh), the dispatch over the
// operands' type and head dim.
//
// Layout: one thread owns one row of the operand its block walks (a query
// row for the forward and the hop) and keeps that row, its accumulators
// and its softmax state in registers.  The other operand streams through
// shared memory kTile rows at a time, converted to fp32 once; every thread
// of a warp reads the same staged element, so the reads are broadcasts.
// Rows and tiles past the sequence ends are masked in the kernels, never
// padded in memory.
#pragma once

#include <cuda_bf16.h>

#include "geomx_kernels.h"

namespace gx_attn {

constexpr int kRows = 128;        // rows a block: one a thread
constexpr int kTile = 32;         // rows of the streamed operand a stage
constexpr float kNegInf = -1e30f; // the Pallas kernels' masking sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const GxSeqOperand& t, int b,
                                            int l, int h) {
  return static_cast<const T*>(t.ptr) + b * t.sb + l * t.sl + h * t.sh;
}

// reg = row l of head (b, h) in fp32, or zeros for a row past the end
template <typename T, int D>
__device__ __forceinline__ void load_row(const GxSeqOperand& t, int b, int l,
                                         int h, bool live, float (&reg)[D]) {
  if (live) {
    const T* p = row_ptr<T>(t, b, l, h);
#pragma unroll
    for (int d = 0; d < D; ++d) reg[d] = to_f32(p[d]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) reg[d] = 0.f;
  }
}

// s[j * D + d] = element d of row l0 + j, for j < kTile; zeros past len
// (a NaN-free tile: masked rows still meet a multiply by p = 0)
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const GxSeqOperand& t, int b,
                                           int h, int l0, int len, float* s) {
  for (int i = threadIdx.x; i < kTile * D; i += kRows) {
    const int j = i / D, d = i % D;
    s[i] = l0 + j < len ? to_f32(row_ptr<T>(t, b, l0 + j, h)[d]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[D],
                                         const float* tile_row) {
  const float4* p = reinterpret_cast<const float4*>(tile_row);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = p[d];
    acc = fmaf(r[4 * d], x.x, acc);
    acc = fmaf(r[4 * d + 1], x.y, acc);
    acc = fmaf(r[4 * d + 2], x.z, acc);
    acc = fmaf(r[4 * d + 3], x.w, acc);
  }
  return acc;
}

// acc += w * tile_row
template <int D>
__device__ __forceinline__ void axpy_row(float w, const float* tile_row,
                                         float (&acc)[D]) {
  const float4* p = reinterpret_cast<const float4*>(tile_row);
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = p[d];
    acc[4 * d] = fmaf(w, x.x, acc[4 * d]);
    acc[4 * d + 1] = fmaf(w, x.y, acc[4 * d + 1]);
    acc[4 * d + 2] = fmaf(w, x.z, acc[4 * d + 2]);
    acc[4 * d + 3] = fmaf(w, x.w, acc[4 * d + 3]);
  }
}

// Folds the staged key tile [k0, k0 + kTile) into one query row's state,
// as the Pallas forward folds a key tile: masked scores are the -1e30
// sentinel, m_new = max(m, max_j s_j), p_j = exp(s_j - m_new) (0 where
// masked), corr = exp(m - m_new), l = l * corr + sum p, acc = acc * corr +
// p V.  The running max of a tile starts at the sentinel, so a row seeded
// with m = -inf gets corr = 0, never NaN.  `whole`: no key of the tile is
// masked for any row of the block (the mask checks are skipped).
template <int D>
__device__ __forceinline__ void softmax_tile(const float* ks, const float* vs,
                                             const float (&qr)[D],
                                             float (&acc)[D], float& m,
                                             float& l, float scale, int k0,
                                             int row, int Lk, bool causal,
                                             bool whole) {
  float s[kTile];
  unsigned keep = 0xffffffffu;
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    s[j] = dot_row<D>(qr, ks + j * D) * scale;
    if (!whole) {
      const int col = k0 + j;
      if (col >= Lk || (causal && col > row)) {
        s[j] = kNegInf;
        keep &= ~(1u << j);
      }
    }
    mx = fmaxf(mx, s[j]);
  }
  const float m_new = fmaxf(m, mx);
  const float corr = expf(m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    s[j] = (keep >> j) & 1u ? expf(s[j] - m_new) : 0.f;
    psum += s[j];
  }
  l = l * corr + psum;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
  for (int j = 0; j < kTile; ++j) axpy_row<D>(s[j], vs + j * D, acc);
  m = m_new;
}

// a block for every kRows rows of one (batch, head)
inline dim3 grid_of(int rows, const GxAttnDims& dims) {
  return dim3((rows + kRows - 1) / kRows, dims.B * dims.H);
}

inline bool dims_ok(const GxAttnDims& dims) {
  return dims.B >= 0 && dims.H > 0 && dims.Lq >= 0 && dims.Lk >= 0 &&
         static_cast<long long>(dims.B) * dims.H <= 65535;
}

}  // namespace gx_attn

// return LAUNCH<T, D>(args...) for the operands' type and head dim, or
// cudaErrorInvalidValue for a head dim the kernels are not built for
#define GX_ATTN_CASE(DIM, LAUNCH, ...)                               \
  case DIM:                                                          \
    return dims.bf16 ? LAUNCH<__nv_bfloat16, DIM>(__VA_ARGS__)       \
                     : LAUNCH<float, DIM>(__VA_ARGS__);
#define GX_ATTN_DISPATCH(LAUNCH, ...)                                \
  switch (dims.D) {                                                  \
    GX_ATTN_CASE(8, LAUNCH, __VA_ARGS__)                             \
    GX_ATTN_CASE(16, LAUNCH, __VA_ARGS__)                            \
    GX_ATTN_CASE(32, LAUNCH, __VA_ARGS__)                            \
    GX_ATTN_CASE(64, LAUNCH, __VA_ARGS__)                            \
    GX_ATTN_CASE(128, LAUNCH, __VA_ARGS__)                           \
    default:                                                         \
      return static_cast<int>(cudaErrorInvalidValue);                \
  }
