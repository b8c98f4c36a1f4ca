// The flash backward's dq pass for Hopper, fp32 on the CUDA cores.
//
// Replaces geomx_tpu/ops/flash_attention.py flash_attention_bwd's
// _dq_kernel (pallas_call :339).
// Design and bound: flash_attention.cu.
#include "attention.cuh"

namespace {

using gx_attn::kRows;
using gx_attn::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_dq_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                GxSeqOperand dout, const float* __restrict__ lse,
                const float* __restrict__ delta, GxAttnDims dims,
                float* __restrict__ dq) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows, row = q0 + threadIdx.x;
  const bool live = row < dims.Lq;
  float qr[D], dor[D], acc[D];
  gx_attn::load_row<T, D>(q, b, row, h, live, qr);
  gx_attn::load_row<T, D>(dout, b, row, h, live, dor);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const long long r = static_cast<long long>(bh) * dims.Lq + row;
  const float lr = live ? lse[r] : 0.f;
  const float dr = live ? delta[r] : 0.f;
  const int kend = dims.causal ? min(dims.Lk, q0 + kRows) : dims.Lk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    gx_attn::stage_tile<T, D>(k, b, h, k0, dims.Lk, ks);
    gx_attn::stage_tile<T, D>(v, b, h, k0, dims.Lk, vs);
    __syncthreads();
    const bool whole = k0 + kTile <= dims.Lk &&
                       (!dims.causal || k0 + kTile - 1 <= q0);
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const int col = k0 + j;
      const bool keep = live && (whole || (col < dims.Lk &&
                                           !(dims.causal && col > row)));
      const float s = gx_attn::dot_row<D>(qr, ks + j * D) * dims.scale;
      const float dp = gx_attn::dot_row<D>(dor, vs + j * D);
      const float p = keep ? expf(s - lr) : 0.f;
      gx_attn::axpy_row<D>(p * (dp - dr), ks + j * D, acc);
    }
    __syncthreads();
  }
  if (!live) return;
  float* o = dq + (static_cast<long long>(b) * dims.Lq + row) * dims.H * D +
             static_cast<long long>(h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = acc[d] * dims.scale;
}

template <typename T, int D>
int launch_dq(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
              GxSeqOperand dout, const float* lse, const float* delta,
              GxAttnDims dims, float* dq, cudaStream_t stream) {
  flash_dq_kernel<T, D><<<gx_attn::grid_of(dims.Lq, dims), kRows, 0,
                         stream>>>(
      q, k, v, dout, lse, delta, dims, dq);
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
  GX_ATTN_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dims, dq, stream)
}
