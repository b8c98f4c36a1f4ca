// The flash backward's dk/dv pass for Hopper, fp32 on the CUDA cores.
//
// Replaces geomx_tpu/ops/flash_attention.py flash_attention_bwd's
// _dkv_kernel (pallas_call :353).
// Design and bound: flash_attention.cu.
#include "attention.cuh"

namespace {

using gx_attn::kRows;
using gx_attn::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_dkv_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                 GxSeqOperand dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, GxAttnDims dims,
                 float* __restrict__ dk, float* __restrict__ dv) {
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float lses[kTile];
  __shared__ float deltas[kTile];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int c0 = blockIdx.x * kRows, col = c0 + threadIdx.x;
  const bool live = col < dims.Lk;
  float kr[D], vr[D], dka[D], dva[D];
  gx_attn::load_row<T, D>(k, b, col, h, live, kr);
  gx_attn::load_row<T, D>(v, b, col, h, live, vr);
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  // causal: query rows before the block's first key attend to none of it
  const int istart = dims.causal ? min(c0, dims.Lq) / kTile * kTile : 0;
  const long long rbase = static_cast<long long>(bh) * dims.Lq;
  for (int i0 = istart; i0 < dims.Lq; i0 += kTile) {
    gx_attn::stage_tile<T, D>(q, b, h, i0, dims.Lq, qs);
    gx_attn::stage_tile<T, D>(dout, b, h, i0, dims.Lq, dos);
    for (int i = threadIdx.x; i < kTile; i += kRows) {
      const bool in = i0 + i < dims.Lq;
      lses[i] = in ? lse[rbase + i0 + i] : 0.f;
      deltas[i] = in ? delta[rbase + i0 + i] : 0.f;
    }
    __syncthreads();
    const bool whole = i0 + kTile <= dims.Lq &&
                       (!dims.causal || i0 >= c0 + kRows - 1);
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const int row = i0 + i;
      const bool keep = live && (whole || (row < dims.Lq &&
                                           !(dims.causal && col > row)));
      const float s = gx_attn::dot_row<D>(kr, qs + i * D) * dims.scale;
      const float dp = gx_attn::dot_row<D>(vr, dos + i * D);
      const float p = keep ? expf(s - lses[i]) : 0.f;
      gx_attn::axpy_row<D>(p * (dp - deltas[i]), qs + i * D, dka);
      gx_attn::axpy_row<D>(p, dos + i * D, dva);
    }
    __syncthreads();
  }
  if (!live) return;
  const long long off =
      (static_cast<long long>(b) * dims.Lk + col) * dims.H * D +
      static_cast<long long>(h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[off + d] = dka[d] * dims.scale;
    dv[off + d] = dva[d];
  }
}

template <typename T, int D>
int launch_dkv(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
               GxSeqOperand dout, const float* lse, const float* delta,
               GxAttnDims dims, float* dk, float* dv, cudaStream_t stream) {
  flash_dkv_kernel<T, D><<<gx_attn::grid_of(dims.Lk, dims), kRows, 0,
                          stream>>>(
      q, k, v, dout, lse, delta, dims, dk, dv);
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
  GX_ATTN_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dims, dk, dv,
                   stream)
}
