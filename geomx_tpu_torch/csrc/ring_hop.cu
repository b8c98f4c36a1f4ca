// One ring-attention hop for Hopper, fp32 on the CUDA cores.
//
// Replaces geomx_tpu/parallel/_fused_block.py fused_block (_hop_kernel,
// _hop_pallas; pallas_call :100): the streaming-softmax carries (m, l, o)
// of the local query block come in, the attention against the K/V block the
// ring currently holds is folded in, and the carries go out — o stays
// un-normalised (o_new = o corr + p V), exactly as the jnp _block.  Mask
// modes: full (dims.causal = 0) or the causal diagonal block (dims.causal =
// 1: -1e30 masking, tiles wholly in every row's future skipped).  A row
// seeded with m = -inf (the ring's first hop) gets corr = exp(-inf - m_new)
// = 0, never NaN: a processed tile's running max starts at the sentinel.
//
// Design: the forward kernel's (flash_attention.cu) with the state seeded
// from and written back to device memory instead of initialised and
// normalised: one thread a query row, K/V streamed through shared memory 32
// rows a stage, every sum in one thread in a fixed order.  The in-process
// ring stacks its sp shards into B, so one launch covers every shard of a
// hop.  There is no backward kernel: as in the reference, the hop's
// gradient is the autograd VJP of the plain _block, recomputed.
//
// Bound: operations, 4 B H Lq Lk D flops (about half on the diagonal) plus
// B H Lq Lk exponentials at the card's 67 TFLOP/s fp32 rate; the bytes
// (q, k, v, the carries in and out) are a few MB at the ring's shapes.
#include "attention.cuh"

namespace {

using gx_attn::kNegInf;
using gx_attn::kRows;
using gx_attn::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
ring_hop_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                const float* __restrict__ m_in, const float* __restrict__ l_in,
                const float* __restrict__ o_in, GxAttnDims dims,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ o_out) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows, row = q0 + threadIdx.x;
  const bool live = row < dims.Lq;
  const long long r = static_cast<long long>(bh) * dims.Lq + row;
  const long long off =
      (static_cast<long long>(b) * dims.Lq + row) * dims.H * D +
      static_cast<long long>(h) * D;
  float qr[D], acc[D];
  gx_attn::load_row<T, D>(q, b, row, h, live, qr);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = live ? o_in[off + d] : 0.f;
  float m = live ? m_in[r] : kNegInf;
  float l = live ? l_in[r] : 0.f;
  // diagonal block: keys past the block's last row are in every row's
  // future
  const int kend = dims.causal ? min(dims.Lk, q0 + kRows) : dims.Lk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    gx_attn::stage_tile<T, D>(k, b, h, k0, dims.Lk, ks);
    gx_attn::stage_tile<T, D>(v, b, h, k0, dims.Lk, vs);
    __syncthreads();
    const bool whole = k0 + kTile <= dims.Lk &&
                       (!dims.causal || k0 + kTile - 1 <= q0);
    gx_attn::softmax_tile<D>(ks, vs, qr, acc, m, l, dims.scale, k0, row,
                             dims.Lk, dims.causal, whole);
    __syncthreads();
  }
  if (!live) return;
  m_out[r] = m;
  l_out[r] = l;
#pragma unroll
  for (int d = 0; d < D; ++d) o_out[off + d] = acc[d];
}

template <typename T, int D>
int launch_hop(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
               const float* m_in, const float* l_in, const float* o_in,
               GxAttnDims dims, float* m_out, float* l_out, float* o_out,
               cudaStream_t stream) {
  ring_hop_kernel<T, D><<<gx_attn::grid_of(dims.Lq, dims), kRows, 0,
                           stream>>>(
      q, k, v, m_in, l_in, o_in, dims, m_out, l_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_ring_hop(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                           const float* m_in, const float* l_in,
                           const float* o_in, GxAttnDims dims, float* m_out,
                           float* l_out, float* o_out, cudaStream_t stream) {
  if (!gx_attn::dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  if (dims.B == 0 || dims.Lq == 0) return 0;
  GX_ATTN_DISPATCH(launch_hop, q, k, v, m_in, l_in, o_in, dims, m_out, l_out,
                   o_out, stream)
}
