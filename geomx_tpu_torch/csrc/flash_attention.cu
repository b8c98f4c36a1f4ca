// Flash attention for Hopper: the forward, fp32 on the CUDA cores.
//
// The backward's two passes (dq, dk/dv) live in flash_attention_dq.cu and
// flash_attention_dkv.cu, on the tensor cores (split-TF32 wgmma,
// attention_mma.cuh): three sources, so the build compiles them in
// parallel.
//
// Replaces flash_attention_with_lse / flash_attention of
// geomx_tpu/ops/flash_attention.py (_fa_kernel, _fa_kernel_nolse;
// pallas_call :154): the online-softmax forward with -1e30 masking (keys
// past kv_len, the causal triangle), l = max(l, 1e-20) so a fully-masked
// row gives 0, and lse = m + log(l) on the with-lse variant only.
//
// Design.  The TPU kernel walks the keys as a sequential grid dimension
// with the accumulators in VMEM scratch.  Here that dimension is a loop
// inside a block: one thread owns one query row, holds it and its
// accumulators in registers, and the keys stream through shared memory 32
// rows a stage (attention.cuh).  Causal tiles wholly in every row's future
// are skipped; ragged ends are masked, never padded in memory.  Operands
// are read in place through their [B, L, H, D] strides (the head dim
// contiguous), fp32 or bf16, and every product and sum is fp32 on the CUDA
// cores.
//
// Bound: operations.  The forward does 4 B H Lq Lk D flops (QK^T and PV)
// and B H Lq Lk exponentials; on the tensor cores in split TF32 (3x the
// flops at 495 TFLOP/s) that is the larger bound; the bytes (each operand
// read once, each output written once) are a few MB.  At head dim 16 a
// thread does 2 D fused multiply-adds a key between broadcast
// shared-memory reads, so instruction throughput on the CUDA cores holds
// the kernel well above that bound.  Its tensor-core redesign is the next
// kernel work.
#include "attention.cuh"

namespace {

using gx_attn::kNegInf;
using gx_attn::kRows;
using gx_attn::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                 GxAttnDims dims, T* __restrict__ out,
                 float* __restrict__ lse) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows, row = q0 + threadIdx.x;
  const bool live = row < dims.Lq;
  float qr[D], acc[D];
  gx_attn::load_row<T, D>(q, b, row, h, live, qr);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  // causal: keys past the block's last row are in every row's future
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
  const float l_sum = fmaxf(l, 1e-20f);  // fully-masked rows -> 0 out
  T* o = out + (static_cast<long long>(b) * dims.Lq + row) * dims.H * D +
         static_cast<long long>(h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) gx_attn::store(o + d, acc[d] / l_sum);
  if (lse != nullptr) {
    lse[static_cast<long long>(bh) * dims.Lq + row] = m + logf(l_sum);
  }
}

template <typename T, int D>
int launch_fwd(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
               GxAttnDims dims, void* out, float* lse, cudaStream_t stream) {
  flash_fwd_kernel<T, D><<<gx_attn::grid_of(dims.Lq, dims), kRows, 0,
                            stream>>>(q, k, v, dims, static_cast<T*>(out),
                                      lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_flash_fwd(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                            GxAttnDims dims, void* out, float* lse,
                            cudaStream_t stream) {
  if (!gx_attn::dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  if (dims.B == 0 || dims.Lq == 0) return 0;
  GX_ATTN_DISPATCH(launch_fwd, q, k, v, dims, out, lse, stream)
}
