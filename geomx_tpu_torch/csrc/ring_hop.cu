// One ring-attention hop for Hopper, on the tensor cores: wgmma in split
// TF32 (3 TF32 products for each fp32 one), fp32 accumulators.
//
// Replaces geomx_tpu/parallel/_fused_block.py fused_block (_hop_kernel,
// _hop_pallas; pallas_call :100): the streaming-softmax carries (m, l, o)
// of the local query block come in, the attention against the K/V block the
// ring currently holds is folded in, and the carries go out — o stays
// un-normalised (o_new = o corr + p V), exactly as the jnp _block.  Mask
// modes: full (dims.causal = 0) or the causal diagonal block (dims.causal =
// 1: -1e30 masking, tiles wholly in a group's future skipped).  A row
// seeded with m = -inf (the ring's first hop) gets corr = exp(-inf - m_new)
// = 0, never NaN: a tile's running max starts at the sentinel.
//
// Design: the hop is the forward's tile step, so it runs the forward's
// tile body (attention_fwd.cuh) and differs only at the ends: it seeds
// (m, l, o) from the carries (l as lane 0's share of the quad's partial
// sums) and writes them back, l summed over the quad.  A block is one
// warpgroup of 64 query rows: at the ring's shapes a hop has one or two
// key tiles a group, so blocks, not the reuse of a staged tile, keep the
// SMs busy.  The in-process ring stacks its sp shards into B, so one
// launch covers every shard of a hop.  There is no backward kernel: as in
// the reference, the hop's gradient is the autograd VJP of the plain
// _block, recomputed.
//
// Bound: bytes.  At seq_ring's hop ([32, 128, 4, 16]) q, k, v and the
// carries in and out are 6.55 MB, 1.96 us at 3.35 TB/s; the products (4 B
// H Lq Lk D = 134 MFLOP, 403 MFLOP of split TF32) take 0.81 us and the 8.4
// M exponentials 2.0 us.  What holds the kernel is latency: one wave of
// 256 blocks on 132 SMs, each a chain of dependent steps (the carries' and
// Q's loads, the first tile's copy, two products and the softmax a tile);
// the next tile's copy overlaps the current one's work.
#include "attention_fwd.cuh"

namespace {

using namespace gx_fwd;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ring_hop_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                const float* __restrict__ m_in, const float* __restrict__ l_in,
                const float* __restrict__ o_in, GxAttnDims dims, int async16,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ o_out) {
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows;
  const bool lane0 = threadIdx.x % 4 == 0;
  float o[1][D / 2], m[1][2], l[1][2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int row = my_row(q0, w);
    const bool live = row < dims.Lq;
    const long long r = static_cast<long long>(bh) * dims.Lq + row;
    m[0][w] = live ? m_in[r] : kNegInf;
    l[0][w] = live && lane0 ? l_in[r] : 0.f;
#pragma unroll
    for (int e = 2 * w; e < D / 2; e += 4) {
      const float2 x =
          live ? *reinterpret_cast<const float2*>(
                     o_in + acc_offset<D>(dims, b, h, row, e))
               : make_float2(0.f, 0.f);
      o[0][e] = x.x;
      o[0][e + 1] = x.y;
    }
  }
  fold_keys<T, D, 1>(q, k, v, dims, b, h, q0, async16, sm, o, m, l);

#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int row = my_row(q0, w);
    const float l_sum = quad_sum(l[0][w]);
    if (row >= dims.Lq) continue;
    if (lane0) {
      const long long r = static_cast<long long>(bh) * dims.Lq + row;
      m_out[r] = m[0][w];
      l_out[r] = l_sum;
    }
#pragma unroll
    for (int e = 2 * w; e < D / 2; e += 4) {
      store2(o_out + acc_offset<D>(dims, b, h, row, e), o[0][e],
             o[0][e + 1]);
    }
  }
}

template <typename T, int D>
int launch_hop(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
               const float* m_in, const float* l_in, const float* o_in,
               GxAttnDims dims, float* m_out, float* l_out, float* o_out,
               cudaStream_t stream) {
  constexpr int bytes = FwdSmem<T, D, 1>::kBytes;
  const int err = allow_smem(ring_hop_kernel<T, D>, bytes);
  if (err != 0) return err;
  const int async16 = aligned16<T>(k) && aligned16<T>(v);
  const dim3 grid((dims.Lq + kRows - 1) / kRows, dims.B * dims.H);
  ring_hop_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, m_in, l_in, o_in, dims, async16, m_out, l_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

// Head dims above 128 (attention_wide.cuh): block (x, bh, z) owns 64
// query rows and head elements [256 z, 256 z + 256) of their o carry (two
// output chunks, one a warpgroup; fold_keys_wide); every warpgroup seeds m
// and l, only chunk 0's stores them.  At [32, 128, 4, 256] fp32 on the
// H100: 86 us against a 30 us bound; its 4 key tiles a block take most of
// it, the Q load and the first steps' copies about a tenth each
// (PERF.md).
template <typename T, bool kAll>
__global__ void __launch_bounds__(gx_wide::kWalkThreads, 1)
ring_hop_wide_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ o_in, GxAttnDims dims, int vec,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ o_out) {
  constexpr int C = gx_attn::kChunk;
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows, oc0 = gx_wide::kOutChunks * blockIdx.z;
  const int oc = oc0 + threadIdx.x / kThreads;  // this warpgroup's chunk
  const bool lane0 = threadIdx.x % 4 == 0, mine = oc < dims.D / C;
  float o[C / 2], m[2], l[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int row = my_row(q0, w);
    const bool live = row < dims.Lq;
    const long long r = static_cast<long long>(bh) * dims.Lq + row;
    m[w] = live ? m_in[r] : kNegInf;
    l[w] = live && lane0 ? l_in[r] : 0.f;
#pragma unroll
    for (int e = 2 * w; e < C / 2; e += 4) {
      const float2 x =
          live && mine ? *reinterpret_cast<const float2*>(
                             o_in + gx_wide::chunk_offset(dims, dims.Lq, b, h,
                                                          row, oc, e))
                       : make_float2(0.f, 0.f);
      o[e] = x.x;
      o[e + 1] = x.y;
    }
  }
  fold_keys_wide<T, kAll>(q, k, v, dims, b, h, q0, oc0, vec, sm, o, m, l);
  if (!mine) return;

#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int row = my_row(q0, w);
    const float l_sum = quad_sum(l[w]);
    if (row >= dims.Lq) continue;
    if (lane0 && oc == 0) {
      const long long r = static_cast<long long>(bh) * dims.Lq + row;
      m_out[r] = m[w];
      l_out[r] = l_sum;
    }
#pragma unroll
    for (int e = 2 * w; e < C / 2; e += 4) {
      store2(o_out + gx_wide::chunk_offset(dims, dims.Lq, b, h, row, oc, e),
             o[e], o[e + 1]);
    }
  }
}

template <typename T>
int launch_hop_wide(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                    const float* m_in, const float* l_in, const float* o_in,
                    GxAttnDims dims, float* m_out, float* l_out, float* o_out,
                    cudaStream_t stream) {
  using S = WideFwdSmem<T>;
  const int nc = dims.D / gx_attn::kChunk;
  const bool all = nc <= S::kMaxPieces;
  const int bytes = S::bytes(all ? nc : S::kMaxPieces);
  auto kernel = all ? ring_hop_wide_kernel<T, true>
                    : ring_hop_wide_kernel<T, false>;
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  constexpr int G = gx_wide::kOutChunks;
  const dim3 grid((dims.Lq + kRows - 1) / kRows, dims.B * dims.H,
                  (nc + G - 1) / G);
  kernel<<<grid, gx_wide::kWalkThreads, bytes, stream>>>(
      q, k, v, m_in, l_in, o_in, dims, gx_wide::vec_bits<T>(q, k, v, nullptr),
      m_out, l_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_ring_hop(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                           const float* m_in, const float* l_in,
                           const float* o_in, GxAttnDims dims, float* m_out,
                           float* l_out, float* o_out, cudaStream_t stream) {
  if (!gx_attn::dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  if (dims.B == 0 || dims.Lq == 0) return 0;
  GX_ATTN_DISPATCH(launch_hop, launch_hop_wide, q, k, v, m_in, l_in, o_in,
                   dims, m_out, l_out, o_out, stream)
}
