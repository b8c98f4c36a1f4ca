// The flash forward for Hopper, on the tensor cores: wgmma in split TF32
// (3 TF32 products for each fp32 one), fp32 accumulators.
//
// Replaces flash_attention_with_lse / flash_attention of
// geomx_tpu/ops/flash_attention.py (_fa_kernel, _fa_kernel_nolse;
// pallas_call :154): the online-softmax forward with -1e30 masking (keys
// past kv_len, the causal triangle), l = max(l, 1e-20) so a fully-masked
// row gives 0, and lse = m + log(l) on the with-lse variant only.
//
// Design.  The TPU kernel walks the keys as a sequential grid dimension
// with the state in VMEM scratch; here that dimension is a loop inside a
// block, the tile body of attention_fwd.cuh (shared with the ring hop):
// a block is one warpgroup and owns G groups of 64 query rows of one (b,
// h) (2 for head dims up to 16, so each staged K/V tile serves 128 rows);
// K and V stream through shared memory by cp.async one tile ahead, split
// once a tile for all groups.  This kernel starts the state at (-1e30, 0,
// 0) and ends with out = o / max(l, 1e-20) (in the operands' type) and,
// where lse is given, lse = m + log(max(l, 1e-20)); the no-lse variant is
// the same code with the store skipped, so it gives the same bits.
// Operands are read in place through their [B, L, H, D] strides (the
// head dim contiguous); where K's base or strides are not 16-byte aligned
// its copies are plain loads.
//
// Bound: operations.  At seq_flash's shape (B 16, L 4096, H 4, D 16) the
// two products are 4 B H L^2 D = 68.7 GFLOP, 206 GFLOP of TF32 with the
// split: 416 us at the card's 495 TFLOP/s; the B H L^2 = 1.07 G
// exponentials take 257 us of the MUFU unit (16 a clock an SM); the bytes
// take 2.5 us.  What holds the kernel above that is the chain inside a
// warpgroup: S, the softmax, the split of P and P V run one after the
// other for each 64 x 64 tile, the P V as 24 narrow (N = D = 16) products,
// and only the four blocks an SM holds (118 registers, 48 KB of shared
// memory) overlap one block's softmax with another's products.  Each part
// costs its share (PERF.md): none dominates.
//
// Head dims above 128: a block is two warpgroups, owns two 128-wide
// chunks of its output (blockIdx.z) and keeps its Q rows in shared memory
// while K and V stream (flash_fwd_wide_kernel, attention_wide.cuh).
#include "attention_fwd.cuh"

namespace {

using namespace gx_fwd;

// the 64-row groups a block owns: two for narrow heads, so each staged
// K/V tile serves 128 rows (on the H100 at head dim 16 one group measured
// 25% slower, three and four within 3% of two, with more registers)
__host__ __device__ constexpr int fwd_groups(int D) { return D <= 16 ? 2 : 1; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                 GxAttnDims dims, int async16, T* __restrict__ out,
                 float* __restrict__ lse) {
  constexpr int G = fwd_groups(D);
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * G * kRows;
  float o[G][D / 2], m[G][2], l[G][2];
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[u][e] = 0.f;
    m[u][0] = m[u][1] = kNegInf;
    l[u][0] = l[u][1] = 0.f;
  }
  fold_keys<T, D, G>(q, k, v, dims, b, h, q0, async16, sm, o, m, l);

#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int row = my_row(q0 + u * kRows, w);
      // fully-masked rows -> 0 out
      const float l_sum = fmaxf(quad_sum(l[u][w]), 1e-20f);
      if (row >= dims.Lq) continue;
#pragma unroll
      for (int e = 2 * w; e < D / 2; e += 4) {
        store2(out + acc_offset<D>(dims, b, h, row, e), o[u][e] / l_sum,
               o[u][e + 1] / l_sum);
      }
      if (lse != nullptr && threadIdx.x % 4 == 0) {
        lse[static_cast<long long>(bh) * dims.Lq + row] =
            m[u][w] + logf(l_sum);
      }
    }
  }
}

template <typename T, int D>
int launch_fwd(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
               GxAttnDims dims, void* out, float* lse, cudaStream_t stream) {
  constexpr int bytes = FwdSmem<T, D, fwd_groups(D)>::kBytes;
  const int err = allow_smem(flash_fwd_kernel<T, D>, bytes);
  if (err != 0) return err;
  const int async16 = aligned16<T>(k) && aligned16<T>(v);
  constexpr int rows = fwd_groups(D) * kRows;
  const dim3 grid((dims.Lq + rows - 1) / rows, dims.B * dims.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, dims, async16, static_cast<T*>(out), lse);
  return static_cast<int>(cudaGetLastError());
}

// Head dims above 128 (attention_wide.cuh): block (x, bh, z) owns 64
// query rows and head elements [256 z, 256 z + 256) of their output (two
// output chunks, one a warpgroup), over the scores it computes once for
// both (fold_keys_wide: Q resident, K and V streamed); only chunk 0
// writes lse.  At q, k, v [16, 4096, 4, 256] fp32 on the H100: 26.1 ms
// against a 6.66 ms bound, below scaled_dot_product_attention's forward
// (27.4 ms) (PERF.md).
template <typename T, bool kAll>
__global__ void __launch_bounds__(gx_wide::kWalkThreads, 1)
flash_fwd_wide_kernel(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                      GxAttnDims dims, int vec, T* __restrict__ out,
                      float* __restrict__ lse) {
  constexpr int C = gx_attn::kChunk;
  extern __shared__ __align__(128) float sm[];
  const int bh = blockIdx.y, b = bh / dims.H, h = bh % dims.H;
  const int q0 = blockIdx.x * kRows, oc0 = gx_wide::kOutChunks * blockIdx.z;
  const int oc = oc0 + threadIdx.x / kThreads;  // this warpgroup's chunk
  float o[C / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < C / 2; ++e) o[e] = 0.f;
  fold_keys_wide<T, kAll>(q, k, v, dims, b, h, q0, oc0, vec, sm, o, m, l);
  if (oc >= dims.D / C) return;

#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int row = my_row(q0, w);
    const float l_sum = fmaxf(quad_sum(l[w]), 1e-20f);
    if (row >= dims.Lq) continue;
#pragma unroll
    for (int e = 2 * w; e < C / 2; e += 4) {
      store2(out + gx_wide::chunk_offset(dims, dims.Lq, b, h, row, oc, e),
             o[e] / l_sum, o[e + 1] / l_sum);
    }
    if (lse != nullptr && oc == 0 && threadIdx.x % 4 == 0) {
      lse[static_cast<long long>(bh) * dims.Lq + row] = m[w] + logf(l_sum);
    }
  }
}

template <typename T>
int launch_fwd_wide(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                    GxAttnDims dims, void* out, float* lse,
                    cudaStream_t stream) {
  using S = WideFwdSmem<T>;
  const int nc = dims.D / gx_attn::kChunk;
  const bool all = nc <= S::kMaxPieces;
  const int bytes = S::bytes(all ? nc : S::kMaxPieces);
  auto kernel = all ? flash_fwd_wide_kernel<T, true>
                    : flash_fwd_wide_kernel<T, false>;
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  constexpr int G = gx_wide::kOutChunks;
  const dim3 grid((dims.Lq + kRows - 1) / kRows, dims.B * dims.H,
                  (nc + G - 1) / G);
  kernel<<<grid, gx_wide::kWalkThreads, bytes, stream>>>(
      q, k, v, dims, gx_wide::vec_bits<T>(q, k, v, nullptr),
      static_cast<T*>(out), lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_flash_fwd(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                            GxAttnDims dims, void* out, float* lse,
                            cudaStream_t stream) {
  if (!gx_attn::dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  if (dims.B == 0 || dims.Lq == 0) return 0;
  GX_ATTN_DISPATCH(launch_fwd, launch_fwd_wide, q, k, v, dims, out, lse,
                   stream)
}
