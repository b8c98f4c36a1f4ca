// Plain C interface of the port's CUDA kernels (Hopper, sm_90a).
//
// The .cu files include only this header and the CUDA toolkit's, so they
// compile in seconds; binding.cpp is the one file that sees PyTorch's
// headers.  Every launcher enqueues on the given stream, allocates
// nothing, and returns cudaGetLastError() right after its launches.
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---- bucket flatten / unflatten (bucket.cu) -------------------------------
// One multi-tensor copy launch: entry e is a 2-D copy of rows of n floats
// from src (or zeros when src is null: a bucket's tail pad) to dst.  Row
// r of the entry starts at dst + r * dst_stride and at src + (r / inner)
// * src_outer + (r % inner) * src_inner: two batch strides, so a stride-0
// worker dim needs no copy.  Each row is cut into units = (n + 6) / 4
// quads, 16-byte aligned in the destination (the first and last partial,
// some empty); entry e owns quads [unit_start, next entry's unit_start)
// of the launch (the last up to total_units), and block b quads [b, b +
// 1) * gx_bucket_tile().  One entry's fields share one 64-byte line of
// the kernel's parameter space, which holds the table, so the per-step
// data pointers of fresh gradient tensors need no device-side upload.
// Every launch copies the whole table, used or not: 128 entries make it
// 8,208 bytes, room for ResNet-20 on [2, 4] (66 entries) twice over,
// where the most the 32,764-byte parameter limit holds (511 entries)
// would copy 32,720 bytes a launch for the same 66.  A model with more
// entries takes one more launch for each 128.
#define GX_MAX_COPIES 128

typedef struct {
  long long unit_start;
  const float* src;
  float* dst;
  long long src_outer, src_inner, dst_stride;
  int n, units, inner, pad;
} GxCopy;

typedef struct {
  int count;
  int total_blocks;
  long long total_units;
  GxCopy e[GX_MAX_COPIES];
} GxCopyTable;

int gx_bucket_tile(void);
int gx_bucket_copy(const GxCopyTable* table, cudaStream_t stream);

// ---- BSC select/pack (bsc.cu) ---------------------------------------------
// rows independent rows of n elements; thr[rows]; k output slots a row;
// one launch (after a memset of the scratch).  Scratch:
// gx_bsc_select_scratch(rows, n) int32 words, 8-byte aligned; tie_vals,
// tie_idx [rows * k].
long long gx_bsc_select_scratch(int rows, int n);
int gx_bsc_select_pack(const float* g, const float* u, const float* v,
                       const float* thr, int rows, int n, int k,
                       int* scratch, float* tie_vals, int* tie_idx,
                       float* new_u, float* new_v, float* vals, int* idx,
                       cudaStream_t stream);

// ---- BSC scatter-add decompress (bsc.cu) ----------------------------------
// out[r, :] = sum of vals[r, j] at idx[r, j] (idx < 0 dropped), folding the
// m / run runs of pairs in order.
int gx_bsc_scatter_add(const float* vals, const int* idx, int rows, int m,
                       int run, int n, float* out, cudaStream_t stream);

// ---- fused optimizer apply (optim.cu) --------------------------------------
// n independent fp32 elements (all replica rows of a bucket, contiguous).
// Outputs must not alias inputs.  cast_bf16: null, or n bf16 values that
// receive the new params rounded to nearest even.
int gx_fused_sgd_momentum(const float* p, const float* g, const float* m,
                          long long n, float lr, float momentum,
                          float* new_p, float* new_m, void* cast_bf16,
                          cudaStream_t stream);
// bc1, bc2: the bias corrections 1 - b**t; one_minus_b1/b2: 1 - b rounded
// once from double.
int gx_fused_adam(const float* p, const float* g, const float* m,
                  const float* v, long long n, float bc1, float bc2,
                  float lr, float b1, float one_minus_b1, float b2,
                  float one_minus_b2, float eps, float* new_p, float* new_m,
                  float* new_v, void* cast_bf16, cudaStream_t stream);

// ---- 2-bit quantize / dequantize (twobit.cu) -------------------------------
// rows independent rows of n fp32 elements; each packs into
// gx_twobit_words(n) = ceil(n / 2048) * 128 int32 words (lane-strided).
int gx_twobit_words(int n);
int gx_quantize_2bit(const float* g, const float* r, int rows, int n,
                     float thr, int* packed, float* new_r,
                     cudaStream_t stream);
// packed [rows, parts, words] -> out [rows, n]: the parts' values summed
// in part order.
int gx_dequantize_2bit(const int* packed, int rows, int parts, int n,
                       float thr, float* out, cudaStream_t stream);

// ---- sorted-index segment-sum merge (merge.cu) -----------------------------
// rows independent rows of m index-sorted pairs (svals, skey) -> out_vals,
// out_idx [rows, m]: the combining tree of `rounds` passes, totals at
// segment heads (column 0, or a key unlike the one before), (0.0, -1)
// elsewhere.  rounds above GX_MERGE_MAX_ROUNDS returns
// cudaErrorInvalidValue.
#define GX_MERGE_MAX_ROUNDS 6
int gx_merge_sorted_pairs(const float* svals, const int* skey, int rows,
                          int m, int rounds, float* out_vals, int* out_idx,
                          cudaStream_t stream);

// ---- attention (flash_attention.cu, ring_hop.cu) --------------------------
// A [B, L, H, D] operand: element (b, l, h, d) at ptr + b*sb + l*sl + h*sh + d
// (the head dim contiguous), fp32, or bf16 where GxAttnDims.bf16 says so.
typedef struct {
  const void* ptr;
  long long sb, sl, sh;
} GxSeqOperand;

// Shapes and options of one attention call.  D must be one of 8, 16, 32,
// 64, 128 or a multiple of 128 (else cudaErrorInvalidValue); B * H at
// most 65,535.  causal is
// the causal mask of the flash kernels and the diagonal mode of the hop.
typedef struct {
  int B, H, Lq, Lk, D;
  int causal;
  int bf16;
  float scale;
} GxAttnDims;

// Forward: out [B, Lq, H, D] contiguous, in the operands' type; lse [B, H,
// Lq] fp32, or null (the inference variant writes none).
int gx_flash_fwd(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                 GxAttnDims dims, void* out, float* lse, cudaStream_t stream);
// Backward, dq: lse, delta [B, H, Lq] fp32 -> dq [B, Lq, H, D] fp32.
int gx_flash_bwd_dq(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                    GxSeqOperand dout, const float* lse, const float* delta,
                    GxAttnDims dims, float* dq, cudaStream_t stream);
// Backward, dk/dv: -> dk, dv [B, Lk, H, D] fp32.
int gx_flash_bwd_dkv(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                     GxSeqOperand dout, const float* lse, const float* delta,
                     GxAttnDims dims, float* dk, float* dv,
                     cudaStream_t stream);
// One ring hop: the carries m_in, l_in [B, H, Lq] and o_in [B, Lq, H, D]
// (fp32, contiguous) -> m_out, l_out, o_out alike; o stays un-normalised.
int gx_ring_hop(GxSeqOperand q, GxSeqOperand k, GxSeqOperand v,
                const float* m_in, const float* l_in, const float* o_in,
                GxAttnDims dims, float* m_out, float* l_out, float* o_out,
                cudaStream_t stream);

#ifdef __cplusplus
}
#endif
