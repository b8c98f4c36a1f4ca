// Fused optimizer apply over flat fp32 buckets for Hopper.
//
// fused_sgd_momentum replaces geomx_tpu/ops/optim_pallas.py
// fused_sgd_momentum (_sgd_kernel):  m' = momentum*m + g;  p' = p - lr*m'.
// fused_adam replaces optim_pallas.py fused_adam (_adam_kernel), optax's
// op order:  m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*(g*g);
// p' = p - lr * ((m'/bc1) / (sqrt(v'/bc2) + eps)), with the bias
// corrections bc = 1 - b**t passed in as scalars.  Both optionally write a
// bf16 copy of p' (the TPU kernel's cast_dtype output).
//
// Every op rounds on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn):
// nvcc would contract b1*m + (1-b1)*g and p - lr*m' into FMAs, which round
// once instead of twice and so differ from the plain PyTorch version.  The
// division and square root are IEEE-rounded (no fast math).
//
// Bound: bytes.  SGD reads p, g, m and writes p', m' (20 B an element),
// Adam reads p, g, m, v and writes p', m', v' (28 B), plus 2 B for the bf16
// copy; the arithmetic is a few flops an element, far below the card's
// rate.  Design for that: one pass, each element read and written once;
// every thread handles kItems elements kThreads apart, so neighbouring
// threads touch neighbouring floats and every access coalesces; one launch
// covers every replica row of a bucket.  The TPU kernel updates in place
// through input_output_aliases; here the outputs are fresh buffers, which
// moves the same bytes and leaves the caller's state valid.
#include <cuda_bf16.h>

#include "geomx_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
sgd_kernel(const float* __restrict__ p, const float* __restrict__ g,
           const float* __restrict__ m, long long n, float lr, float momentum,
           float* __restrict__ new_p, float* __restrict__ new_m,
           __nv_bfloat16* __restrict__ cast) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         threadIdx.x;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads;
    if (i < n) {
      const float m2 = __fadd_rn(__fmul_rn(momentum, m[i]), g[i]);
      const float p2 = __fsub_rn(p[i], __fmul_rn(lr, m2));
      new_m[i] = m2;
      new_p[i] = p2;
      if (cast != nullptr) cast[i] = __float2bfloat16_rn(p2);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ p, const float* __restrict__ g,
            const float* __restrict__ m, const float* __restrict__ v,
            long long n, float bc1, float bc2, float lr, float b1,
            float one_minus_b1, float b2, float one_minus_b2, float eps,
            float* __restrict__ new_p, float* __restrict__ new_m,
            float* __restrict__ new_v, __nv_bfloat16* __restrict__ cast) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         threadIdx.x;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads;
    if (i < n) {
      const float gi = g[i];
      const float m2 =
          __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gi));
      const float v2 = __fadd_rn(__fmul_rn(b2, v[i]),
                                 __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
      const float mh = __fdiv_rn(m2, bc1);
      const float vh = __fdiv_rn(v2, bc2);
      const float d = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps));
      const float p2 = __fsub_rn(p[i], __fmul_rn(lr, d));
      new_m[i] = m2;
      new_v[i] = v2;
      new_p[i] = p2;
      if (cast != nullptr) cast[i] = __float2bfloat16_rn(p2);
    }
  }
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kTile - 1) / kTile);
}

}  // namespace

extern "C" int gx_fused_sgd_momentum(const float* p, const float* g,
                                     const float* m, long long n, float lr,
                                     float momentum, float* new_p,
                                     float* new_m, void* cast_bf16,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  sgd_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      p, g, m, n, lr, momentum, new_p, new_m,
      static_cast<__nv_bfloat16*>(cast_bf16));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gx_fused_adam(const float* p, const float* g, const float* m,
                             const float* v, long long n, float bc1,
                             float bc2, float lr, float b1,
                             float one_minus_b1, float b2,
                             float one_minus_b2, float eps, float* new_p,
                             float* new_m, float* new_v, void* cast_bf16,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  adam_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      p, g, m, v, n, bc1, bc2, lr, b1, one_minus_b1, b2, one_minus_b2, eps,
      new_p, new_m, new_v, static_cast<__nv_bfloat16*>(cast_bf16));
  return static_cast<int>(cudaGetLastError());
}
