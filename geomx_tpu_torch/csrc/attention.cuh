// Shared pieces of the attention kernels (flash_attention.cu,
// flash_attention_dq.cu, flash_attention_dkv.cu, ring_hop.cu): the
// masking sentinel, the check of a call's shapes and the dispatch over
// the operands' type and head dim.  The tensor-core machinery is in
// attention_mma.cuh, the forward's tile body in attention_fwd.cuh.
#pragma once

#include <cuda_bf16.h>

#include "geomx_kernels.h"

namespace gx_attn {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' masking sentinel
// head elements of an output chunk on the wide route (attention_wide.cuh)
constexpr int kChunk = 128;

inline bool dims_ok(const GxAttnDims& dims) {
  return dims.B >= 0 && dims.H > 0 && dims.Lq >= 0 && dims.Lk >= 0 &&
         static_cast<long long>(dims.B) * dims.H <= 65535;
}

}  // namespace gx_attn

// return LAUNCH<T, D>(args...) for the operands' type and head dim, or
// cudaErrorInvalidValue for a head dim the kernels are not built for;
// head dims above 128 go to WIDE<T>(args...) (attention_wide.cuh)
#define GX_ATTN_CASE(DIM, LAUNCH, ...)                               \
  case DIM:                                                          \
    return dims.bf16 ? LAUNCH<__nv_bfloat16, DIM>(__VA_ARGS__)       \
                     : LAUNCH<float, DIM>(__VA_ARGS__);
#define GX_ATTN_DISPATCH(LAUNCH, WIDE, ...)                          \
  if (dims.D > gx_attn::kChunk) {                                    \
    if (dims.D % gx_attn::kChunk != 0) {                             \
      return static_cast<int>(cudaErrorInvalidValue);                \
    }                                                                \
    return dims.bf16 ? WIDE<__nv_bfloat16>(__VA_ARGS__)              \
                     : WIDE<float>(__VA_ARGS__);                     \
  }                                                                  \
  switch (dims.D) {                                                  \
    GX_ATTN_CASE(8, LAUNCH, __VA_ARGS__)                             \
    GX_ATTN_CASE(16, LAUNCH, __VA_ARGS__)                            \
    GX_ATTN_CASE(32, LAUNCH, __VA_ARGS__)                            \
    GX_ATTN_CASE(64, LAUNCH, __VA_ARGS__)                            \
    GX_ATTN_CASE(128, LAUNCH, __VA_ARGS__)                           \
    default:                                                         \
      return static_cast<int>(cudaErrorInvalidValue);                \
  }
