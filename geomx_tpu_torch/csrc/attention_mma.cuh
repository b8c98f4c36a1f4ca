// Tensor-core pieces of the attention kernels for Hopper (sm_90a): the
// flash backward (flash_attention_dq.cu, flash_attention_dkv.cu) and,
// through attention_fwd.cuh, the forward and the ring hop: the wgmma
// wrappers, the split-TF32 operands, the shared-memory layout wgmma
// reads, the fragment maps and the cp.async tile staging.
//
// Products.  wgmma.mma_async .m64nNk8.f32.tf32.tf32: a warpgroup (128
// threads) multiplies a 64-row A (from shared memory, or from registers)
// by an N-column B (always from shared memory) 8 deep, into fp32
// accumulators in registers.  fp32 accuracy comes from the 3xTF32 split:
// x = hi + lo with hi = tf32(x) (round to nearest) and lo = x - hi (of
// which the tensor cores read the top TF32 bits), and a b = hi_a hi_b +
// hi_a lo_b + lo_a hi_b (the lo lo term is below fp32's last bits); a
// bf16 operand is exact in TF32, so its lo is zero and its products are
// dropped (parts() = 1).  The tensor cores' fp32 sums truncate, so the
// kernels add each tile's sum into their totals in round-to-nearest.
//
// Shared-memory operands.  For 32-bit types both wgmma operands must be
// K-major (the depth contiguous): there is no transpose flag.  A tile of
// R rows and depth Kd is stored without swizzle as 8-row x 16-byte "core
// matrices" (8 rows x 4 floats, 128 contiguous bytes), the core matrices
// of one 8-row group side by side along the depth (kmaj()).  The
// descriptor's leading offset is then the depth step between core
// matrices (128 bytes), its stride offset the step between 8-row groups
// (Kd * 32 bytes), and one k8 step advances the start by 256 bytes.
//
// Register A operands.  A product whose depth is the row dimension of a
// score tile (P^T dO and dS^T Q for dk/dv, dS K for dq, P V for the
// forward) takes the scores
// from the accumulators of the first product: thread (warp w, lane 4g+t)
// holds accumulator elements (16w + g [+8], 8i + 2t [+1]), and a tf32 A
// fragment of depth chunk i holds (16w + g [+8], t [+4]).  Reading depth
// slot s of chunk i as column 8i + pi(s), pi = (0 2 4 6 1 3 5 7), turns
// the accumulators into A fragments without a shuffle: a = (d[4i], d[4i+2],
// d[4i+1], d[4i+3]).  The B operand of such a product is staged with its
// depth (the row index of the tile) permuted the same way (slot()): a
// permutation applied to both operands' depth leaves the product as it is.
// (PTX ISA, "Register fragments and shared memory matrix layouts" of
// wgmma .m64nNk8.)
//
// Staging.  The streamed operands come through shared memory with
// cp.async (16-byte copies, zero-filled past the sequence end), double
// buffered, so the next tile's copy overlaps this tile's products; a
// conversion pass then splits each landed tile, once for all the 64-row
// groups the block owns, into the layouts above.  The operands' [B, L, H,
// D] strides are arbitrary, and a tile is a few KB: a TMA descriptor per
// call (cuTensorMapEncodeTiled, host-side, from libcuda) would buy nothing
// at this size, so there is none.  Where a stride or the base is not
// 16-byte aligned the same staging falls back to plain loads.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "geomx_kernels.h"

namespace gx_mma {

constexpr int kThreads = 128;  // one warpgroup a block
constexpr int kRows = 64;      // rows a warpgroup owns: wgmma's M
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr int parts() { return sizeof(T) == 4 ? 2 : 1; }

// float offset of element (r, k) of a K-major tile of depth Kd
__device__ __forceinline__ int kmaj(int r, int k, int Kd) {
  return (r >> 3) * (Kd * 8) + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

// the depth slot of row r of a tile that is a B operand of depth = rows:
// within each 8, rows 0 2 4 6 go to slots 0-3 and rows 1 3 5 7 to 4-7
__device__ __forceinline__ int slot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// descriptor of a K-major tile of depth Kd (no swizzle) at p, in shared
// memory: 14-bit start, leading and stride byte offsets, all >> 4.  Its
// low word (start and leading offset) depends on p alone, its high word
// (stride offset) on Kd alone; a start below 256 KB plus a few KB stays in
// its 14 bits, so a step along a tile adds to the low word alone.
__device__ __forceinline__ uint32_t desc_lo(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3ffff) >> 4) | ((128 >> 4) << 16);
}
__host__ __device__ constexpr uint64_t desc_hi(int Kd) {
  return static_cast<uint64_t>((Kd * 32) >> 4) << 32;
}
__device__ __forceinline__ uint64_t desc(const float* p, int Kd) {
  return desc_hi(Kd) | desc_lo(p);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads and writes across an
// asynchronous product
template <int K>
__device__ __forceinline__ void reg_fence(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 8] B[8 x N] in TF32, fp32 accumulators d (the
// thread's N / 2 elements): ss takes A from shared memory by descriptor,
// rs from registers (a tf32 A fragment); acc = 0 overwrites d.  The score
// products use N = 16, 32, 64 (ss), the gradient products N = D (rs).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void rs(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(acc));
  }
};


// ---- split-TF32 -----------------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every value but NaN, in two integer operations
// (on the H100 the cvt measured 8% slower in the flash forward, which
// splits every probability it multiplies)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x) rounded to nearest; lo = x - hi exactly, left in fp32: the
// tensor cores read its top 11 bits, an error of at most 2^-21 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the A fragment of depth chunk i from the accumulators d of a score tile
// (the slot permutation of the header note), split hi and lo
template <int K>
__device__ __forceinline__ void a_frag(const float (&d)[K], int i,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(d[4 * i], hi[0], lo[0]);
  split(d[4 * i + 2], hi[1], lo[1]);
  split(d[4 * i + 1], hi[2], lo[2]);
  split(d[4 * i + 3], hi[3], lo[3]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- operands ---------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two consecutive output elements, rounded to nearest for bf16
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const GxSeqOperand& t, int b,
                                            int l, int h) {
  return static_cast<const T*>(t.ptr) + b * t.sb + l * t.sl + h * t.sh;
}

// 16-byte aligned base and strides: the tiles can come by cp.async
template <typename T>
inline bool aligned16(const GxSeqOperand& t) {
  const long long e = sizeof(T);
  return reinterpret_cast<uintptr_t>(t.ptr) % 16 == 0 && t.sb * e % 16 == 0 &&
         t.sl * e % 16 == 0 && t.sh * e % 16 == 0;
}

// x split into hi and (P = 2, fp32) lo
template <int P>
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (P == 2) {
      split(x[c], h[c], l[c]);
    } else {
      h[c] = __float_as_uint(x[c]);  // bf16: exact in TF32
      l[c] = 0u;
    }
  }
}

// 4 consecutive depth elements of one row at float offset off of a K-major
// tile: its hi part, and (P = 2) its lo part
template <int P>
__device__ __forceinline__ void store4(const uint32_t (&h)[4],
                                       const uint32_t (&l)[4], float* hi,
                                       float* lo, int off) {
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  if (P == 2) {
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Splits the N floats at hi in place into their TF32 hi parts, the lo
// parts going to hi + N (16-byte accesses in order: no bank conflicts)
template <int N>
__device__ __forceinline__ void split_tile(float* hi) {
#pragma unroll
  for (int n = 0; n < N / 4 / kThreads; ++n) {
    const unsigned i = threadIdx.x + n * kThreads;
    const float4 x = reinterpret_cast<const float4*>(hi)[i];
    const float x4[4] = {x.x, x.y, x.z, x.w};
    uint32_t h4[4], l4[4];
    split4<2>(x4, h4, l4);
    store4<2>(h4, l4, hi, hi + N, 4 * i);
  }
}

// rows [l0, l0 + R) of head (b, h) of t (zeros past len) into the K-major
// [R][D] tile hi (and lo): the operand a block keeps
template <typename T, int D, int R>
__device__ __forceinline__ void load_fixed(const GxSeqOperand& t, int b,
                                           int h, int l0, int len, float* hi,
                                           float* lo) {
  for (int i = threadIdx.x; i < R * D / 4; i += kThreads) {
    const int r = i / (D / 4), d0 = i % (D / 4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (l0 + r < len) {
      const T* p = row_ptr<T>(t, b, l0 + r, h) + d0;
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = to_f32(p[c]);
    }
    uint32_t h4[4], l4[4];
    split4<parts<T>()>(x, h4, l4);
    store4<parts<T>()>(h4, l4, hi, lo, kmaj(r, d0, D));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// all of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The 16-byte chunk of staged row r at which chunk c of that row lies: fp32
// rows are XOR-swizzled so that 8 consecutive rows' chunk c, and one row's
// 8 consecutive chunks, fall in 8 different bank quads (no conflicts on the
// copies in or the conversion's reads); bf16 rows are packed.
template <typename T, int D>
__device__ __forceinline__ int raw_chunk(int r, int c) {
  constexpr int G = D * static_cast<int>(sizeof(T)) / 16;  // chunks a row
  if constexpr (sizeof(T) != 4) return r * G + c;
  const int swz = G >= 8 ? (r & 7) : ((r * G / 8) & (G - 1));
  return r * G + (c ^ swz);
}

// Starts the copies of rows [l0, l0 + R) of head (b, h) of t into raw (R
// rows of D elements of T, chunks at raw_chunk()), zeros past len: 16-byte
// cp.async where the operand is aligned, plain loads otherwise.
template <typename T, int D, int R>
__device__ __forceinline__ void stage_rows(const GxSeqOperand& t, int b,
                                           int h, int l0, int len,
                                           bool async16, T* raw) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = D / E;     // chunks a row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = l0 + r < len;
    const T* src = live ? row_ptr<T>(t, b, l0 + r, h) + c * E
                        : static_cast<const T*>(t.ptr);
    T* dst = raw + raw_chunk<T, D>(r, c) * E;
    if (async16) {
      cp_async16(dst, src, live);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dst[e] = live ? src[e] : T();
      }
    }
  }
}

// [R] fp32 values at src + l0 (zeros past len) into dst, by 4-byte cp.async
__device__ __forceinline__ void stage_vec(const float* src, int l0, int len,
                                          int R, float* dst) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool live = l0 + i < len;
    cp_async4(dst + i, live ? src + l0 + i : src, live);
  }
}

// x = elements 4 g .. 4 g + 3 of staged row r
template <typename T, int D>
__device__ __forceinline__ void load4(const T* raw, int r, int g,
                                      float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v =
        reinterpret_cast<const float4*>(raw)[raw_chunk<T, D>(r, g)];
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const uint2 v = reinterpret_cast<const uint2*>(raw)[r * (D / 4) + g];
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x, x[1] = a.y, x[2] = c.x, x[3] = c.y;
  }
}

// The conversion of one group: x = elements 4 g .. 4 g + 3 of row r, split
// and stored into nat and tr, each where given.  rot: the lane's rotation.
template <int P, int D, int R>
__device__ __forceinline__ void convert_group(const float (&x)[4], int r,
                                              int g, float* nat, float* tr,
                                              int rot) {
  uint32_t h[4], l[4];
  split4<P>(x, h, l);
  if (nat != nullptr) store4<P>(h, l, nat, nat + R * D, kmaj(r, 4 * g, D));
  if (tr == nullptr) return;
  // lane stores element (c + rot) % 4 at step c: rotate h, l by rot
  uint32_t a[4], b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c] = rot & 1 ? h[(c + 1) & 3] : h[c];
    b[c] = rot & 1 ? l[(c + 1) & 3] : l[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    h[c] = rot & 2 ? a[(c + 2) & 3] : a[c];
    l[c] = rot & 2 ? b[(c + 2) & 3] : b[c];
  }
  const int base = kmaj(4 * g, slot(r), R);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int off = base + 4 * ((c + rot) & 3);
    tr[off] = __uint_as_float(h[c]);
    if (P == 2) tr[R * D + off] = __uint_as_float(l[c]);
  }
}

// the group (row, g) thread i converts, and the lane's rotation
template <int D>
__device__ __forceinline__ int group_row(int i) {
  return i / (8 * (D / 4)) * 8 + i % 8;
}
template <int D>
__device__ __forceinline__ int group_col(int i) {
  return i / 8 % (D / 4);
}
__device__ __forceinline__ int lane_rot() {
  const int lane = threadIdx.x % 32;
  return ((lane >> 3) & 2) | (lane & 1);
}

// Splits the staged [R][D] tile raw into the K-major operand tiles, each
// where given: nat ([R][D], the tile as it is) and tr ([D][R], the rows
// as depth in slot() order).  Each of the P parts (hi, lo) of a layout is
// R * D floats, the parts back to back.  Thread i takes 4 consecutive
// depth elements of one row, 8 consecutive i 8 consecutive rows, so the
// 16-byte stores of nat fill whole 128-byte lines; the 4-byte stores of
// tr go element by element, each lane starting at another of its 4 (rot),
// so a warp's 32 stores fall in 32 different banks.
template <typename T, int D, int R>
__device__ __forceinline__ void convert(const T* raw, float* nat, float* tr) {
  const int rot = lane_rot();
  for (int i = threadIdx.x; i < R * D / 4; i += kThreads) {
    const int r = group_row<D>(i), g = group_col<D>(i);
    float x[4];
    load4<T, D>(raw, r, g, x);
    convert_group<parts<T>(), D, R>(x, r, g, nat, tr, rot);
  }
}

// lets kernel take bytes of dynamic shared memory (above the 48 KB default);
// set before every launch, since the attribute is per kernel and device
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace gx_mma
