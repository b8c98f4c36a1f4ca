// 2-bit quantize (with error feedback) and dequantize for Hopper.
//
// quantize replaces geomx_tpu/ops/twobit_pallas.py quantize_2bit (_kernel):
// acc = g + r; code 1 where acc >= thr, 2 where acc <= -thr, else 0;
// r' = acc - sent with sent the code's value; 16 codes a 32-bit word.
// dequantize replaces twobit_pallas.py dequantize_2bit (_dequant_kernel):
// code -> {0, +thr, -thr}.  Here it also folds the parties' parts of the
// all-gathered wire in party order, ((p0 + p1) + p2) + ..., one fp32 add a
// part, which is how the JAX compressor sums its per-party dequantized
// vectors (compression/twobit.py _allreduce_pallas); no dense per-party
// intermediate goes through device memory.
//
// Wire format, the Pallas kernel's bit for bit: elements in rows of 2048;
// word (row, lane) packs elements row*2048 + lane + 128*j at bits 2j, j in
// [0, 16); ceil(n/2048)*128 words a replica row, zero codes past n.  The
// code is shifted as an unsigned int, so a code 2 at j = 15 sets the sign
// bit of the int32 word without a signed overflow.
//
// Bound: bytes.  quantize reads g, r and writes r' (12 B an element) plus
// the words (1/4 B an element); dequantize reads parts words (parts/4 B an
// element) and writes the sum (4 B).  Design for that: one thread a word.
// For each j the threads of a warp take 32 neighbouring lanes, so the
// element loads and stores at row*2048 + lane + 128*j coalesce, and so do
// the word stores; no shared memory, no second pass.  One launch covers
// every replica row (blockIdx.y).
#include "geomx_kernels.h"

namespace {

constexpr int kLanes = 128;
constexpr int kPack = 16;
constexpr int kBlockCols = kPack * kLanes;  // 2048 elements -> 128 words
constexpr int kThreads = 256;

__device__ __forceinline__ float code_value(unsigned code, float thr) {
  return code == 1u ? thr : (code == 2u ? -thr : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ g, const float* __restrict__ r,
                int n, int words, float thr, int* __restrict__ packed,
                float* __restrict__ new_r) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  const long long row = static_cast<long long>(blockIdx.y) * n;
  const int base = (w / kLanes) * kBlockCols + (w % kLanes);
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < kPack; ++j) {
    const int i = base + j * kLanes;
    if (i < n) {
      const float acc = g[row + i] + r[row + i];
      const unsigned code = acc >= thr ? 1u : (acc <= -thr ? 2u : 0u);
      new_r[row + i] = acc - code_value(code, thr);
      bits |= code << (2 * j);
    }
  }
  packed[static_cast<long long>(blockIdx.y) * words + w] =
      static_cast<int>(bits);
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int* __restrict__ packed, int parts, int words,
                  int n, float thr, float* __restrict__ out) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  const int* src = packed + static_cast<long long>(blockIdx.y) * parts * words;
  float acc[kPack];
  for (int a = 0; a < parts; ++a) {
    const unsigned bits = static_cast<unsigned>(src[static_cast<long long>(a) *
                                                        words + w]);
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      const float val = code_value((bits >> (2 * j)) & 3u, thr);
      acc[j] = a == 0 ? val : acc[j] + val;
    }
  }
  const long long row = static_cast<long long>(blockIdx.y) * n;
  const int base = (w / kLanes) * kBlockCols + (w % kLanes);
#pragma unroll
  for (int j = 0; j < kPack; ++j) {
    const int i = base + j * kLanes;
    if (i < n) out[row + i] = acc[j];
  }
}

}  // namespace

extern "C" int gx_twobit_words(int n) {
  const int blocks = (n + kBlockCols - 1) / kBlockCols;
  return (blocks > 0 ? blocks : 1) * kLanes;
}

extern "C" int gx_quantize_2bit(const float* g, const float* r, int rows,
                                int n, float thr, int* packed, float* new_r,
                                cudaStream_t stream) {
  if (rows <= 0 || n < 0) return 0;
  const int words = gx_twobit_words(n);
  const dim3 grid((words + kThreads - 1) / kThreads, rows);
  quantize_kernel<<<grid, kThreads, 0, stream>>>(g, r, n, words, thr, packed,
                                                 new_r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gx_dequantize_2bit(const int* packed, int rows, int parts,
                                  int n, float thr, float* out,
                                  cudaStream_t stream) {
  if (rows <= 0 || parts <= 0 || n <= 0) return 0;
  const int words = gx_twobit_words(n);
  const dim3 grid((words + kThreads - 1) / kThreads, rows);
  dequantize_kernel<<<grid, kThreads, 0, stream>>>(packed, parts, words, n,
                                                   thr, out);
  return static_cast<int>(cudaGetLastError());
}
