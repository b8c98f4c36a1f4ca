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
// element) and writes the sum (4 B).
// quantize: a thread owns four neighbouring lanes of one 2,048-element
// block row, so four words.  For each j it loads g and r at row*2048 +
// 4q + 128*j as 16-byte quads (a warp covers one block row, neighbours on
// neighbouring 16 bytes), all 32 loads issued before its first store; then
// it stores r' as 16 quads and its four words as one 16-byte store.  g,
// r and r' carry streaming cache hints: nothing reads them again in the
// step.  The words go out with the default policy, since the all-gather
// and the dequantize read them next.  That is 49 memory instructions for
// 64 elements.  Where n % 4 != 0 or an operand is off 16-byte alignment,
// the same kernel runs the same (row, quad) units element by element (the
// vec flag).  One launch covers every replica row: one unit a thread, in
// one pass.
// dequantize: a thread owns one quad's four lanes at kDequantJs = 4
// neighbouring j of the 16, so the four warps of one block row split its
// 16 rows of 128 elements (137,216 threads at path 2's shape, as many as
// one thread a word, with a quarter of the memory instructions).  It loads
// each part's four words as one 16-byte int4, two parts' loads in flight
// before their adds, folds the parts in party order with __fadd_rn from
// -0.0f (-0 + v is v exactly for every v, -0 and +0 included, so the
// sum's bits are the plain version's, which starts from part 0), and
// stores its sums as four float4 quads at row*n + 4q + 128*j: a warp
// writes 512 contiguous bytes for each j, with the default policy (the
// optimizer reads the sum next; streaming stores measured slower).  The same vec flag and element-by-element fallback as
// quantize (n % 4 != 0, or packed or out off 16-byte alignment).  The
// sizes (kDequantJs, kPartsInFlight, kDequantThreads) were chosen by
// timing edited copies with tools/torch_wide_variants.py --kernels plane.
#include <stdint.h>

#include "geomx_kernels.h"

namespace {

constexpr int kLanes = 128;
constexpr int kPack = 16;
constexpr int kBlockCols = kPack * kLanes;  // 2048 elements -> 128 words
constexpr int kQuantThreads = 128;     // quantize block
constexpr int kQuadWords = 4;          // words (lanes) a unit
constexpr int kUnitsPerBlockRow = kLanes / kQuadWords;  // 32: one warp

constexpr int kDequantJs = 4;        // j a dequantize thread, of kPack
constexpr int kJGroups = kPack / kDequantJs;
constexpr int kPartsInFlight = 2;    // parts loaded before their adds
constexpr int kDequantThreads = 128;  // dequantize block
static_assert(kPack % kDequantJs == 0, "a thread's j divide the 16");

// the element of word 0 at j = 0 of quad q of a replica row: its four
// lanes lie in block row q / 32
__device__ __forceinline__ int unit_first(int q) {
  return (q / kUnitsPerBlockRow) * kBlockCols +
         kQuadWords * (q % kUnitsPerBlockRow);
}

__device__ __forceinline__ float code_value(unsigned code, float thr) {
  return code == 1u ? thr : (code == 2u ? -thr : 0.0f);
}

// One (row, quad) unit: the words w[0 .. 3] and their 64 elements from
// row + first (word 0's lane at j = 0).  kVec: 16-byte accesses (n % 4 ==
// 0, every operand aligned), so a quad of elements lies wholly below n or
// wholly past it; else element by element.  Every load is issued before
// the first store.  g, r and r' carry streaming hints (touched once a
// step); the words do not (the all-gather and dequantize read them next).
template <bool kVec>
__device__ __forceinline__ void quantize_unit(
    const float* __restrict__ g, const float* __restrict__ r, int n,
    long long row, int first, float thr, float* __restrict__ new_r,
    int* __restrict__ w) {
  float acc[kPack][4];
#pragma unroll
  for (int j = 0; j < kPack; ++j) {
    const int i = first + j * kLanes;
    if (kVec) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (i < n) {
        x = __ldcs(reinterpret_cast<const float4*>(g + row + i));
        y = __ldcs(reinterpret_cast<const float4*>(r + row + i));
      }
      acc[j][0] = __fadd_rn(x.x, y.x);
      acc[j][1] = __fadd_rn(x.y, y.y);
      acc[j][2] = __fadd_rn(x.z, y.z);
      acc[j][3] = __fadd_rn(x.w, y.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = i + e < n ? __fadd_rn(__ldcs(g + row + i + e),
                                          __ldcs(r + row + i + e))
                              : 0.0f;  // code 0 past n
      }
    }
  }
  unsigned bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kPack; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = acc[j][e];
      const unsigned code = a >= thr ? 1u : (a <= -thr ? 2u : 0u);
      acc[j][e] = __fsub_rn(a, code_value(code, thr));
      bits[e] |= code << (2 * j);
    }
  }
#pragma unroll
  for (int j = 0; j < kPack; ++j) {
    const int i = first + j * kLanes;
    if (kVec) {
      if (i < n) {
        __stcs(reinterpret_cast<float4*>(new_r + row + i),
               make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) __stcs(new_r + row + i + e, acc[j][e]);
      }
    }
  }
  if (kVec) {
    *reinterpret_cast<int4*>(w) =
        make_int4(static_cast<int>(bits[0]), static_cast<int>(bits[1]),
                  static_cast<int>(bits[2]), static_cast<int>(bits[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = static_cast<int>(bits[e]);
  }
}

// one unit a thread: unit u is row u / quads, quad u % quads, whose four
// lanes lie in block row q / 32
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const float* __restrict__ g, const float* __restrict__ r,
                int n, int words, int units, int vec, float thr,
                int* __restrict__ packed, float* __restrict__ new_r) {
  const int u = blockIdx.x * kQuantThreads + threadIdx.x;
  if (u >= units) return;
  const int quads = words / kQuadWords;
  const int q = u % quads;
  const long long row = static_cast<long long>(u / quads) * n;
  int* w = packed + static_cast<long long>(u / quads) * words + kQuadWords * q;
  if (vec) {
    quantize_unit<true>(g, r, n, row, unit_first(q), thr, new_r, w);
  } else {
    quantize_unit<false>(g, r, n, row, unit_first(q), thr, new_r, w);
  }
}

// One unit of the summed dequantize: quad q's four lanes at kDequantJs
// neighbouring j from j0.  src is the row's part 0 at the quad's four
// words (part a at src + a * words), out the row's first element, first
// the element of word 0 at j0.  kVec: 16-byte loads and stores.
template <bool kVec>
__device__ __forceinline__ void dequantize_unit(
    const int* __restrict__ src, int parts, int words, int n, int j0,
    int first, float thr, float* __restrict__ out) {
  float acc[kDequantJs][4];
#pragma unroll
  for (int j = 0; j < kDequantJs; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = -0.0f;  // the identity of +
  }
  for (int a0 = 0; a0 < parts; a0 += kPartsInFlight) {
    unsigned bits[kPartsInFlight][4];
#pragma unroll
    for (int b = 0; b < kPartsInFlight; ++b) {
      if (a0 + b < parts) {
        const int* p = src + static_cast<long long>(a0 + b) * words;
        if (kVec) {
          const int4 x = __ldg(reinterpret_cast<const int4*>(p));
          bits[b][0] = static_cast<unsigned>(x.x);
          bits[b][1] = static_cast<unsigned>(x.y);
          bits[b][2] = static_cast<unsigned>(x.z);
          bits[b][3] = static_cast<unsigned>(x.w);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bits[b][e] = static_cast<unsigned>(__ldg(p + e));
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kPartsInFlight; ++b) {
      if (a0 + b < parts) {
#pragma unroll
        for (int j = 0; j < kDequantJs; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned code = (bits[b][e] >> (2 * (j0 + j))) & 3u;
            acc[j][e] = __fadd_rn(acc[j][e], code_value(code, thr));
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDequantJs; ++j) {
    const int i = first + j * kLanes;
    if (kVec) {
      if (i < n) {
        *reinterpret_cast<float4*>(out + i) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) out[i + e] = acc[j][e];
      }
    }
  }
}

// unit u: lane u % 32 of a warp; the warp's j group, block row and replica
// row from u / 32 (j group fastest), so a warp's 32 threads take one block
// row's 32 quads and store 512 contiguous bytes for each j; the kJGroups
// warps of one block row load the same 512 bytes of words a part
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const int* __restrict__ packed, int parts, int words,
                  int n, int units, int vec, float thr,
                  float* __restrict__ out) {
  const int u = blockIdx.x * kDequantThreads + threadIdx.x;
  if (u >= units) return;
  const int lane = u % kUnitsPerBlockRow;
  const int warp = u / kUnitsPerBlockRow;
  const int j0 = (warp % kJGroups) * kDequantJs;
  const int brows = words / kLanes;
  const int brow = (warp / kJGroups) % brows;
  const long long row = warp / kJGroups / brows;
  const int q = brow * kUnitsPerBlockRow + lane;
  const int* src = packed + row * parts * words + kQuadWords * q;
  const int first = unit_first(q) + j0 * kLanes;
  if (vec) {
    dequantize_unit<true>(src, parts, words, n, j0, first, thr,
                          out + row * n);
  } else {
    dequantize_unit<false>(src, parts, words, n, j0, first, thr,
                           out + row * n);
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
  const long long units = static_cast<long long>(rows) * (words / kQuadWords);
  if (units > 0x3fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec =
      n % 4 == 0 && a16(g) && a16(r) && a16(new_r) && a16(packed);
  const int blocks =
      static_cast<int>((units + kQuantThreads - 1) / kQuantThreads);
  quantize_kernel<<<blocks, kQuantThreads, 0, stream>>>(
      g, r, n, words, static_cast<int>(units), vec, thr, packed, new_r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gx_dequantize_2bit(const int* packed, int rows, int parts,
                                  int n, float thr, float* out,
                                  cudaStream_t stream) {
  if (rows <= 0 || parts <= 0 || n <= 0) return 0;
  const int words = gx_twobit_words(n);
  const long long units =
      static_cast<long long>(rows) * (words / kQuadWords) * kJGroups;
  if (units > 0x3fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks =
      static_cast<int>((units + kDequantThreads - 1) / kDequantThreads);
  dequantize_kernel<<<blocks, kDequantThreads, 0, stream>>>(
      packed, parts, words, n, static_cast<int>(units), vec, thr, out);
  return static_cast<int>(cudaGetLastError());
}
