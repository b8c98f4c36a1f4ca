// Bucket flatten / unflatten: one multi-tensor copy launch per direction.
//
// Replaces geomx_tpu/ops/bucket_pallas.py fused_flatten (_flatten_kernel)
// and fused_unflatten (_unflatten_kernel), which issue one async DMA per
// leaf inside one TPU kernel.  Here every leaf, and every bucket tail pad,
// is one entry of a table passed by value in the kernel's parameter space
// (GxCopyTable): a 2-D copy of all its replica rows, with two source batch
// strides (a stride-0 worker dim reads one row for every worker) and the
// destination row stride.  Gradient tensors are new on every backward, so
// a device-side pointer table built once would go stale.
//
// Bound: bytes.  Each element is read once and written once (a pad entry
// only writes), so the least time is (read + written bytes) / HBM rate.
// Design for that: each row is cut into quads of 4 floats aligned to 16
// bytes in the destination (a partial one at each end), and the quads of
// all entries are concatenated and cut into tiles of 512 quads a block,
// so small leaves (a 16-float BatchNorm row) share a block with their
// neighbours instead of idling one.  A thread takes 2 quads a tile, 256
// threads apart (neighbouring threads on neighbouring 16-byte words), and
// issues both loads before its stores: 32 bytes in flight a thread (on
// the H100, inside the training step, 4 quads a thread measured 10%
// slower and 1 quad 7% slower than 2; PERF.md).  A
// whole quad whose source is co-aligned with its destination moves as one
// 16-byte load and store; a quad with another source alignment loads
// 4-byte words and stores 16 bytes; the partial quads go word by word.
#include <stdint.h>

#include "geomx_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 2;                    // quads a thread
constexpr int kTileQuads = kThreads * kQuads;  // quads a block

// the entry owning quad q: the largest e in [lo, hi] with e's unit_start
// <= q
__device__ __forceinline__ int entry_of(const GxCopyTable& t, long long q,
                                        int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.e[mid].unit_start <= q) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int word_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__global__ void __launch_bounds__(kThreads)
bucket_copy_kernel(const __grid_constant__ GxCopyTable t) {
  const long long q0 = static_cast<long long>(blockIdx.x) * kTileQuads;
  const long long qlast = min(q0 + kTileQuads, t.total_units) - 1;
  // most tiles lie inside one leaf: then no thread searches
  const int e0 = entry_of(t, q0, 0, t.count - 1);
  const bool one = e0 + 1 == t.count || t.e[e0 + 1].unit_start > qlast;
  const int e1 = one ? e0 : entry_of(t, qlast, e0 + 1, t.count - 1);
  float x[kQuads][4];
  float* dst[kQuads];
  int live[kQuads];  // bit c: column c of the quad lies in the row
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    live[j] = 0;
    dst[j] = nullptr;
    const long long q = q0 + j * kThreads + threadIdx.x;
    if (q > qlast) continue;
    const GxCopy& c = t.e[one ? e0 : entry_of(t, q, e0, e1)];
    const int local = static_cast<int>(q - c.unit_start);
    const int r = local / c.units;
    float* drow = c.dst + r * c.dst_stride;
    const int c0 = 4 * (local - r * c.units) - word_of(drow);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c0 + i >= 0 && c0 + i < c.n) live[j] |= 1 << i;
    }
    dst[j] = drow + c0;
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = 0.0f;
    const float* srow = c.src;
    if (srow == nullptr || live[j] == 0) continue;
    const int r1 = r / c.inner;
    srow += r1 * c.src_outer + (r - r1 * c.inner) * c.src_inner;
    if (live[j] == 0xF && word_of(srow) == word_of(drow)) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(srow + c0));
      x[j][0] = w.x, x[j][1] = w.y, x[j][2] = w.z, x[j][3] = w.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (live[j] >> i & 1) x[j][i] = __ldg(srow + c0 + i);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    if (live[j] == 0xF) {
      *reinterpret_cast<float4*>(dst[j]) =
          make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (live[j] >> i & 1) dst[j][i] = x[j][i];
      }
    }
  }
}

}  // namespace

extern "C" int gx_bucket_tile(void) { return kTileQuads; }

extern "C" int gx_bucket_copy(const GxCopyTable* table, cudaStream_t stream) {
  if (table->count <= 0 || table->total_blocks <= 0) return 0;
  bucket_copy_kernel<<<table->total_blocks, kThreads, 0, stream>>>(*table);
  return static_cast<int>(cudaGetLastError());
}
