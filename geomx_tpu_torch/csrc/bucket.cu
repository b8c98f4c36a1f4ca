// Bucket flatten / unflatten: one multi-tensor copy launch per direction.
//
// Replaces geomx_tpu/ops/bucket_pallas.py fused_flatten (_flatten_kernel)
// and fused_unflatten (_unflatten_kernel), which issue one async DMA per
// leaf inside one TPU kernel.  Here every (leaf, replica row) pair and every
// bucket tail pad is one entry of a table passed by value in the kernel's
// parameter space (GxCopyTable): gradient tensors are new on every
// backward, so a device-side pointer table built once would go stale.
//
// Bound: bytes.  Each element is read once and written once (a pad entry
// only writes), so the least time is (read + written bytes) / HBM rate.
// Design for that: blocks are laid out over the concatenation of the
// entries (prefix sums in block_start), so no block idles on a short leaf;
// neighbouring threads touch neighbouring floats, so loads and stores
// coalesce.  Leaf offsets inside a bucket are arbitrary, so the copy stays
// scalar (no 16-byte vector accesses) in this first version.
#include "geomx_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
bucket_copy_kernel(const GxCopyTable t) {
  const int b = blockIdx.x;
  // the entry this block works on: largest e with block_start[e] <= b
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const long long n = t.n[lo];
  const float* __restrict__ src = t.src[lo];
  float* __restrict__ dst = t.dst[lo];
  const long long base = static_cast<long long>(b - t.block_start[lo]) * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < n) dst[i] = src != nullptr ? src[i] : 0.0f;
  }
}

}  // namespace

extern "C" int gx_bucket_tile(void) { return kTile; }

extern "C" int gx_bucket_copy(const GxCopyTable* table, cudaStream_t stream) {
  if (table->count <= 0 || table->total_blocks <= 0) return 0;
  bucket_copy_kernel<<<table->total_blocks, kThreads, 0, stream>>>(*table);
  return static_cast<int>(cudaGetLastError());
}
