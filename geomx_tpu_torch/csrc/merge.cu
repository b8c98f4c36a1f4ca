// Sorted-index segment-sum merge for Hopper.
//
// Replaces geomx_tpu/ops/merge_pallas.py merge_sorted_pairs(fused=True)
// (_merge_tree_pallas, _merge_kernel): over an index-sorted pair column
// (svals fp32, skey int32 with -1 sentinels mapped to INT32_MAX), run the
// fixed combining tree of `rounds` passes — in pass r (d = 2^r) the
// element at in-segment rank s with s % 2d == 0 absorbs its neighbour at
// +d when that neighbour has the same key and the key is not the sentinel
// — and write each segment's total at its head (rank 0), (0.0, -1)
// everywhere else.  The merged bits are defined as that tree.
//
// The TPU kernel holds the whole column in VMEM, with the in-segment ranks
// computed beforehand, and shifts it `rounds` times.  Here the kernel
// needs no ranks: only heads write a total, a position is a head exactly
// when it is column 0 or its key differs from the one before (the key
// before column 0 is -2 in segment_ranks, and keys are >= 0 or INT32_MAX),
// and inside a segment the head's neighbour j has rank j.  A block owns a
// tile of kThreads positions of one row and stages its keys and values in
// shared memory with coalesced loads, with a halo of one key before the
// tile and 2^rounds - 1 positions after it, cut at the row's end (reading
// the same columns straight from device memory measured slower).  One
// thread a position: a non-head, or a sentinel head, writes the sentinel pair; a
// head reads the 2^rounds - 1 positions after it (the entries of its
// segment that the tree can reach are contiguous after the sort), all
// before it finds the segment's length, and applies the same pairwise
// combines in the same order: the value at offset s after pass r is the
// tree over [s, s + 2d) cut at the segment's end, exactly what the
// shifted column holds at the head's rank s.  Entries past 2^rounds never
// reach the head, as in the tree, so a segment longer than max_duplicates
// keeps only its first 2^rounds entries.  Only adds, written as __fadd_rn
// so the order stands in the source.  `rounds` is a template parameter
// (0..GX_MERGE_MAX_ROUNDS) so the register arrays are indexed statically.
// One launch covers every [rows, m] position.
//
// Bound: bytes.  Every position's key and value are read once and its
// output pair written once (16 B a pair); the halo's rereads come from
// the neighbouring tile's lines in L2.  At the path's 8 x 5,484 pairs the
// work is far below launch latency.  The block size was chosen by timing
// edited copies with tools/torch_wide_variants.py --kernels plane.
#include "geomx_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSentinelKey = 0x7fffffff;  // merge_pallas.py SENTINEL_KEY
constexpr int kBeforeFirst = -2;          // segment_ranks' key before col 0

static_assert(kThreads >= (1 << GX_MERGE_MAX_ROUNDS),
              "the halo is staged by one pass of the block's threads");

// block b: row b / tiles, positions [tile * kThreads, + kThreads) of it
template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
merge_tree_kernel(const float* __restrict__ svals,
                  const int* __restrict__ skey, int m, int tiles,
                  float* __restrict__ out_vals, int* __restrict__ out_idx) {
  constexpr int kSpan = 1 << ROUNDS;
  const long long row = static_cast<long long>(blockIdx.x / tiles) * m;
  const int start = (blockIdx.x % tiles) * kThreads;
  // positions of the tile and its halo, cut at the row's end
  const int staged = min(kThreads + kSpan - 1, m - start);
  const int t = threadIdx.x;
  // keys[c]: column start - 1 + c; vals[c]: column start + c
  __shared__ int keys[kThreads + kSpan];
  __shared__ float vals[kThreads + kSpan - 1];
  // thread t stages keys[t], vals[t] and, for t < kSpan, the halo's
  // keys[kThreads + t], vals[kThreads + t]: every load issued before the
  // first store to shared memory, so the tile costs one round trip
  const int h = kThreads + t;
  const bool has_key = t <= staged, has_val = t < staged;
  const bool halo_key = t < kSpan && h <= staged;
  const bool halo_val = t < kSpan - 1 && h < staged;
  int k0 = kBeforeFirst, k1 = 0;
  float v0 = 0.0f, v1 = 0.0f;
  if (has_key && start + t > 0) k0 = skey[row + start - 1 + t];
  if (has_val) v0 = svals[row + start + t];
  if (halo_key) k1 = skey[row + start - 1 + h];
  if (halo_val) v1 = svals[row + start + h];
  if (has_key) keys[t] = k0;
  if (has_val) vals[t] = v0;
  if (halo_key) keys[h] = k1;
  if (halo_val) vals[h] = v1;
  __syncthreads();
  if (t >= staged) return;
  const long long i = row + start + t;
  const int key = keys[t + 1];
  if (keys[t] == key || key == kSentinelKey) {
    out_vals[i] = 0.0f;
    out_idx[i] = -1;
    return;
  }
  // a head: the next kSpan - 1 positions of its row, all read before the
  // segment's length is found; the tree reads a[j] only for j < len
  const int reach = min(kSpan, staged - t);
  float a[kSpan];
  int k[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    a[j] = j < reach ? vals[t + j] : 0.0f;
    k[j] = j < reach ? keys[t + 1 + j] : kBeforeFirst;
  }
  int len = 1;
#pragma unroll
  for (int j = 1; j < kSpan; ++j) {
    if (len == j && k[j] == key) len = j + 1;
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int d = 1 << r;
#pragma unroll
    for (int s = 0; s + d < kSpan; s += 2 * d) {
      if (s + d < len) a[s] = __fadd_rn(a[s], a[s + d]);
    }
  }
  out_vals[i] = a[0];
  out_idx[i] = key;
}

template <int ROUNDS>
int launch(const float* svals, const int* skey, int rows, int m,
           float* out_vals, int* out_idx, cudaStream_t stream) {
  const int tiles = (m + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(rows) * tiles;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  merge_tree_kernel<ROUNDS><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(svals, skey, m, tiles, out_vals,
                                        out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_merge_sorted_pairs(const float* svals, const int* skey,
                                     int rows, int m, int rounds,
                                     float* out_vals, int* out_idx,
                                     cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return 0;
  switch (rounds) {
    case 0: return launch<0>(svals, skey, rows, m, out_vals, out_idx, stream);
    case 1: return launch<1>(svals, skey, rows, m, out_vals, out_idx, stream);
    case 2: return launch<2>(svals, skey, rows, m, out_vals, out_idx, stream);
    case 3: return launch<3>(svals, skey, rows, m, out_vals, out_idx, stream);
    case 4: return launch<4>(svals, skey, rows, m, out_vals, out_idx, stream);
    case 5: return launch<5>(svals, skey, rows, m, out_vals, out_idx, stream);
    case 6: return launch<6>(svals, skey, rows, m, out_vals, out_idx, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
