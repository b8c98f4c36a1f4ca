// Sorted-index segment-sum merge for Hopper.
//
// Replaces geomx_tpu/ops/merge_pallas.py merge_sorted_pairs(fused=True)
// (_merge_tree_pallas, _merge_kernel): over an index-sorted pair column
// (svals fp32, skey int32 with -1 sentinels mapped to INT32_MAX, rank the
// in-segment rank), run the fixed combining tree of `rounds` passes — in
// pass r (d = 2^r) the element at rank s with s % 2d == 0 absorbs its
// neighbour at +d when that neighbour has the same key and the key is not
// the sentinel — and write each segment's total at its head (rank 0),
// (0.0, -1) everywhere else.  The merged bits are defined as that tree.
//
// The TPU kernel holds the whole column in VMEM and shifts it `rounds`
// times.  Here one thread owns one position.  A non-head, or a sentinel
// head, writes the sentinel pair.  A head loads the entries of its segment
// that the tree can reach (at most 2^rounds, contiguous after the sort)
// into registers and applies the same pairwise combines in the same
// order: the value at offset s after pass r is the tree over [s, s + 2d)
// cut at the segment's end, exactly what the shifted column holds at the
// head's rank s.  Entries past 2^rounds never reach the head, as in the
// tree, so a segment longer than max_duplicates keeps only its first
// 2^rounds entries.  Only adds, written as __fadd_rn so the order stands
// in the source; there is no multiply for nvcc to contract.  `rounds` is
// a template parameter (0..GX_MERGE_MAX_ROUNDS) so the register array
// is indexed statically.  Rows are independent: one launch covers every
// [rows, m] position.
//
// Bound: bytes.  Every position's key and rank are read once and its
// output pair written once (20 B a pair with the value); heads reread at
// most 2^rounds - 1 neighbours, which the same warp has just loaded.  At
// the path's 8 x 5,484 pairs the work is far below launch latency.
#include "geomx_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSentinelKey = 0x7fffffff;  // merge_pallas.py SENTINEL_KEY

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
merge_tree_kernel(const float* __restrict__ svals, const int* __restrict__ skey,
                  const int* __restrict__ rank, long long total, int m,
                  float* __restrict__ out_vals, int* __restrict__ out_idx) {
  constexpr int kSpan = 1 << ROUNDS;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int key = skey[i];
  if (rank[i] != 0 || key == kSentinelKey) {
    out_vals[i] = 0.0f;
    out_idx[i] = -1;
    return;
  }
  // the entries of this head's segment within the tree's reach, inside
  // its own row
  const int col = static_cast<int>(i % m);
  const int reach = min(kSpan, m - col);
  float a[kSpan];
  a[0] = svals[i];
  int len = 1;
#pragma unroll
  for (int j = 1; j < kSpan; ++j) {
    a[j] = 0.0f;
    if (j < reach && len == j && skey[i + j] == key) {
      a[j] = svals[i + j];
      len = j + 1;
    }
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
int launch(const float* svals, const int* skey, const int* rank,
           long long total, int m, float* out_vals, int* out_idx,
           cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  merge_tree_kernel<ROUNDS><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(svals, skey, rank, total, m, out_vals,
                                        out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gx_merge_sorted_pairs(const float* svals, const int* skey,
                                     const int* rank, int rows, int m,
                                     int rounds, float* out_vals, int* out_idx,
                                     cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return 0;
  const long long total = static_cast<long long>(rows) * m;
  switch (rounds) {
    case 0: return launch<0>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    case 1: return launch<1>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    case 2: return launch<2>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    case 3: return launch<3>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    case 4: return launch<4>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    case 5: return launch<5>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    case 6: return launch<6>(svals, skey, rank, total, m, out_vals, out_idx, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
