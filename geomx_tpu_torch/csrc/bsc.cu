// Bi-Sparse (BSC) select/pack and scatter-add decompress for Hopper.
//
// select/pack replaces geomx_tpu/ops/bsc_pallas.py bsc_select_pack
// (_select_kernel): u' = 0.9u + g, v' = v + u'; emit exactly k (value,
// index) pairs per row — primaries |v'| > thr in ascending index order,
// then ties |v'| == thr in ascending index order, then (0.0, -1)
// sentinels — and zero u', v' where a pair was emitted.  A tie's slot
// depends on the total number of primaries of the whole row, so the TPU
// kernel runs two sequential passes.  Hopper's blocks run in no order, so
// the same count-then-emit split becomes three launches:
//   1. count: per 1024-element block, the number of primaries and ties;
//   2. scan:  per row, an exclusive scan over the block counts, the row's
//             primary total, and the (0.0, -1) fill of the unused slots;
//   3. emit:  per block, a block scan of the class masks gives each kept
//             element its slot; u', v' are written with the emitted
//             coordinates zeroed.
// The momentum arithmetic rounds after the multiply (__fmul_rn/__fadd_rn):
// nvcc would otherwise contract u * 0.9f + g into an FMA, which changes v'
// and with it which elements clear the threshold.  The threshold comes
// from sampled_boundary_guv in PyTorch ops, which rounds the same way, so
// the result is bit-identical to the plain PyTorch version.
// Bound: bytes.  g, u, v are read and u', v' written once (20 B/element)
// plus 8 B per pair; the count pass reads g, u, v a second time, so this
// first version moves 32 B/element against a 20 B/element bound.
//
// scatter-add replaces bsc_pallas.py bsc_scatter_add (_scatter_kernel):
// out[idx] += val over all gathered pairs, idx < 0 dropped.  Each block
// owns an 8192-float slice of one output row in shared memory, streams
// every pair of the row past it, and folds the m / run runs of pairs
// (one run per party) strictly in order, with a barrier between runs.
// Within one party's run the indices are unique, so the shared-memory
// atomicAdd never collides there and the fold order is fixed: the sum is
// ((0 + run_0) + run_1) + ..., the order the JAX package's scatter applies
// updates in — deterministic for any number of parties, with no global
// atomics.  (Pairs that collide inside one run, which the BSC wire never
// produces, accumulate in an unspecified order.)
// Bound: bytes (pairs read once, the dense row written once); every block
// rereads its row's pairs from L2, which is the cost of this first version.
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "geomx_kernels.h"

namespace {

constexpr float kMomentum = 0.9f;  // gc.cc:200; bsc_pallas.py MOMENTUM
constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // elements per select block
constexpr int kTieOne = 1 << 16;  // packed count: primaries low 16 bits, ties high

constexpr int kScatterThreads = 512;
constexpr int kSlice = 8192;  // output floats per scatter block (32 KB)

// v' = v + (0.9u + g) with u' returned through u2, each op rounded alone
__device__ __forceinline__ float momentum(float g, float u, float v,
                                          float* u2) {
  const float a = __fadd_rn(__fmul_rn(u, kMomentum), g);
  *u2 = a;
  return __fadd_rn(v, a);
}

__device__ __forceinline__ int classify(float a, float t) {
  return a > t ? 1 : (a == t ? kTieOne : 0);
}

// a packed block count -> primaries in the low 32 bits, ties in the high 32
__device__ __forceinline__ unsigned long long widen(int x) {
  return static_cast<unsigned long long>(x & 0xFFFF) |
         (static_cast<unsigned long long>(x >> 16) << 32);
}

__global__ void __launch_bounds__(kThreads)
select_count_kernel(const float* __restrict__ g, const float* __restrict__ u,
                    const float* __restrict__ v, const float* __restrict__ thr,
                    int n, int nblk, int* __restrict__ counts) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int r = blockIdx.y;
  const long long row = static_cast<long long>(r) * n;
  const float t = thr[r];
  const int first = blockIdx.x * kTile + threadIdx.x * kItems;
  int packed = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j;
    if (i < n) {
      float u2;
      packed += classify(fabsf(momentum(g[row + i], u[row + i], v[row + i],
                                        &u2)), t);
    }
  }
  const int total = Reduce(tmp).Sum(packed);
  if (threadIdx.x == 0) {
    counts[static_cast<long long>(r) * nblk + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
select_scan_kernel(const int* __restrict__ counts, int nblk, int k,
                   int* __restrict__ before, int* __restrict__ totals,
                   float* __restrict__ vals, int* __restrict__ idx) {
  // widened counts: both halves stay below 2^31, so no carry crosses
  using Scan = cub::BlockScan<unsigned long long, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int r = blockIdx.x;
  const int* c = counts + static_cast<long long>(r) * nblk;
  int* out = before + static_cast<long long>(r) * nblk * 2;
  const int per = (nblk + kThreads - 1) / kThreads;
  const int s0 = min(static_cast<int>(threadIdx.x) * per, nblk);
  const int s1 = min(s0 + per, nblk);
  unsigned long long mine = 0;
  for (int b = s0; b < s1; ++b) mine += widen(c[b]);
  unsigned long long prefix, total;
  Scan(tmp).ExclusiveSum(mine, prefix, total);
  for (int b = s0; b < s1; ++b) {
    out[2 * b] = static_cast<int>(prefix & 0xFFFFFFFFull);
    out[2 * b + 1] = static_cast<int>(prefix >> 32);
    prefix += widen(c[b]);
  }
  const int n_primary = static_cast<int>(total & 0xFFFFFFFFull);
  const int n_tie = static_cast<int>(total >> 32);
  if (threadIdx.x == 0) {
    totals[2 * r] = n_primary;
    totals[2 * r + 1] = n_tie;
  }
  // the real pairs fill slots [0, filled); the rest carry the sentinel
  const long long filled =
      min(static_cast<long long>(k),
          static_cast<long long>(n_primary) + static_cast<long long>(n_tie));
  float* ov = vals + static_cast<long long>(r) * k;
  int* oi = idx + static_cast<long long>(r) * k;
  for (long long s = filled + threadIdx.x; s < k; s += kThreads) {
    ov[s] = 0.0f;
    oi[s] = -1;
  }
}

__global__ void __launch_bounds__(kThreads)
select_emit_kernel(const float* __restrict__ g, const float* __restrict__ u,
                   const float* __restrict__ v, const float* __restrict__ thr,
                   int n, int k, int nblk, const int* __restrict__ before,
                   const int* __restrict__ totals, float* __restrict__ new_u,
                   float* __restrict__ new_v, float* __restrict__ vals,
                   int* __restrict__ idx) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int r = blockIdx.y;
  const long long row = static_cast<long long>(r) * n;
  const float t = thr[r];
  const long long bi = (static_cast<long long>(r) * nblk + blockIdx.x) * 2;
  const int p_before = before[bi];
  const int s_before = before[bi + 1];
  const int n_primary = totals[2 * r];
  const int first = blockIdx.x * kTile + threadIdx.x * kItems;
  float u2[kItems], v2[kItems];
  int cls[kItems];
  int packed = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j;
    cls[j] = 0;
    u2[j] = 0.0f;
    v2[j] = 0.0f;
    if (i < n) {
      v2[j] = momentum(g[row + i], u[row + i], v[row + i], &u2[j]);
      cls[j] = classify(fabsf(v2[j]), t);
    }
    packed += cls[j];
  }
  int rank;  // packed exclusive rank of this thread's first element
  Scan(tmp).ExclusiveSum(packed, rank);
  float* ov = vals + static_cast<long long>(r) * k;
  int* oi = idx + static_cast<long long>(r) * k;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j;
    if (i < n) {
      bool keep = false;
      if (cls[j] == 1) {
        const long long slot =
            static_cast<long long>(p_before) + (rank & 0xFFFF);
        if (slot < k) {
          keep = true;
          ov[slot] = v2[j];
          oi[slot] = i;
        }
      } else if (cls[j] == kTieOne) {
        // ties queue after ALL primaries of the row
        const long long slot = static_cast<long long>(n_primary) + s_before +
                               (rank >> 16);
        if (slot < k) {
          keep = true;
          ov[slot] = v2[j];
          oi[slot] = i;
        }
      }
      new_u[row + i] = keep ? 0.0f : u2[j];
      new_v[row + i] = keep ? 0.0f : v2[j];
    }
    rank += cls[j];
  }
}

__global__ void __launch_bounds__(kScatterThreads)
scatter_add_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                   int m, int run, int n, float* __restrict__ out) {
  __shared__ float acc[kSlice];
  const int r = blockIdx.y;
  const int lo = blockIdx.x * kSlice;
  const int width = min(kSlice, n - lo);
  for (int i = threadIdx.x; i < width; i += kScatterThreads) acc[i] = 0.0f;
  __syncthreads();
  const float* rv = vals + static_cast<long long>(r) * m;
  const int* ri = idx + static_cast<long long>(r) * m;
  for (int start = 0; start < m; start += run) {
    const int end = min(start + run, m);
    for (int j = start + threadIdx.x; j < end; j += kScatterThreads) {
      const int x = ri[j];
      // negative (sentinel) indices and other slices' indices fall outside
      if (x >= lo && x - lo < width) atomicAdd(&acc[x - lo], rv[j]);
    }
    __syncthreads();  // runs fold in order
  }
  float* o = out + static_cast<long long>(r) * n + lo;
  for (int i = threadIdx.x; i < width; i += kScatterThreads) o[i] = acc[i];
}

}  // namespace

extern "C" int gx_bsc_select_blocks(int n) { return (n + kTile - 1) / kTile; }

extern "C" int gx_bsc_select_pack(const float* g, const float* u,
                                  const float* v, const float* thr, int rows,
                                  int n, int k, int* counts, int* before,
                                  int* totals, float* new_u, float* new_v,
                                  float* vals, int* idx, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || k <= 0) return 0;
  const int nblk = gx_bsc_select_blocks(n);
  const dim3 grid(nblk, rows);
  select_count_kernel<<<grid, kThreads, 0, stream>>>(g, u, v, thr, n, nblk,
                                                     counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_scan_kernel<<<rows, kThreads, 0, stream>>>(counts, nblk, k, before,
                                                    totals, vals, idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_emit_kernel<<<grid, kThreads, 0, stream>>>(
      g, u, v, thr, n, k, nblk, before, totals, new_u, new_v, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gx_bsc_scatter_add(const float* vals, const int* idx, int rows,
                                  int m, int run, int n, float* out,
                                  cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (run <= 0) run = m > 0 ? m : 1;
  const dim3 grid((n + kSlice - 1) / kSlice, rows);
  scatter_add_kernel<<<grid, kScatterThreads, 0, stream>>>(vals, idx, m, run,
                                                           n, out);
  return static_cast<int>(cudaGetLastError());
}
