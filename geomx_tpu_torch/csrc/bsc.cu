// Bi-Sparse (BSC) select/pack and scatter-add decompress for Hopper.
//
// select/pack replaces geomx_tpu/ops/bsc_pallas.py bsc_select_pack
// (_select_kernel): u' = 0.9u + g, v' = v + u'; emit exactly k (value,
// index) pairs per row -- primaries |v'| > thr in ascending index order,
// then ties |v'| == thr in ascending index order, then (0.0, -1)
// sentinels -- and zero u', v' where a pair was emitted.  A tie's slot
// depends on the number of primaries of the whole row, so the TPU kernel
// runs two sequential passes over the row.
//
// Here it is one pass, one launch.  Each block takes the next tile of
// 8,192 elements from an atomic ticket (so a tile's predecessors in its
// row have started before it; the flagship bucket's 272 tiles all run in
// one round).  Its threads read g, u, v as 16-byte quads striped over the
// tile, two quads' loads in flight, store u2 and v2 to u' and v' at once
// (before any count is known, so the bulk writes stream behind the
// reads), and scan the tile's packed (primary, tie) counts by warp
// shuffles; a decoupled look-back over the row's per-tile states (flag
// and counts in one 64-bit word: an aggregate, then the inclusive prefix)
// gives the tile the counts of every element before it.  A primary goes
// to its slot, p_prefix + rank, when that is below k, and its u' and v'
// are zeroed.
// A tie with s_prefix + rank < k goes to the row's tie buffer (k pairs),
// because its slot needs the row's primary total.  (A kept element's v'
// is read back from the thread's own store.)  The row's last tile to
// finish (an atomic done counter after __threadfence) reads the row's
// totals, moves ties 0 .. k - n_primary - 1 to slots n_primary + s,
// zeroes u' and v' at exactly those ties' indices, and fills the (0.0,
// -1) sentinels.  The scratch (tile states, done counters, the ticket)
// is zeroed by one cudaMemsetAsync before the launch.  Slots follow from
// counts alone, so a call gives the same bits every time.  What holds it
// above its bound (PERF.md): the chain each tile runs after its reads
// (scan, look-back, the fence and the done counter) and the memset, on
// top of the launch itself.
// The momentum arithmetic rounds after the multiply (__fmul_rn/__fadd_rn):
// nvcc would otherwise contract u * 0.9f + g into an FMA, which changes v'
// and with it which elements clear the threshold.  The threshold comes
// from sampled_boundary_guv in PyTorch ops, which rounds the same way, so
// the result is bit-identical to the plain PyTorch version.
// Bound: bytes.  g, u, v are read and u', v' written once (20 B/element)
// plus 8 B per pair; this kernel moves that, with 16-byte accesses where
// a row starts 16-byte aligned (n % 4 == 0 and aligned bases), and on top
// the kept elements' second writes of u', v' and the tie buffer (at most
// 24 B per slot).
//
// scatter-add replaces bsc_pallas.py bsc_scatter_add (_scatter_kernel):
// out[idx] += val over all gathered pairs, idx < 0 dropped.  Each block
// owns an 8,192-float slice of one output row in shared memory (32 KB,
// 512 threads, three or more blocks an SM, so the flagship's 272 blocks
// all start at once), streams every pair of the row past it, and folds the
// m / run runs of pairs (one run per party) strictly in order, with a
// barrier between runs.  Within one party's run the indices are unique,
// so the shared-memory atomicAdd never collides there and the fold order
// is fixed: the sum is ((0 + run_0) + run_1) + ..., the order the JAX
// package's scatter applies updates in — deterministic for any number of
// parties, with no global atomics.  (Pairs that collide inside one run,
// which the BSC wire never produces, accumulate in an unspecified order.)
// The pairs may come in any order; indices outside the slice are dropped
// by one unsigned compare.
// Bound: bytes (pairs read once, the dense row written once).  A block's
// reads of the pairs are L2 round trips, so a thread loads the indices of
// up to kScatterChunk of its pairs of a run (coalesced 4-byte loads)
// before its first atomic, then for each pair that hits the slice (about
// 3% at the flagship shape) its value and the atomic: at the flagship
// shape (runs of 2,726 pairs, 512 threads) one chunk a run, so the index
// loads are one round trip, not one a pair in turn.  The slice is zeroed
// and written out in 16-byte accesses where the output rows are 16-byte
// aligned (n % 4 == 0), element by element otherwise; the write-out keeps
// the default cache policy, since the next op of the step reads it.
// Every block still reads its row's indices from L2 (11.9 MB at the
// flagship shape for 0.35 MB of pairs); the other forms tried, and what
// each measured, are in PERF.md.  A shared-memory float atomicAdd is a
// compare-and-swap loop on Hopper (ATOMS.CAST.SPIN).
#include <stdint.h>

#include "geomx_kernels.h"

namespace {

constexpr float kMomentum = 0.9f;  // gc.cc:200; bsc_pallas.py MOMENTUM
constexpr int kThreads = 256;
constexpr int kQuads = 8;                     // 4-element quads a thread
constexpr int kInFlight = 2;                  // quads whose loads overlap
constexpr int kTile = kThreads * kQuads * 4;  // elements a select tile
// blocks an SM: with 8,192-element tiles, the 8 x 34 tiles of the flagship
// bucket (8 rows of 272,512) run in one round on 132 SMs
constexpr int kBlocksPerSm = 3;
constexpr int kTieOne = 1 << 16;  // packed count: primaries low 16 bits, ties high

// a tile's state word: the flag in bits 62-63, its ties in bits 31-61 and
// its primaries in bits 0-30 (a row holds fewer than 2^31 elements, so
// adding words never carries from one count into the other)
constexpr unsigned long long kAggregate = 1ull << 62;  // this tile's counts
constexpr unsigned long long kPrefix = 2ull << 62;     // counts up to here
constexpr unsigned long long kCounts = (1ull << 62) - 1;

constexpr int kScatterThreads = 512;
constexpr int kSlice = 8192;  // output floats per scatter block (32 KB)
constexpr int kScatterChunk = 6;  // pair indices a thread holds at once

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

// a packed tile count -> its state-word counts
__device__ __forceinline__ unsigned long long widen(int x) {
  return static_cast<unsigned long long>(x & 0xFFFF) |
         (static_cast<unsigned long long>(x >> 16) << 31);
}
__device__ __forceinline__ int primaries(unsigned long long w) {
  return static_cast<int>(w & 0x7FFFFFFFull);
}
__device__ __forceinline__ int ties(unsigned long long w) {
  return static_cast<int>((w >> 31) & 0x7FFFFFFFull);
}

// state words are read and written at device scope, past the L1
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}
__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// the counts of the row's tiles before `tile`, by warp 0: each lane waits
// for one predecessor's state, and the window of 32 moves back until it
// meets an inclusive prefix (tile 0 always publishes one)
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* st, int tile) {
  const int lane = threadIdx.x;
  unsigned long long before = 0;
  for (int j = tile - 1;; j -= 32) {
    const int p = j - lane;
    unsigned long long w = kPrefix;  // before the row: an empty prefix
    if (p >= 0) {
      do {
        w = peek(st + p);
      } while ((w >> 62) == 0);
    }
    const unsigned stop = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int last = stop ? __ffs(stop) - 1 : 31;
    unsigned long long c = lane <= last ? (w & kCounts) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    before += c;
    if (stop) return before;
  }
}

// Four consecutive elements of g, u, v at `at`: 16-byte loads when whole,
// else element by element up to live.
struct Quad {
  float g[4], u[4], v[4];
};

__device__ __forceinline__ void load_quad(const float* __restrict__ g,
                                          const float* __restrict__ u,
                                          const float* __restrict__ v,
                                          long long at, int live, bool whole,
                                          Quad& q) {
  if (whole) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(g + at));
    const float4 y = __ldg(reinterpret_cast<const float4*>(u + at));
    const float4 z = __ldg(reinterpret_cast<const float4*>(v + at));
    q.g[0] = x.x, q.g[1] = x.y, q.g[2] = x.z, q.g[3] = x.w;
    q.u[0] = y.x, q.u[1] = y.y, q.u[2] = y.z, q.u[3] = y.w;
    q.v[0] = z.x, q.v[1] = z.y, q.v[2] = z.z, q.v[3] = z.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q.g[e] = e < live ? g[at + e] : 0.0f;
      q.u[e] = e < live ? u[at + e] : 0.0f;
      q.v[e] = e < live ? v[at + e] : 0.0f;
    }
  }
}

// The quad's momentum: u2 and v2 stored to u' and v' at once; returns
// the quad's classes, 2 bits an element (1 primary, 2 tie)
__device__ __forceinline__ int store_quad(const Quad& q,
                                          float* __restrict__ new_u,
                                          float* __restrict__ new_v,
                                          long long at, int live, bool whole,
                                          float t) {
  float u2[4], v2[4];
  int cls = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v2[e] = momentum(q.g[e], q.u[e], q.v[e], &u2[e]);
    if (e < live) {
      const int c = classify(fabsf(v2[e]), t);
      cls |= (c == 1 ? 1 : (c == kTieOne ? 2 : 0)) << (2 * e);
    }
  }
  if (whole) {
    *reinterpret_cast<float4*>(new_u + at) =
        make_float4(u2[0], u2[1], u2[2], u2[3]);
    *reinterpret_cast<float4*>(new_v + at) =
        make_float4(v2[0], v2[1], v2[2], v2[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < live) {
        new_u[at + e] = u2[e];
        new_v[at + e] = v2[e];
      }
    }
  }
  return cls;
}

// a quad's 2-bit classes -> its packed count
__device__ __forceinline__ int packed_count(int cls) {
  int p = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = cls >> (2 * e) & 3;
    p += c == 1 ? 1 : (c == 2 ? kTieOne : 0);
  }
  return p;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
select_pack_kernel(const float* __restrict__ g, const float* __restrict__ u,
                   const float* __restrict__ v, const float* __restrict__ thr,
                   int n, int k, int tiles, int vec,
                   unsigned long long* __restrict__ state,
                   int* __restrict__ done, int* __restrict__ ticket,
                   float* __restrict__ tie_vals, int* __restrict__ tie_idx,
                   float* __restrict__ new_u, float* __restrict__ new_v,
                   float* __restrict__ vals, int* __restrict__ idx) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_warp[kWarps][kQuads];  // the warps' packed quad counts
  __shared__ int s_ticket;
  __shared__ unsigned long long s_before;
  __shared__ bool s_last;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int r = s_ticket / tiles, tile = s_ticket % tiles;
  const long long row = static_cast<long long>(r) * n;
  const float t = thr[r];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // quad j of this thread: elements first(j) .. + 3; the tile's quads are
  // striped over the threads (neighbours on neighbouring 16 bytes), so
  // quad j lies in segment j of the tile, all of segment j before j + 1
  auto first = [&](int j) {
    return tile * kTile + 4 * (j * kThreads + static_cast<int>(threadIdx.x));
  };
  int cls[kQuads], rank[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; j += kInFlight) {
    Quad q[kInFlight];
    int live[kInFlight];
#pragma unroll
    for (int h = 0; h < kInFlight; ++h) {
      live[h] = max(0, min(4, n - first(j + h)));
      if (live[h] > 0) {
        load_quad(g, u, v, row + first(j + h), live[h],
                  vec && live[h] == 4, q[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kInFlight; ++h) {
      cls[j + h] = live[h] > 0
                       ? store_quad(q[h], new_u, new_v, row + first(j + h),
                                    live[h], vec && live[h] == 4, t)
                       : 0;
    }
  }
  // exclusive packed ranks within each segment: a warp scan of each quad's
  // count, then the warps before it (counts below 2^16 a field: no carry)
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int mine = packed_count(cls[j]);
    int x = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    rank[j] = x - mine;
    if (lane == 31) s_warp[warp][j] = x;
  }
  __syncthreads();
  int total = 0;  // the tile's packed count; segments before quad j first
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    int seg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rank[j] += w < warp ? s_warp[w][j] : 0;
      seg += s_warp[w][j];
    }
    rank[j] += total;
    total += seg;
  }

  unsigned long long* st = state + static_cast<long long>(r) * tiles;
  if (threadIdx.x < 32) {
    const unsigned long long mine = widen(total);
    unsigned long long before = 0;
    if (tile == 0) {
      if (threadIdx.x == 0) publish(st, kPrefix | mine);
    } else {
      if (threadIdx.x == 0) publish(st + tile, kAggregate | mine);
      before = look_back(st, tile);
      if (threadIdx.x == 0) publish(st + tile, kPrefix | (before + mine));
    }
    if (threadIdx.x == 0) s_before = before;
  }
  __syncthreads();

  // place this tile's primaries (zeroing their u' and v') and queue its
  // ties; a kept element's v' is read back from this thread's own store
  float* ov = vals + static_cast<long long>(r) * k;
  int* oi = idx + static_cast<long long>(r) * k;
  float* tv = tie_vals + static_cast<long long>(r) * k;
  int* ti = tie_idx + static_cast<long long>(r) * k;
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    if (cls[j] == 0) continue;
    int p = primaries(s_before) + (rank[j] & 0xFFFF);
    int s = ties(s_before) + (rank[j] >> 16);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cls[j] >> (2 * e) & 3;
      const long long i = row + first(j) + e;
      if (c == 1) {
        if (p < k) {
          ov[p] = new_v[i];
          oi[p] = first(j) + e;
          new_u[i] = 0.0f;
          new_v[i] = 0.0f;
        }
        ++p;
      } else if (c == 2) {
        // a tie's slot waits for the row's primary total: queue it
        if (s < k) {
          tv[s] = new_v[i];
          ti[s] = first(j) + e;
        }
        ++s;
      }
    }
  }

  // the row's last tile to finish places its ties and sentinels
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + r, 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const unsigned long long all = peek(st + tiles - 1);
  const int n_primary = primaries(all), n_tie = ties(all);
  const int kept = min(n_tie, max(0, k - n_primary));
  for (int s = threadIdx.x; s < kept; s += kThreads) {
    const int i = __ldcg(ti + s);
    ov[n_primary + s] = __ldcg(tv + s);
    oi[n_primary + s] = i;
    new_u[row + i] = 0.0f;
    new_v[row + i] = 0.0f;
  }
  // the real pairs fill slots [0, filled); the rest carry the sentinel
  const int filled = min(k, n_primary + n_tie);
  for (int s = filled + threadIdx.x; s < k; s += kThreads) {
    ov[s] = 0.0f;
    oi[s] = -1;
  }
}

// vec: out's rows 16-byte aligned (n % 4 == 0 and out aligned)
__global__ void __launch_bounds__(kScatterThreads)
scatter_add_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                   int m, int run, int n, int vec, float* __restrict__ out) {
  __shared__ float4 acc4[kSlice / 4];
  float* acc = reinterpret_cast<float*>(acc4);
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * kSlice;
  const int width = min(kSlice, n - lo);
  for (int i = tid; i < (width + 3) / 4; i += kScatterThreads) {
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const float* rv = vals + static_cast<long long>(blockIdx.y) * m;
  const int* ri = idx + static_cast<long long>(blockIdx.y) * m;
  for (int start = 0; start < m; start += run) {
    const int end = min(start + run, m);
    for (int j0 = start + tid; j0 < end;
         j0 += kScatterThreads * kScatterChunk) {
      int x[kScatterChunk];
#pragma unroll
      for (int c = 0; c < kScatterChunk; ++c) {
        const int j = j0 + c * kScatterThreads;
        x[c] = j < end ? __ldg(ri + j) : -1;
      }
#pragma unroll
      for (int c = 0; c < kScatterChunk; ++c) {
        // negative (sentinel) and other slices' indices wrap past width
        const unsigned d = static_cast<unsigned>(x[c] - lo);
        if (d < static_cast<unsigned>(width)) {
          atomicAdd(acc + d, __ldg(rv + j0 + c * kScatterThreads));
        }
      }
    }
    __syncthreads();  // runs fold in order
  }
  float* o = out + static_cast<long long>(blockIdx.y) * n + lo;
  if (vec) {  // width % 4 == 0: n % 4 == 0 and kSlice % 4 == 0
    for (int i = tid; i < width / 4; i += kScatterThreads) {
      reinterpret_cast<float4*>(o)[i] = acc4[i];
    }
  } else {
    for (int i = tid; i < width; i += kScatterThreads) o[i] = acc[i];
  }
}

}  // namespace

extern "C" long long gx_bsc_select_scratch(int rows, int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  return 2 * rows * tiles + rows + 1;
}

extern "C" int gx_bsc_select_pack(const float* g, const float* u,
                                  const float* v, const float* thr, int rows,
                                  int n, int k, int* scratch, float* tie_vals,
                                  int* tie_idx, float* new_u, float* new_v,
                                  float* vals, int* idx, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || k <= 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  if (static_cast<long long>(rows) * tiles > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, gx_bsc_select_scratch(rows, n) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* state = reinterpret_cast<unsigned long long*>(scratch);
  int* done = scratch + 2LL * rows * tiles;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = n % 4 == 0 && a16(g) && a16(u) && a16(v) && a16(new_u) &&
                  a16(new_v);
  select_pack_kernel<<<rows * tiles, kThreads, 0, stream>>>(
      g, u, v, thr, n, k, tiles, vec, state, done, done + rows, tie_vals,
      tie_idx, new_u, new_v, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gx_bsc_scatter_add(const float* vals, const int* idx, int rows,
                                  int m, int run, int n, float* out,
                                  cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (run <= 0) run = m > 0 ? m : 1;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((n + kSlice - 1) / kSlice, rows);
  scatter_add_kernel<<<grid, kScatterThreads, 0, stream>>>(vals, idx, m, run,
                                                           n, vec, out);
  return static_cast<int>(cudaGetLastError());
}
