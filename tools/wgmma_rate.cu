// Cycles a split-TF32 wgmma product takes on a Hopper SM, by shape and
// operand source: m64nNk8 tf32 chains of 16 products a commit group, one
// group in flight behind the one issued, A from registers (RS) or shared
// memory (SS), one or two warpgroups a block, one block an SM (132 blocks).
// Sizes the attention kernels' tiles (csrc/attention_mma.cuh,
// csrc/attention_wide.cuh).  Build and run on the card, from the repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -Igeomx_tpu_torch/csrc -o build/wgmma_rate tools/wgmma_rate.cu
//   build/wgmma_rate
#include <cstdio>

#include <cuda_runtime.h>

#include "attention_mma.cuh"

using namespace gx_mma;

constexpr int kSmemFloats = 51200;  // 200 KB: one block an SM

template <int N, bool kRS, int kIt>
__global__ void chain(float* out, long long* cycles) {
  extern __shared__ __align__(128) float sm[];
  for (int i = threadIdx.x; i < kSmemFloats; i += blockDim.x) {
    sm[i] = 1e-3f * (i % 7);
  }
  __syncthreads();
  float d[N / 2];
  for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
  const int wg = threadIdx.x / kThreads;
  const float* a = sm + wg * 8192;          // [64][32] K-major
  const float* b = sm + 32768 + wg * 8192;  // [N][32] K-major
  uint32_t fa[2][4];
  for (int q = 0; q < 4; ++q) {
    fa[0][q] = __float_as_uint(sm[threadIdx.x % kThreads + q]);
    fa[1][q] = fa[0][q] ^ 1u;
  }
  const long long t0 = clock64();
  for (int it = 0; it < kIt; ++it) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (kRS) {
        Wgmma<N>::rs(d, fa[j & 1], desc(b + (j & 3) * 64, 32), 1);
      } else {
        Wgmma<N>::ss(d, desc(a + (j & 3) * 64, 32),
                     desc(b + (j & 3) * 64, 32), 1);
      }
    }
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  wgmma_wait();
  reg_fence(d);
  const long long t1 = clock64();
  float s = 0.f;
  for (int e = 0; e < N / 2; ++e) s += d[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int N, bool kRS>
void run(int wgs) {
  constexpr int kIt = 2000;
  float* out;
  long long* cycles;
  cudaMalloc(&out, 132 * 256 * sizeof(float));
  cudaMalloc(&cycles, 132 * sizeof(long long));
  auto kernel = chain<N, kRS, kIt>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemFloats * 4);
  kernel<<<132, kThreads * wgs, kSmemFloats * 4>>>(out, cycles);
  cudaDeviceSynchronize();
  long long c = 0;
  cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  const double per = c / (16.0 * kIt * wgs);  // cycles a product an SM
  const double ideal = 64.0 * N * 8 / 1024;   // at 1,024 TF32 MACs a cycle
  printf("m64n%dk8 %s, %d warpgroup(s): %.1f cycles a product, %.1f%% of "
         "the TF32 peak\n", N, kRS ? "RS" : "SS", wgs, per,
         100.0 * ideal / per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) printf("error: %s\n", cudaGetErrorString(err));
  cudaFree(out);
  cudaFree(cycles);
}

int main() {
  for (int wgs = 1; wgs <= 2; ++wgs) {
    run<16, true>(wgs);
    run<16, false>(wgs);
    run<32, true>(wgs);
    run<32, false>(wgs);
    run<64, true>(wgs);
    run<128, true>(wgs);
  }
  return 0;
}
