// Dependent-latency chains for tools/torch_dependent_latency.py: clocks
// (clock64) a step of four dependent chains in one warp, each run once
// untimed and then timed: one float add chain, two interleaved, a
// shared-memory pointer chase, a shuffle (plus an integer add). They price
// the add chain's floor of the while_walk_smem probe (8d) and its rounds of
// lookups and shuffles.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 256;  // steps of each chain

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// clocks[k] over the kSteps steps of chain k, of the second (timed) pass.
__global__ void latency(const float* __restrict__ f, int32_t* __restrict__ sink,
                        long long* __restrict__ clocks) {
  __shared__ int32_t s_next[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s_next[i] = (i + 1) & 1023;
  __syncwarp();
  const float x = f[lane];
  float a = f[lane + 32], b = f[lane + 64], c = f[lane + 96];
  int p = lane, q = lane;
  for (int pass = 0; pass < 2; ++pass) {
    long long t0 = clock_now();
#pragma unroll 32
    for (int s = 0; s < kSteps; ++s) a = a + x;
    asm volatile("" ::"f"(a));
    long long t1 = clock_now();
#pragma unroll 32
    for (int s = 0; s < kSteps; ++s) {
      b = b + x;
      c = c + x;
    }
    asm volatile("" ::"f"(b), "f"(c));
    long long t2 = clock_now();
#pragma unroll 32
    for (int s = 0; s < kSteps; ++s) p = s_next[p];
    asm volatile("" ::"r"(p));
    long long t3 = clock_now();
#pragma unroll 32
    for (int s = 0; s < kSteps; ++s) q = __shfl_sync(0xffffffffu, q, (lane + 1) & 31) + 1;
    asm volatile("" ::"r"(q));
    long long t4 = clock_now();
    if (pass == 1 && lane == 0) {
      clocks[0] = t1 - t0;
      clocks[1] = t2 - t1;
      clocks[2] = t3 - t2;
      clocks[3] = t4 - t3;
    }
  }
  sink[lane] = __float_as_int(a + b + c) + p + q;
}

}  // namespace

extern "C" int llr_latency_steps() { return kSteps; }

extern "C" int llr_latency(const void* f, void* sink, void* clocks, void* stream) {
  latency<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)f, (int32_t*)sink,
                                               (long long*)clocks);
  return (int)cudaGetLastError();
}
