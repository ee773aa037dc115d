// Floors of the take_along_axis_axis0 probe (8e) for tools/torch_gather_floor.py:
// two kernels with 8e's grid and accesses (256 blocks of 256 threads, a
// thread's 16-byte index load and 16-byte store) that move the same 3 MiB
// with no scattered read:
// * kind 0, stream: out = idx as float, 1 MiB in and 1 MiB out;
// * kind 1, chain: out = a 16-byte table load at the thread's own position,
//   made dependent on its index load (position t ^ (sign bit of idx.x)), so
//   the table is read once in full sectors after the index arrives: what a
//   gather could reach if each table sector were read once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 2048 * 128 / 4 / kThreads;

__global__ void __launch_bounds__(kThreads)
    floor_stream(const int4* __restrict__ idx, float4* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int4 i = __ldg(&idx[t]);
  out[t] = make_float4((float)i.x, (float)i.y, (float)i.z, (float)i.w);
}

__global__ void __launch_bounds__(kThreads)
    floor_chain(const float4* __restrict__ table, const int4* __restrict__ idx,
                float4* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int4 i = __ldg(&idx[t]);
  out[t] = __ldg(&table[t ^ (int)((unsigned)i.x >> 31)]);
}

}  // namespace

// Launches floor kernel `kind` (0 stream, 1 chain) on (2048, 128) float32
// table and out and int32 idx, all 16-byte aligned, on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another kind.
extern "C" int llr_gather_floor(int kind, const void* table, const void* idx, void* out,
                                void* stream) {
  if (kind == 0) {
    floor_stream<<<kGrid, kThreads, 0, (cudaStream_t)stream>>>((const int4*)idx, (float4*)out);
  } else if (kind == 1) {
    floor_chain<<<kGrid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const int4*)idx, (float4*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
