// Hopper counterparts of the Mosaic capability probes: one small kernel per
// probe of tools/probe_mosaic.py, tools/pallas_probe.py and
// tools/probe_wide.py, each computing what its Pallas probe computes on the
// same inputs (lumillyrender_tpu_torch/probes/ builds them and holds the
// plain PyTorch version of each).
//
// A TPU probe asks whether Mosaic lowers one access pattern; on the H100
// the question is what the pattern costs. Memory spaces, translated:
// * an input the Pallas probe puts in SMEM (the TPU's scalar memory, read
//   uniformly by the whole tile) is read block-uniformly: one thread reads
//   it, or every thread reads the same address (one broadcast load), or a
//   warp's lanes read its few words in one load and share them by
//   shuffles (8a, 8h, 8t); a table of links that the probe follows from
//   node to node (8d) is held in shared memory by one warp, which finds
//   the walk by pointer doubling rather than link by link;
// * a VMEM or SMEM table that the kernel reads at a few places is read
//   straight from global memory, where it stays in the 50 MB L2, with
//   read-only loads (__ldg, ld.global.nc) of what the function needs: no
//   shared memory, no barrier (8a, 8b, 8c, 8g, 8h, 8i, 8p, 8t). Only a
//   table that the kernel reads wholly or repeatedly is staged into shared
//   memory by the block: a round of 4-byte loads and stores per thread,
//   then __syncthreads, costs more than a few L2 round trips. 8c's probe
//   asks how large a table the TPU's scalar memory holds; on the card the
//   answer is the L2, which holds each of its tool's tables (up to 4 MiB).
//   8n, which reads its whole table, streams it through a ring in shared
//   memory with TMA bulk copies;
// * `table` (2048 x 128 float32, 1 MiB) is read from global memory, where
//   it stays in the 50 MB L2, also where the kernel gathers from all of it
//   at scattered places (8e): an element reaches the SM in its 32-byte
//   sector either way, and on this card a copy held across a cluster costs
//   more (barriers, remote reads) than the sectors it saves. An input read
//   once at a fixed place goes straight to registers. A scatter whose
//   output is a few rows of a larger buffer computes those rows alone (8m);
// * the gathers follow JAX's index rule (8e, 8g), as the scatter does
//   (8m): an index i in [-M, 0) reads row i + M, and any other index
//   outside [0, M) gives NaN (bits 0x7fc00000) where JAX's gather fills.
// Every entry has the signature (a, b, scratch, out, n, stream): the probe's
// inputs in its tool's order, a scratch pointer that no kernel here reads
// (tools/torch_probe_ab.py calls an earlier tree's entries, whose scatter
// used one, through the same signature), the output, one integer (the first
// input's row count), the stream. It launches on the stream, does not
// synchronise and returns cudaGetLastError().
//
// Bounds on an H100: each probe moves at most 3 MiB and does at most 4.2
// Mflop, a few nanoseconds at 3.35 TB/s or 67 TFLOP/s, so every one sits on
// the launch floor; chip_smoke.py times an empty kernel beside them
// (llr_probe_empty). The per-kernel notes give the bytes and operations
// that chip_smoke.py counts for each bound.
//
// Built with -fmad=false like every kernel of the port; the sums below add
// in the probe's loop order, one operand at a time, so each output is bit
// for bit its plain version's. The one exception is 8j, whose sums add in
// another order than its plain version's matrix product: there every
// output row has one non-zero product, the hot value x, every other
// product is +-0, and x + +-0 = x for a finite x != 0 (a sum of zeros is
// -0 only where every term is), so every partial sum, in any order, is the
// hot value or a zero, and the whole sum is exactly the hot value.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

#define PROBE_ENTRY(name)                                                                   \
  extern "C" int llr_probe_##name(const void* a, const void* b, void* scratch, void* out, \
                                  int n, void* stream)
#define STREAM ((cudaStream_t)stream)

namespace {

constexpr int kM = 2048;  // pallas_probe.py's table rows
constexpr int kS = 8;     // sublanes
constexpr int kL = 128;   // lanes

// The block copies n floats from global into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

constexpr int kMaxDevices = 64;

// Lets `kernel` take `bytes` of dynamic shared memory on the current device
// (above 48 KB a kernel must opt in, device by device). `opted` remembers
// the largest size set on each device, so a launch under CUDA graph capture
// sets nothing. A size past the card's opt-in limit is refused here by the
// runtime (cudaErrorInvalidValue): the error is returned, and cleared so
// that the next launch's cudaGetLastError() does not report it.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, int (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    opted[dev] = bytes;
  } else {
    cudaGetLastError();
  }
  return err;
}

}  // namespace

// ---------------------------------------------------------------------------
// tools/probe_mosaic.py
// ---------------------------------------------------------------------------

// 8a. probe_vmem_dyn_sublane_static_lane (tools/probe_mosaic.py:34): the sum
// over i < 16 of tab[idx[i], 5], in order. tab (64,128) VMEM and idx (1,16)
// SMEM are read by one warp straight from global memory (L2): lane i < 16
// loads idx[i] (the 16 loads coalesce), then the one element tab[idx[i], 5],
// read-only loads (__ldg): 16 independent loads in two dependent L2 round
// trips, as 8b makes for one element. The warp gathers the 16 values by
// shuffles and adds them in order from 0.0f (the plain version starts from
// zeros: 0 + -0 is +0), and lane 0 writes the sum. Only the 16 elements are
// read; nothing is staged, no shared memory, no barrier. Bound: bytes (16
// table reads, 16 indices, one output).
extern "C" __global__ void probe_vmem_dyn_sublane_static_lane(const float* __restrict__ tab,
                                                              const int32_t* __restrict__ idx,
                                                              float* __restrict__ out) {
  const int lane = threadIdx.x;
  const float v = lane < 16 ? __ldg(&tab[__ldg(&idx[lane]) * kL + 5]) : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc = acc + __shfl_sync(0xffffffffu, v, i);
  if (lane == 0) out[0] = acc;
}

PROBE_ENTRY(vmem_dyn_sublane_static_lane) {
  probe_vmem_dyn_sublane_static_lane<<<1, 32, 0, STREAM>>>(
      (const float*)a, (const int32_t*)b, (float*)out);
  return (int)cudaGetLastError();
}

// 8b. probe_vmem_dyn_lane (tools/probe_mosaic.py:55): tab[3, idx[0, 0]], a
// dynamic lane. tab (64,128) VMEM and idx (1,1) SMEM are read by thread 0 of
// one warp straight from global memory (L2): the index, then the one
// element at it, two dependent read-only loads; nothing is staged. Bound:
// bytes (one read, one index, one output).
extern "C" __global__ void probe_vmem_dyn_lane(const float* __restrict__ tab,
                                               const int32_t* __restrict__ idx,
                                               float* __restrict__ out) {
  if (threadIdx.x == 0) out[0] = __ldg(&tab[3 * kL + __ldg(idx)]);
}

PROBE_ENTRY(vmem_dyn_lane) {
  probe_vmem_dyn_lane<<<1, 32, 0, STREAM>>>((const float*)a, (const int32_t*)b, (float*)out);
  return (int)cudaGetLastError();
}

// 8c. probe_smem_input(rows) (tools/probe_mosaic.py:73): the sum over i < 64
// of tab[(977 i) % rows, i % 8], in order, tab (rows,8), rows = n. The TPU
// probe asks how large a table its scalar memory holds; the card reads any
// of the tool's four tables (32 KiB to 4 MiB) from the L2. One warp reads
// the 64 elements straight from global memory: lane l computes the
// addresses of i = l and i = l + 32 (two remainders, in parallel across
// the lanes; one lane issuing all 64 loads would compute 64 remainders in
// turn) and issues both read-only loads (__ldg), 64 independent loads in
// one L2 round trip. Shuffles hand the values to every lane in i order,
// which adds them from 0.0f (the plain version starts from zeros: 0 + -0
// is +0), a chain of 64 dependent adds; lane 0 writes the sum. Nothing is
// staged: no shared memory, no opt-in, no barrier. Bound: bytes (64 table
// reads, one output).
extern "C" __global__ void probe_smem_input(const float* __restrict__ tab, int rows,
                                            float* __restrict__ out) {
  const int lane = threadIdx.x;
  const float lo = __ldg(&tab[((lane * 977) % rows) * 8 + lane % 8]);
  const float hi = __ldg(&tab[(((lane + 32) * 977) % rows) * 8 + lane % 8]);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc = acc + __shfl_sync(0xffffffffu, lo, i);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc = acc + __shfl_sync(0xffffffffu, hi, i);
  if (lane == 0) out[0] = acc;
}

PROBE_ENTRY(smem_input) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  probe_smem_input<<<1, 32, 0, STREAM>>>((const float*)a, n, (float*)out);
  return (int)cudaGetLastError();
}

// 8d. probe_while_walk_smem (tools/probe_mosaic.py:89): out = rays (8,128);
// a cursor follows links (n,1) from 0 until it is negative, and at each
// step every element gains the cursor where the cursor's successor is >= 0,
// the adds in walk order.
//
// Walked link by link, the function is a serial chain: one dependent read,
// a compare and a branch a step (99 on the tool's chain). This kernel
// takes the walk off that chain. A walk that ends visits each node at most
// once, so it is at most n steps long, and its cursors p_d = succ^d(0)
// come from pointer doubling. With J_0 = links and J_{k+1}[i] = J_k[i] < 0
// ? -1 : J_k[J_k[i]] (succ^(2^k), -1 past a walk's end):
// * rounds h = 2^k = 1, 2, 4, 8, 16 extend the cursors known, p_0 ..
//   p_{h-1}, to p_{2h-1}: lane d < h looks up p_{d+h} = J_k[p_d] and a
//   shuffle hands it to lane d + h, while every lane squares J_k at its
//   four nodes into J_{k+1};
// * then p_{d+32} = J_5[p_d]: lane d holds p_d, p_{d+32}, p_{d+64},
//   p_{d+96}, three dependent lookups in the lane. 8 rounds of lookups in
//   all at n = 100 (7 of doubling would need J_6 as well).
// A cursor once negative stays so: the walk's length L is the count of p_d
// >= 0, d < n, and step d adds p_d where p_{d+1} >= 0, so the adds are p_0
// .. p_{L-2}. Then each element adds those cursors in walk order, one
// dependent float add a step, independent across elements.
// * One warp a block holds J_k in shared memory, rows by turns, a
//   __syncwarp a round: a lookup at a node that differs from lane to lane
//   is one shared-memory load (~30 clocks), where from registers (four
//   nodes a lane) it would be four shuffles (~32 clocks each) and a
//   select. Each round issues all its loads before its stores: the
//   compiler cannot tell the rows apart, and a store between two loads
//   would put a load's latency on the chain four times a round.
// * 16 blocks of one warp, two elements a lane: a step is two adds and a
//   quarter of a 16-byte broadcast load from shared memory, under the
//   clocks of the add chain (~4.3 a step). Each block doubles for itself
//   on the links it reads from L2 (400 bytes); no block waits on another.
// A table whose walk from 0 has not ended after n steps has a cycle; a link
// past the table (>= n) is taken as a link to itself, a cycle too. On such
// a table the JAX probe and the plain version never return (or fail on the
// index); this kernel returns no plausible sum: it writes NaN to every
// element. n must lie in [1, 128]: the entry returns cudaErrorInvalidValue
// without a launch otherwise. Bound: bytes (rays in, out, the links
// walked); chip_smoke.py prints the add chain's floor beside it (one
// dependent add a step, 4 clocks).
constexpr int kLinkMax = 128;       // nodes a table may hold: four a lane
constexpr int kLinkElems = 2 * 32;  // elements a block: two a lane
constexpr int kLinkBlocks = kS * kL / kLinkElems;

extern "C" __global__ void __launch_bounds__(32)
    probe_while_walk_smem(const int32_t* __restrict__ links, int n,
                          const float* __restrict__ rays, float* __restrict__ out) {
  // J_0 (the links, kept for the cycle test), then J_k in rows 1 and 2 by
  // turns.
  __shared__ int32_t s_jump[3][kLinkMax];
  __shared__ __align__(16) float s_add[kLinkMax];  // the cursors added, then +0.0
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kLinkElems + lane;
  float acc0 = rays[e], acc1 = rays[e + 32];  // loaded now, added to last
  int jump[4];  // J_k at this lane's nodes lane + 32 u
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane + 32 * u;
    int l = i < n ? __ldg(&links[i]) : -1;
    if (l >= n) l = i;
    jump[u] = l;
    s_jump[0][i] = l;
  }
  __syncwarp();
  // p[u] = p_{lane + 32 u}. Rounds h = 1 .. 16: lane d < h looks up
  // p_{d+h}, a shuffle moves it to lane d + h; each round's loads come
  // before its stores (the compiler cannot tell the rows apart).
  int p[4] = {lane == 0 ? 0 : -1, -1, -1, -1};
  int row = 0;  // the row of J_k
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int h = 1 << k;
    if (h >= n) break;
    const int ext = lane < h && p[0] >= 0 ? s_jump[row][p[0]] : -1;
    int sq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) sq[u] = jump[u] < 0 ? -1 : s_jump[row][jump[u]];
    const int next = row == 1 ? 2 : 1;
#pragma unroll
    for (int u = 0; u < 4; ++u) s_jump[next][lane + 32 * u] = jump[u] = sq[u];
    row = next;
    const int moved = __shfl_sync(0xffffffffu, ext, (lane - h) & 31);
    if (lane >= h && lane < 2 * h) p[0] = moved;
    __syncwarp();
  }
  // p_0 .. p_31 known and J_5 = succ^32 in `row`: p_{d+32} = J_5[p_d] in the
  // same lane.
#pragma unroll
  for (int u = 1; u < 4; ++u) {
    if (32 * u < n) p[u] = p[u - 1] < 0 ? -1 : s_jump[row][p[u - 1]];
  }
  int len = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    len += __popc(__ballot_sync(0xffffffffu, lane + 32 * u < n && p[u] >= 0));
  }
  const int adds = len - 1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    s_add[lane + 32 * u] = lane + 32 * u < adds ? (float)p[u] : 0.0f;
  }
  __syncwarp();
  // The adds in groups of 16, the next group's four 16-byte loads issued
  // before this group's adds; the last group's tail adds +0.0, which leaves
  // every sum as it is: x + 0 is x but for x = -0.0, and no sum is -0.0
  // after the first add, of cursor 0 itself (a sum is -0.0 only where both
  // terms are). A walk that adds nothing adds no group.
  const float4* s_add4 = reinterpret_cast<const float4*>(s_add);
  float4 c[4], nc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = s_add4[i];
  for (int g = 0; g < (adds + 15) / 16; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) nc[i] = s_add4[(4 * g + 4 + i) % (kLinkMax / 4)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc0 = acc0 + c[i].x;
      acc1 = acc1 + c[i].x;
      acc0 = acc0 + c[i].y;
      acc1 = acc1 + c[i].y;
      acc0 = acc0 + c[i].z;
      acc1 = acc1 + c[i].z;
      acc0 = acc0 + c[i].w;
      acc1 = acc1 + c[i].w;
      c[i] = nc[i];
    }
  }
  // The walk ended iff its last cursor p_{len-1} links to a negative; where
  // len < n that holds, as p_len < 0.
  const int last = n - 1;
  const int held = last < 32 ? p[0] : last < 64 ? p[1] : last < 96 ? p[2] : p[3];
  const int tail = __shfl_sync(0xffffffffu, held, last & 31);
  if (len == n && s_jump[0][tail] >= 0) acc0 = acc1 = __int_as_float(0x7fffffff);
  out[e] = acc0;
  out[e + 32] = acc1;
}

PROBE_ENTRY(while_walk_smem) {
  if (n < 1 || n > kLinkMax) return (int)cudaErrorInvalidValue;
  probe_while_walk_smem<<<kLinkBlocks, 32, 0, STREAM>>>((const int32_t*)a, n,
                                                        (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tools/pallas_probe.py (M, S, L = 2048, 8, 128)
// ---------------------------------------------------------------------------

// The row an index i of a gather over `rows` rows reads, by JAX's rule: i
// + rows for i in [-rows, 0), i in [0, rows); -1 where i is out of range
// (JAX's gather fills NaN there).
__device__ __forceinline__ int jax_row(int i, int rows) {
  const int r = i < 0 ? i + rows : i;
  return (unsigned)r < (unsigned)rows ? r : -1;
}

// float32 NaN with the bits of PyTorch's float("nan") and JAX's fill.
__device__ __forceinline__ float fill_nan() { return __int_as_float(0x7fc00000); }

// 8e. take_along_axis axis0 (tools/pallas_probe.py:53): out[m, l] =
// table[idx[m, l], l], (2048,128), rows by JAX's index rule (jax_row; NaN
// out of range). Bound: bytes (table, idx and out, 1 MiB each). A table
// element reaches an SM inside its 32-byte sector (8 floats of one row),
// and the tool's idx = (7 m + l) % 2048 needs each sector for 8 outputs in
// 8 scattered rows, so a gather that reads L2 moves 8 MiB of table sectors
// into the SMs, and that, not the launch, is its time. Holding the table
// once across a cluster does not pay on this card (PERF.md, 8e): each
// cluster barrier costs ~0.6 us and each read of a peer's shared memory
// more than a sector from L2; staging a 64 KiB column strip per block moves
// as many bytes as the gather. So the kernel reads L2 directly, with the
// fewest instructions: thread t of 65,536 takes columns 4q .. 4q + 3 of row
// m (t = 32 m + q), one 16-byte index load, four independent read-only
// table loads (of row 0 where an index is out of range, then NaN), one
// 16-byte store; a warp's index load and store are 512 contiguous bytes.
// No shared memory, no barrier. A gather does no arithmetic: bit for bit
// its plain version. The index loads and stores need idx and out 16-byte
// aligned: the entry returns cudaErrorMisalignedAddress without a launch
// where either is not (never falling back to 4-byte accesses), and
// cudaErrorInvalidValue for a table of other than 2048 rows.
constexpr int kTaThreads = 256;
constexpr int kTaGrid = kM * kL / 4 / kTaThreads;  // 256 blocks, 4 outputs a thread

extern "C" __global__ void __launch_bounds__(kTaThreads)
    probe_take_along_axis_axis0(const float* __restrict__ table, const int4* __restrict__ idx,
                                float4* __restrict__ out) {
  const int t = blockIdx.x * kTaThreads + threadIdx.x;
  const int4 i = __ldg(&idx[t]);
  const int col = 4 * (t % (kL / 4));
  const int r0 = jax_row(i.x, kM), r1 = jax_row(i.y, kM);
  const int r2 = jax_row(i.z, kM), r3 = jax_row(i.w, kM);
  const float v0 = __ldg(&table[(r0 < 0 ? 0 : r0) * kL + col]);
  const float v1 = __ldg(&table[(r1 < 0 ? 0 : r1) * kL + col + 1]);
  const float v2 = __ldg(&table[(r2 < 0 ? 0 : r2) * kL + col + 2]);
  const float v3 = __ldg(&table[(r3 < 0 ? 0 : r3) * kL + col + 3]);
  const float nan = fill_nan();
  out[t] = make_float4(r0 < 0 ? nan : v0, r1 < 0 ? nan : v1, r2 < 0 ? nan : v2,
                       r3 < 0 ? nan : v3);
}

PROBE_ENTRY(take_along_axis_axis0) {
  if (((uintptr_t)b | (uintptr_t)out) % sizeof(int4) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n != kM) return (int)cudaErrorInvalidValue;
  probe_take_along_axis_axis0<<<kTaGrid, kTaThreads, 0, STREAM>>>(
      (const float*)a, (const int4*)b, (float4*)out);
  return (int)cudaGetLastError();
}

// 8f. take_along_axis axis1 (tools/pallas_probe.py:67): out[s, l] =
// table[s, idx[s, l] % 128], a per-lane lookup within a row. table[:8]
// (8,128) VMEM -> shared memory (4 KiB); idx (8,128) VMEM -> registers.
// Bound: bytes (the 8 rows, idx, out).
extern "C" __global__ void probe_take_along_axis_axis1(const float* __restrict__ rows,
                                                       const int32_t* __restrict__ idx,
                                                       float* __restrict__ out) {
  __shared__ float s_rows[kS * kL];
  stage(s_rows, rows, kS * kL);
  const int t = threadIdx.x;
  int lane = idx[t] % kL;
  if (lane < 0) lane += kL;  // the floor modulo of jnp and PyTorch
  out[t] = s_rows[(t / kL) * kL + lane];
}

PROBE_ENTRY(take_along_axis_axis1) {
  probe_take_along_axis_axis1<<<1, kS * kL, 0, STREAM>>>(
      (const float*)a, (const int32_t*)b, (float*)out);
  return (int)cudaGetLastError();
}

// 8g. jnp.take axis0 rowgather (tools/pallas_probe.py:76): out = table8[idx],
// (128,8), rows by JAX's index rule (jax_row over the table's n rows; a row
// of NaN out of range). A row of table8 (n,8) VMEM is 32 B, two float4s:
// thread t of 256 loads idx[t / 2] (idx (128,) VMEM; a warp's index loads
// coalesce), then half t % 2 of that row (of row 0 where the index is out
// of range, its value then replaced by NaN) with one read-only 16-byte load
// (ld.global.nc.v4.f32, from L2), and writes float4 t of out. Only the 128
// rows gathered are read; nothing is staged. The 16-byte loads and stores
// need table8 and out 16-byte aligned: the entry returns
// cudaErrorMisalignedAddress without a launch where either is not, and
// never falls back to 4-byte loads. Bound: bytes (the 128 rows gathered,
// idx, out).
extern "C" __global__ void probe_take_rowgather(const float4* __restrict__ table8,
                                                const int32_t* __restrict__ idx, int rows,
                                                float4* __restrict__ out) {
  const int t = threadIdx.x;
  const int row = jax_row(__ldg(&idx[t / 2]), rows);
  const float4 v = __ldg(&table8[(row < 0 ? 0 : row) * 2 + t % 2]);
  const float nan = fill_nan();
  out[t] = row < 0 ? make_float4(nan, nan, nan, nan) : v;
}

PROBE_ENTRY(take_rowgather) {
  if (((uintptr_t)a | (uintptr_t)out) % sizeof(float4) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  probe_take_rowgather<<<1, kL * 2, 0, STREAM>>>((const float4*)a, (const int32_t*)b, n,
                                                 (float4*)out);
  return (int)cudaGetLastError();
}

// 8h. vmem scalar dynamic read (tools/pallas_probe.py:83): the sum over
// j < 4 of table8[idx[0, j], 0], in order. table8 (2048,8) VMEM and idx
// (1,128) SMEM are read by one warp straight from global memory (L2):
// lanes 0-3 load idx[0, 0..3] (one coalesced load), then each its element
// table8[idx[0, lane], 0], read-only loads (__ldg): 4 independent loads in
// two dependent L2 round trips, as 8a makes for 16. Shuffles hand the 4
// values to every lane, which adds them in index order from 0.0f (the
// plain version starts from zeros: 0 + -0 is +0); lane 0 writes out[0].
// Only the 4 elements are read; nothing is staged, no shared memory, no
// barrier. Bound: bytes (4 reads, 4 indices, one output).
extern "C" __global__ void probe_vmem_scalar_dynamic_read(const float* __restrict__ table8,
                                                          const int32_t* __restrict__ idx,
                                                          float* __restrict__ out) {
  const int lane = threadIdx.x;
  const float v = lane < 4 ? __ldg(&table8[__ldg(&idx[lane]) * 8]) : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = acc + __shfl_sync(0xffffffffu, v, j);
  if (lane == 0) out[0] = acc;
}

PROBE_ENTRY(vmem_scalar_dynamic_read) {
  probe_vmem_scalar_dynamic_read<<<1, 32, 0, STREAM>>>((const float*)a, (const int32_t*)b,
                                                       (float*)out);
  return (int)cudaGetLastError();
}

// 8i. ref ds-row read (tools/pallas_probe.py:101): table8[i, :] broadcast to
// (8,8). A row of table8 (2048,8) VMEM is 32 B, two float4s: each of 16
// threads (one warp) reads i (1,) SMEM (one broadcast load), then half t % 2
// of row i with one read-only 16-byte load (ld.global.nc.v4.f32, from L2),
// and writes float4 t of out. Only the one row is read; nothing is staged,
// no shared memory, no barrier. The entry refuses a table or output off 16
// bytes with cudaErrorMisalignedAddress, without a launch. Bound: bytes
// (index, one row, out).
extern "C" __global__ void probe_ref_ds_row_read(const int32_t* __restrict__ i,
                                                 const float4* __restrict__ table8,
                                                 float4* __restrict__ out) {
  const int t = threadIdx.x;
  out[t] = __ldg(&table8[__ldg(i) * 2 + t % 2]);
}

PROBE_ENTRY(ref_ds_row_read) {
  if (((uintptr_t)b | (uintptr_t)out) % sizeof(float4) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  probe_ref_ds_row_read<<<1, kS * 8 / 4, 0, STREAM>>>((const int32_t*)a, (const float4*)b,
                                                      (float4*)out);
  return (int)cudaGetLastError();
}

// 8j. one-hot matmul gather (tools/pallas_probe.py:117): onehot(idx, 2048)
// (128 x 2048) @ table8, (128,8): every output is a 2,048-term dot product
// in fp32 (not tensor cores), exact in any order because one product is
// non-zero (see the top of this file). The one-hot is made in the kernel
// (iota == idx) and never stored; all 2 x 128 x 2048 x 8 products and sums
// are formed, each as one fmaf, which rounds as the product (exact: 0 or
// the table's value) and then the sum would. Bound: operations (4.2 Mflop,
// 0.06 us at 67 TFLOP/s); the time goes to latency, so the product is
// spread over 64 blocks and each thread's chain is short:
// * 64 blocks: 8 row tiles of 16 output rows, each a cluster of 8 blocks
//   (__cluster_dims__, so a plain <<<>>> launch and its graph capture take
//   it) over 8 K slices of 256 table rows. A block reads its 8 KiB slice
//   once, with 16-byte loads, into shared memory: each row of it is read
//   by the 16 output rows of the tile;
// * 256 threads a block: output row r of the tile and k-group g (16 each);
//   the thread sums its row's products over the slice's rows g + 16 j
//   (j < 16) into 8 independent accumulators, one per column (a chain of
//   16), then a warp-shuffle tree over the 16 k-groups (4 steps);
// * the k-group-0 thread of each row writes its 8 partial sums into the
//   shared memory of the cluster's block of rank 0 (distributed shared
//   memory); after the cluster barrier, rank 0 adds the 8 slices' partials
//   in rank order and writes the tile. No atomics, one launch.
// table8 is read as float4: the entry refuses a table off 16 bytes with
// cudaErrorMisalignedAddress, without a launch.
constexpr int kOhRows = 16;                          // output rows per tile
constexpr int kOhSlices = 8;                         // K slices: a cluster's blocks
constexpr int kOhK = kM / kOhSlices;                 // table rows per slice
constexpr int kOhGroups = 16;                        // k-groups per output row
constexpr int kOhThreads = kOhRows * kOhGroups;      // 256
constexpr int kOhGrid = (kL / kOhRows) * kOhSlices;  // 64 blocks

extern "C" __global__ void __cluster_dims__(kOhSlices, 1, 1) __launch_bounds__(kOhThreads)
    probe_onehot_matmul_gather(const float4* __restrict__ table8,
                               const int32_t* __restrict__ idx, float* __restrict__ out) {
  // The slice, its two 16-byte halves apart, so that the 16 k-groups of a
  // warp read 16 consecutive float4s.
  __shared__ float4 s_half[2][kOhK];
  // The cluster's partial sums, [slice][row * 8 + column]; used in rank 0.
  __shared__ __align__(16) float s_part[kOhSlices][kOhRows * 8];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int slice = (int)cluster.block_rank();
  const int tile = blockIdx.x / kOhSlices;
  const int t = threadIdx.x;
  // This block has started (its shared memory exists): waited on before
  // any block writes into another's.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int k0 = slice * kOhK;
  const float4* src = table8 + k0 * 2;
  for (int q = t; q < 2 * kOhK; q += kOhThreads) s_half[q % 2][q / 2] = __ldg(&src[q]);
  const int r = t / kOhGroups, g = t % kOhGroups;
  const int hot = __ldg(&idx[tile * kOhRows + r]);
  __syncthreads();
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < kOhK / kOhGroups; ++j) {
    const int k = g + kOhGroups * j;
    const float oh = k0 + k == hot ? 1.0f : 0.0f;
    const float4 lo = s_half[0][k], hi = s_half[1][k];
    acc[0] = fmaf(oh, lo.x, acc[0]);
    acc[1] = fmaf(oh, lo.y, acc[1]);
    acc[2] = fmaf(oh, lo.z, acc[2]);
    acc[3] = fmaf(oh, lo.w, acc[3]);
    acc[4] = fmaf(oh, hi.x, acc[4]);
    acc[5] = fmaf(oh, hi.y, acc[5]);
    acc[6] = fmaf(oh, hi.z, acc[6]);
    acc[7] = fmaf(oh, hi.w, acc[7]);
  }
  // The 16 k-groups of a row are lanes that differ in their low 4 bits.
#pragma unroll
  for (int off = kOhGroups / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = acc[c] + __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (g == 0) {
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(&s_part[slice][r * 8], 0));
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  cluster.sync();
  if (slice == 0 && t < kOhRows * 8) {
    float sum = s_part[0][t];
#pragma unroll
    for (int s = 1; s < kOhSlices; ++s) sum = sum + s_part[s][t];
    out[tile * kOhRows * 8 + t] = sum;
  }
}

PROBE_ENTRY(onehot_matmul_gather) {
  if ((uintptr_t)a % sizeof(float4) != 0) return (int)cudaErrorMisalignedAddress;
  probe_onehot_matmul_gather<<<kOhGrid, kOhThreads, 0, STREAM>>>(
      (const float4*)a, (const int32_t*)b, (float*)out);
  return (int)cudaGetLastError();
}

// 8j's launch geometry, as phase 20 of chip_smoke.py records it: v[0] the
// grid, v[1] the block, v[2] the cluster size and v[3] the static shared
// memory in bytes, both as the loaded kernel reports them
// (cudaFuncGetAttributes), and v[4] how many such clusters the card holds
// at once (cudaOccupancyMaxActiveClusters).
extern "C" int llr_probe_geometry_onehot_matmul_gather(int* v) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, probe_onehot_matmul_gather);
  if (err != cudaSuccess) return (int)err;
  v[0] = kOhGrid;
  v[1] = kOhThreads;
  v[2] = attr.requiredClusterWidth;
  v[3] = (int)attr.sharedSizeBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kOhGrid);
  cfg.blockDim = dim3(kOhThreads);
  return (int)cudaOccupancyMaxActiveClusters(&v[4], probe_onehot_matmul_gather, &cfg);
}

// 8k. pltpu.prng_random_bits (tools/pallas_probe.py:130): (8,128) random
// int32 bits >> 8 (arithmetic), as float32. The TPU's hardware generator
// cannot be reproduced; this replaces it with the port's pcg4d counter
// generator (common.cuh::uniform4, the renderer's own), seeded from seed[0]
// (SMEM -> every thread reads it), one counter per output element on its
// flat index: pcg4d(lane = index, ctr = 0, seed, salt), first word. uniform4
// hands the word's top 24 bits as (w >> 8) / 2^24, exactly; scaling back and
// sign-extending those 24 bits is the arithmetic shift of the int32 word.
// Bound: bytes (the output; ~35 integer operations per element).
extern "C" __global__ void probe_prng_random_bits(const int32_t* __restrict__ seed,
                                                  float* __restrict__ out) {
  const int t = threadIdx.x;
  float u[4];
  uniform4((uint32_t)seed[0], (uint32_t)t, 0u, u);
  const uint32_t top = (uint32_t)(u[0] * 16777216.0f);  // w >> 8, exact
  out[t] = (float)((int32_t)(top << 8) >> 8);
}

PROBE_ENTRY(prng_random_bits) {
  probe_prng_random_bits<<<1, kS * kL, 0, STREAM>>>((const int32_t*)a, (float*)out);
  return (int)cudaGetLastError();
}

// 8l. while_loop with vector state (tools/pallas_probe.py:144): ten times
// acc += table[0:8], in order. table global (L2; the 1 MiB table does not
// fit shared memory), one element per thread in a register. Bound: bytes
// (8 rows in, out).
extern "C" __global__ void probe_while_loop_vector_state(const float* __restrict__ table,
                                                         float* __restrict__ out) {
  const int t = threadIdx.x;
  const float x = table[t];
  float acc = 0.0f;
  for (int i = 0; i < 10; ++i) acc = acc + x;
  out[t] = acc;
}

PROBE_ENTRY(while_loop_vector_state) {
  probe_while_loop_vector_state<<<1, kS * kL, 0, STREAM>>>((const float*)a, (float*)out);
  return (int)cudaGetLastError();
}

// 8m. scatter-add (tools/pallas_probe.py:162): zeros (2048,128) with 1.0
// added at (idx[s, l], 0) for every (s, l), rows 0:8 out. An index i in
// [-2048, 0) stands for row i + 2048, as JAX and index_put_ take it; one
// outside [-2048, 2048) is dropped, as JAX's scatter drops it. Only rows 0-7
// leave the kernel, and each of their elements is a count: [r, 0] the
// indices that land on row r, every other element +0.0. So the kernel
// counts them, with no scratch, memset, atomics or shared memory: one block
// of four warps, warp p for rows 2p and 2p + 1, each warp on its own
// scheduler, so that the compares and adds over the 1,024 indices, the
// kernel's longest part, are split four ways (one warp counting all eight
// rows took 6-9% longer in turns, however few instructions an index). Lane
// l of each warp reads its 32 indices as eight 16-byte loads (int4 l +
// 32 k, coalesced; the four warps share them through L1), counts its hits
// of the warp's two rows in the 16-bit halves of one register, and one
// __reduce_add_sync sums both over the warp (a count is at most 1,024).
// Each warp writes its two rows of the output as float4 stores, (float)
// count at [r, 0] and +0.0 elsewhere: a count below 2^24 is exact, so it
// equals the plain version's sum of 1.0s in any order. table (an input of
// the probe) is not read. The entry refuses idx or out off 16 bytes
// (cudaErrorMisalignedAddress) without a launch. Bound: bytes (idx, out).
//
// Index i lands on row r < 8 exactly where w = i + 2048 (mod 2^32) is r or
// 2048 + r, that is where w with bit 11 cleared is r.
constexpr int kScatterWarps = kS / 2;

extern "C" __global__ void __launch_bounds__(kScatterWarps * 32)
    probe_scatter_add(const int4* __restrict__ idx, float4* __restrict__ out) {
  constexpr int kLoads = kS * kL / 4 / 32;  // int4 loads a lane
  const int lane = threadIdx.x % 32, row = 2 * (threadIdx.x / 32);
  unsigned hits = 0;  // row `row` in bits 0-15, `row` + 1 in bits 16-31
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int4 v = __ldg(&idx[lane + 32 * k]);
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned w = (unsigned)e[q] + kM;
      hits += (w & ~(unsigned)(kM | 1)) == (unsigned)row ? 1u << (16 * (w % 2)) : 0u;
    }
  }
  const unsigned both = __reduce_add_sync(0xffffffffu, hits);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float count = (float)((both >> (16 * h)) & 0xffffu);
    out[(row + h) * (kL / 4) + lane] = make_float4(lane == 0 ? count : 0.0f, 0.0f, 0.0f, 0.0f);
  }
}

PROBE_ENTRY(scatter_add) {
  if (((uintptr_t)b | (uintptr_t)out) % sizeof(float4) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  probe_scatter_add<<<1, kScatterWarps * 32, 0, STREAM>>>((const int4*)b, (float4*)out);
  return (int)cudaGetLastError();
}

// 8n. packet-walk core (tools/pallas_probe.py:171): a cursor walks the rows
// of table (rows x 128) from row 0: acc += row; the next cursor is +7 when
// any lane of the row exceeds 0.5 rows 128 (131072 for the probe's 2048
// rows), else +1; the walk stops at rows. The sums pass 2^24, so each lane
// adds the rows it visits in walk order.
//
// A row's vote depends on that row alone, not on the cursor, so the votes
// are taken ahead of the walk, in parallel, and the walk waits on no
// barrier a step. One block of 10 warps streams the table through a ring
// of kWalkStages tiles of 32 rows (16 KiB) in shared memory; each role
// hands tiles on through mbarriers:
// * the producer (warp 9, one lane) copies a tile with one TMA bulk copy
//   (cp.async.bulk), whose bytes complete the stage's `full` barrier, once
//   the walkers have released the stage (`empty`);
// * the voters (warps 5-8) vote the tile's rows, 8 rows a warp, a row a
//   step: a float4 a lane, __any_sync; each warp writes its byte of the
//   tile's 32-bit vote mask and arrives on the tile's `voted` barrier;
// * the navigator (warp 4) walks the cursor over the masks: from the
//   cursor, +1 up to the next voting row, then +7, carried across tiles (a
//   +7 from a tile's last rows lands in the next). Four tiles at once: lane
//   7 t + e walks tile t from entry row e, for each of the 7 entry rows a
//   jump can leave, and shuffles then chain the tiles' entries. It writes
//   each tile's visited rows, in walk order, to shared memory (a lane a
//   row, its place a popcount) and arrives on the tile's `navigated`;
// * the walkers (warps 0-3), thread j for lane j, add their lane of each
//   tile's visited rows in walk order (a tile visited wholly as 32 loads
//   issued together, then 32 dependent adds; others from the visited list)
//   and release the stage.
// Bound: bytes (the rows visited, out), 1.8e-4 ms at 3.35 TB/s. The
// function keeps a floor above that: its sums stay in walk order, one
// dependent float add a step a lane (1,171 steps on the arange table, 4
// clocks each: 0.0024 ms at 1.98 GHz). table must be 16-byte aligned, and
// rows a multiple of 128 and at most 2048: the entry returns
// cudaErrorMisalignedAddress or cudaErrorInvalidValue without a launch
// otherwise.
constexpr int kWalkTile = 32;                               // rows a tile: a bit each of a mask
constexpr int kWalkStages = 8;                              // tiles in the ring
constexpr int kWalkTiles = kM / kWalkTile;                  // tiles of the largest table taken
constexpr int kWalkGroup = 4;                               // tiles the navigator walks at once
constexpr int kWalkers = kL / 32, kVoters = 4;              // warps
constexpr int kWalkThreads = (kWalkers + kVoters + 2) * 32;  // and the navigator, the producer
constexpr int kWalkTileBytes = kWalkTile * kL * (int)sizeof(float);
constexpr int kWalkSmem = kWalkStages * kWalkTileBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed: a
// non-blocking test first (a phase long complete costs a load, not a
// suspend), then blocking tries. A wait that outlasts 2^22 tries (seconds)
// traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == 1u << 22) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA bulk copy of `bytes` from global to shared memory, whose bytes
// complete `bar`'s phase: the producer's arrival with their count first.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%2], [%3], %1, [%0];"
      ::"r"(smem_u32(bar)), "r"(bytes), "r"(smem_u32(dst)), "l"(src)
      : "memory");
}

extern "C" __global__ void __launch_bounds__(kWalkThreads)
    probe_packet_walk_core(const float* __restrict__ table, int rows, float* __restrict__ out) {
  extern __shared__ __align__(128) float s_ring[];  // [stage][row][kL]
  __shared__ uint64_t full[kWalkStages], empty[kWalkStages];
  __shared__ uint64_t voted[kWalkTiles], navigated[kWalkTiles];
  __shared__ uint32_t votes[kWalkTiles];                 // a tile's vote mask,
  __shared__ uint32_t visits[kWalkTiles];                // its visited rows,
  __shared__ uint32_t order[kWalkTiles][kWalkTile / 4];  // in walk order, a byte each
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = rows / kWalkTile;
  if (warp == 0) {  // the barriers, a lane each, made visible to the TMA unit
    if (lane < kWalkStages) {
      mbar_init(&full[lane], 1);
      mbar_init(&empty[lane], kWalkers);
    }
    for (int k = lane; k < tiles; k += 32) {
      mbar_init(&voted[k], kVoters);
      mbar_init(&navigated[k], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWalkers + kVoters + 1) {  // the producer
    for (int k = 0; k < tiles && lane == 0; ++k) {
      const int s = k % kWalkStages;
      if (k >= kWalkStages) mbar_wait(&empty[s], (k / kWalkStages - 1) & 1);
      bulk_load(s_ring + s * kWalkTile * kL, table + (int64_t)k * kWalkTile * kL,
                kWalkTileBytes, &full[s]);
    }
  } else if (warp > kWalkers) {  // a voter: rows 8 v .. 8 v + 7 of each tile
    constexpr int kRows = kWalkTile / kVoters;
    const int v = warp - kWalkers - 1;
    const float thresh = 0.5f * (float)(rows * kL);
    for (int k = 0; k < tiles; ++k) {
      const int s = k % kWalkStages;
      mbar_wait(&full[s], (k / kWalkStages) & 1);
      const float4* t = reinterpret_cast<const float4*>(s_ring + (s * kWalkTile + v * kRows) * kL);
      uint32_t bits = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = t[r * (kL / 4) + lane];
        const bool hit = (x.x > thresh) | (x.y > thresh) | (x.z > thresh) | (x.w > thresh);
        bits |= (uint32_t)__any_sync(0xffffffffu, hit) << r;
      }
      if (lane == 0) {
        reinterpret_cast<uint8_t*>(&votes[k])[v] = (uint8_t)bits;
        mbar_arrive(&voted[k]);
      }
    }
  } else if (warp == kWalkers) {  // the navigator: lane 7 t + e, tile t, entry row e
    const int t = lane / 7, e = lane % 7;
    int entry = 0;  // the cursor's row in the next tile
    for (int g = 0; g < tiles; g += kWalkGroup) {
      uint32_t vis = 0;
      int leave = 0;
      if (t < kWalkGroup) {
        mbar_wait(&voted[g + t], 0);
        const uint32_t vote = votes[g + t];
        int r = e;
        while (r < kWalkTile) {
          const uint32_t ahead = vote >> r;
          if (ahead == 0) {  // +1 to the end of the tile
            vis |= ~0u << r;
            r = kWalkTile;
          } else {  // rows r .. r + h, then +7 from the voting row r + h
            const int h = __ffs(ahead) - 1;
            vis |= ((2u << h) - 1u) << r;
            r += h + 7;
          }
        }
        leave = r - kWalkTile;
      }
#pragma unroll
      for (int u = 0; u < kWalkGroup; ++u) {
        const uint32_t tv = __shfl_sync(0xffffffffu, vis, 7 * u + entry);
        entry = __shfl_sync(0xffffffffu, leave, 7 * u + entry);
        if ((tv >> lane) & 1u) {
          reinterpret_cast<uint8_t*>(order[g + u])[__popc(tv & ((1u << lane) - 1u))] =
              (uint8_t)lane;
        }
        if (lane == 0) visits[g + u] = __popc(tv);
        __syncwarp();
        if (lane == 0) mbar_arrive(&navigated[g + u]);
      }
    }
  } else {  // a walker: lane threadIdx.x of the table
    const int j = threadIdx.x;
    float acc = 0.0f;
    for (int k = 0; k < tiles; ++k) {
      const int s = k % kWalkStages;
      // The tile's list, then its bytes: the walker waits on the stage's
      // `full` itself, not through the voters' and the navigator's barriers
      // (by then that phase is complete: one test_wait).
      mbar_wait(&navigated[k], 0);
      mbar_wait(&full[s], (k / kWalkStages) & 1);
      const int n = (int)visits[k];
      const float* t = s_ring + s * kWalkTile * kL + j;
      float x[kWalkTile];
      if (n == kWalkTile) {
#pragma unroll
        for (int i = 0; i < kWalkTile; ++i) x[i] = t[i * kL];
#pragma unroll
        for (int i = 0; i < kWalkTile; ++i) acc = acc + x[i];
      } else {
        for (int c = 0; c < n; c += 8) {
          const uint32_t lo = order[k][c / 4], hi = order[k][c / 4 + 1];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            x[u] = t[(((u < 4 ? lo : hi) >> (8 * (u % 4))) & (kWalkTile - 1)) * kL];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (c + u < n) acc = acc + x[u];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int r = 0; r < kS; ++r) out[r * kL + j] = acc;
  }
}

PROBE_ENTRY(packet_walk_core) {
  if ((uintptr_t)a % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (n <= 0 || n > kM || n % (kWalkTile * kWalkGroup) != 0) return (int)cudaErrorInvalidValue;
  static int opted[kMaxDevices] = {};
  const cudaError_t err = opt_in(probe_packet_walk_core, kWalkSmem, opted);
  if (err != cudaSuccess) return (int)err;
  probe_packet_walk_core<<<1, kWalkThreads, kWalkSmem, STREAM>>>((const float*)a, n,
                                                                  (float*)out);
  return (int)cudaGetLastError();
}

// 8o. wide 2D ops + argmin (tools/pallas_probe.py:197): per column of x
// (16,256), its minimum plus the row of its first minimum. x VMEM ->
// registers, a column per thread; a strict < keeps the first of equal
// values, as jnp.argmin does. Bound: bytes (x, out).
extern "C" __global__ void probe_wide_2d_argmin(const float* __restrict__ x,
                                                float* __restrict__ out) {
  const int j = threadIdx.x;
  float best = x[j];
  int arg = 0;
  for (int r = 1; r < 16; ++r) {
    const float v = x[r * 256 + j];
    if (v < best) {
      best = v;
      arg = r;
    }
  }
  out[j] = best + (float)arg;
}

PROBE_ENTRY(wide_2d_argmin) {
  probe_wide_2d_argmin<<<1, 256, 0, STREAM>>>((const float*)a, (float*)out);
  return (int)cudaGetLastError();
}

// 8p. scalar broadcast from a VMEM element (tools/pallas_probe.py:210):
// table8[i, 3] broadcast to (8,128). i (1,) SMEM -> every thread reads it
// (one broadcast load); then every thread reads the one element straight
// from L2 (two dependent read-only loads, the same address across the
// block) and writes one float4 of the output: 256 threads, no shared
// memory, no barrier. The entry refuses an output off 16 bytes with
// cudaErrorMisalignedAddress, without a launch. Bound: bytes (index,
// element, out).
extern "C" __global__ void probe_scalar_broadcast(const int32_t* __restrict__ i,
                                                  const float* __restrict__ table8,
                                                  float4* __restrict__ out) {
  const float v = __ldg(&table8[__ldg(i) * 8 + 3]);
  out[threadIdx.x] = make_float4(v, v, v, v);
}

PROBE_ENTRY(scalar_broadcast) {
  if ((uintptr_t)out % sizeof(float4) != 0) return (int)cudaErrorMisalignedAddress;
  probe_scalar_broadcast<<<1, kS * kL / 4, 0, STREAM>>>((const int32_t*)a, (const float*)b,
                                                        (float4*)out);
  return (int)cudaGetLastError();
}

// 8q. dynamic row and lane scalar read (tools/pallas_probe.py:226):
// table[i[0], i[1]] broadcast to (8,128). i (2,) SMEM -> every thread reads
// both; table global (L2), one element. Bound: bytes (out).
extern "C" __global__ void probe_dynamic_row_lane_scalar(const int32_t* __restrict__ i,
                                                         const float* __restrict__ table,
                                                         float* __restrict__ out) {
  out[threadIdx.x] = table[i[0] * kL + i[1]];
}

PROBE_ENTRY(dynamic_row_lane_scalar) {
  probe_dynamic_row_lane_scalar<<<1, kS * kL, 0, STREAM>>>((const int32_t*)a, (const float*)b,
                                                           (float*)out);
  return (int)cudaGetLastError();
}

// 8r. while_loop + pl.when (tools/pallas_probe.py:243): for c < 20, add row
// c % 2048 of table to out when any lane of it exceeds -1 (a block vote) and
// c is even, in order. One block of 128 threads, a lane each; table global
// (L2). Bound: bytes (20 rows, out).
extern "C" __global__ void probe_while_loop_when(const float* __restrict__ table, int rows,
                                                 float* __restrict__ out) {
  const int j = threadIdx.x;
  float acc = 0.0f;
  for (int c = 0; c < 20; ++c) {
    const float v = table[(c % rows) * kL + j];
    const int hit = __syncthreads_or(v > -1.0f);
    if (hit && c % 2 == 0) acc = acc + v;
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) out[s * kL + j] = acc;
}

PROBE_ENTRY(while_loop_when) {
  probe_while_loop_when<<<1, kL, 0, STREAM>>>((const float*)a, n, (float*)out);
  return (int)cudaGetLastError();
}

// 8s. int32 bit ops (tools/pallas_probe.py:265): u = uint32(int32(x)) for x
// in table[:8]; out = float(int32(rotl(u, 13) >> 8)), the logical shift.
// table[:8] VMEM -> registers, an element per thread. Bound: bytes (in, out).
extern "C" __global__ void probe_int32_bit_ops(const float* __restrict__ rows,
                                               float* __restrict__ out) {
  const int t = threadIdx.x;
  uint32_t u = (uint32_t)(int32_t)rows[t];
  u = (u << 13) | (u >> 19);
  out[t] = (float)(int32_t)(u >> 8);
}

PROBE_ENTRY(int32_bit_ops) {
  probe_int32_bit_ops<<<1, kS * kL, 0, STREAM>>>((const float*)a, (float*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tools/probe_wide.py
// ---------------------------------------------------------------------------

// 8t. probe_dyn_row_vector_read (tools/probe_wide.py:34): the sum over i < 8
// of the (1,128) row tab[idx[i], :], in order. tab (64,128) VMEM and idx
// (1,8) SMEM are read by one warp straight from global memory (L2): lane
// i < 8 loads idx[i] (one coalesced 32-byte load) and shuffles hand each
// index to the warp; lane l owns float4 l of the 512-byte row and issues
// its 8 read-only 16-byte loads (ld.global.nc.v4.f32) before the first add,
// so that they are in flight together, then adds them per component in
// index order from 0.0f (the plain version starts from zeros: 0 + -0 is
// +0) and writes one float4. Only the 8 rows gathered are read; nothing is
// staged, no shared memory, no barrier. The 16-byte loads and stores need
// tab and out 16-byte aligned: the entry returns cudaErrorMisalignedAddress
// without a launch where either is not, and never falls back to 4-byte
// loads. Bound: bytes (8 rows, 8 indices, out).
extern "C" __global__ void probe_dyn_row_vector_read(const float4* __restrict__ tab,
                                                     const int32_t* __restrict__ idx,
                                                     float4* __restrict__ out) {
  const int lane = threadIdx.x;
  const int mine = lane < 8 ? __ldg(&idx[lane]) : 0;
  float4 row[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row[i] = __ldg(&tab[__shfl_sync(0xffffffffu, mine, i) * (kL / 4) + lane]);
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc.x = acc.x + row[i].x;
    acc.y = acc.y + row[i].y;
    acc.z = acc.z + row[i].z;
    acc.w = acc.w + row[i].w;
  }
  out[lane] = acc;
}

PROBE_ENTRY(dyn_row_vector_read) {
  if (((uintptr_t)a | (uintptr_t)out) % sizeof(float4) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  probe_dyn_row_vector_read<<<1, kL / 4, 0, STREAM>>>((const float4*)a, (const int32_t*)b,
                                                      (float4*)out);
  return (int)cudaGetLastError();
}

// 8u. probe_narrow_out_block (tools/probe_wide.py:58): the TPU grid (2,) of
// (8,128) -> (8,8) blocks becomes two blocks that compute their own offsets:
// out[r, c] = x[r, c] + 1 for c < 8. x (16,128) VMEM -> registers. Bound:
// bytes (16 x 8 in, out).
extern "C" __global__ void probe_narrow_out_block(const float* __restrict__ x,
                                                  float* __restrict__ out) {
  const int r = blockIdx.x * 8 + threadIdx.x / 8;
  const int c = threadIdx.x % 8;
  out[r * 8 + c] = x[r * kL + c] + 1.0f;
}

PROBE_ENTRY(narrow_out_block) {
  probe_narrow_out_block<<<2, 64, 0, STREAM>>>((const float*)a, (float*)out);
  return (int)cudaGetLastError();
}

// 8v. probe_lane_min_broadcast (tools/probe_wide.py:74): each row's minimum
// of x (8,128), broadcast along the row. A warp per row: four elements per
// lane, then a warp-shuffle minimum. x VMEM -> registers. Bound: bytes (in,
// out).
extern "C" __global__ void probe_lane_min_broadcast(const float* __restrict__ x,
                                                    float* __restrict__ out) {
  const int row = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xr = x + row * kL;
  float m = fminf(fminf(xr[lane], xr[lane + 32]), fminf(xr[lane + 64], xr[lane + 96]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
#pragma unroll
  for (int k = 0; k < 4; ++k) out[row * kL + lane + 32 * k] = m;
}

PROBE_ENTRY(lane_min_broadcast) {
  probe_lane_min_broadcast<<<1, kS * 32, 0, STREAM>>>((const float*)a, (float*)out);
  return (int)cudaGetLastError();
}

// 8w. probe_scalar_row_fill (tools/probe_wide.py:88): out[r, :] = r_in[r, 0],
// an (8,128) tile from 8 scalars. r_in (8,8) VMEM -> every thread reads its
// row's scalar (a broadcast load per row). Bound: bytes (8 scalars, out).
extern "C" __global__ void probe_scalar_row_fill(const float* __restrict__ r_in,
                                                 float* __restrict__ out) {
  out[threadIdx.x] = r_in[(threadIdx.x / kL) * 8];
}

PROBE_ENTRY(scalar_row_fill) {
  probe_scalar_row_fill<<<1, kS * kL, 0, STREAM>>>((const float*)a, (float*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Not a probe: the launch floor the probes sit on, and the card's limit.
// ---------------------------------------------------------------------------

// An empty kernel of one warp. chip_smoke.py times its graph-replayed launch
// beside the probes.
extern "C" __global__ void probe_empty() {}

PROBE_ENTRY(empty) {
  probe_empty<<<1, 32, 0, STREAM>>>();
  return (int)cudaGetLastError();
}

// An empty kernel with 8j's launch geometry (64 blocks of 256 threads in
// clusters of 8) that, for n != 0, passes one cluster barrier: chip_smoke.py
// times both beside 8j, which splits 8j's time into the cluster launch, a
// barrier and the rest.
extern "C" __global__ void __cluster_dims__(kOhSlices, 1, 1) __launch_bounds__(kOhThreads)
    probe_empty_cluster(int barrier) {
  if (barrier) cooperative_groups::this_cluster().sync();
}

PROBE_ENTRY(empty_cluster) {
  probe_empty_cluster<<<kOhGrid, kOhThreads, 0, STREAM>>>(n);
  return (int)cudaGetLastError();
}

// The shared memory one block of `device` may opt in to, in bytes.
extern "C" int llr_probe_smem_limit(int* bytes, int device) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The static shared memory, in bytes, of a kernel that reads its table
// straight from L2 (cudaFuncGetAttributes' sharedSizeBytes, read from the
// loaded library, so the answer holds however long ago it was built); their
// entries launch with no dynamic shared memory.
#define PROBE_STATIC_SMEM(name)                                           \
  extern "C" int llr_probe_static_smem_##name(int* bytes) {              \
    cudaFuncAttributes attr;                                              \
    const cudaError_t err = cudaFuncGetAttributes(&attr, probe_##name);   \
    if (err == cudaSuccess) *bytes = (int)attr.sharedSizeBytes;           \
    return (int)err;                                                      \
  }

PROBE_STATIC_SMEM(vmem_dyn_sublane_static_lane)
PROBE_STATIC_SMEM(take_along_axis_axis0)
PROBE_STATIC_SMEM(vmem_dyn_lane)
PROBE_STATIC_SMEM(smem_input)
PROBE_STATIC_SMEM(take_rowgather)
PROBE_STATIC_SMEM(vmem_scalar_dynamic_read)
PROBE_STATIC_SMEM(ref_ds_row_read)
PROBE_STATIC_SMEM(scalar_broadcast)
PROBE_STATIC_SMEM(dyn_row_vector_read)
PROBE_STATIC_SMEM(scatter_add)
