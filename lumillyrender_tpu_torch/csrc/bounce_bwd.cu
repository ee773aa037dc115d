// The closed-form backward pass of one brute-force bounce on a Lambert-only
// scene under a uniform sky: from the cotangents of the bounce's outputs
// (o', d', throughput', accum') to those of its inputs (o, d, throughput;
// accum's passes through, since accum is add-only) and to the per-row
// albedo and emission gradients of the evaluation table and the sky
// colour's gradient.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bounce.py::
// _bounce_bwd_kernel (called by make_step_diff). Its plain version is
// ops/bounce_bwd.py::plain_bounce_bwd, followed term for term:
//   * the primal is recomputed with the forward kernel's own code
//     (bounce_body.cuh: the intersectors, rr_prob, nee_geometry, scatter),
//     so the backward sees the decisions the forward took;
//     `alive_out`, when not null, receives the recomputed alive' for
//     checking that;
//   * Russian roulette divides by a detached probability;
//   * the throughput weight is w = albedo * checker: cos/pdf cancels exactly,
//     grazing lanes included;
//   * the NEE geometry-term chain, with the sphere shadow-hit normal chain;
//   * emission and sky terms;
//   * the sampled direction's ONB chain and the normal chain of a sphere
//     winner;
//   * the plane-equation t chain, with the radial dt/dd term of a sphere
//     winner (the formula as written, as autodiff of the plain step has it).
//
// The row table `rows` (6*nm + 3): row r's albedo at 6r..6r+2, its
// emission at 6r+3..6r+5, the sky colour at 6nm..6nm+2, summed inside the
// launch in a fixed order, so two runs give the same bits (no float
// atomics):
//   * each warp sums only the rows its lanes touch (the union of the hit's
//     row and the NEE light's row, ascending, by __reduce_min_sync), each
//     row's six components as independent butterflies, and the sky only
//     where a lane missed, into its own table in shared memory;
//   * the grid is persistent (as many blocks as the card holds at once,
//     each walking 128-thread tiles), so there are few partial tables; a
//     block adds its warps' tables in warp order into its column of
//     `partial` (column-major, width x blocks);
//   * the last block to finish (an integer ticket) adds the partials in
//     block order into `rows` and resets the ticket.
// The TPU kernel's 15-row cap is gone: the tables are read from global
// memory, and a row table takes 4 * (6*nm + 3) B of shared memory a warp.
//
// Instances, as the forward kernel's (bounce.cu, chosen by the same
// ops/cuda_bounce.py::bounce_instance): SmallIsect (prims in the constant
// bank, at the narrower stages) or BruteIsect, shading compiled for
// Lambert only. One thread a lane: a group of threads per lane
// (GroupIsect) lost here at the narrow stages, whose few live lanes it
// does not shorten while its 16 times more tiles cost partial tables
// (PERF.md 6.10).
//
// Bound on an H100: memory by the bytes it must move. A live lane that
// hits reads o, d, throughput (36 B), alive (1 B), its lane id (4 B) and
// four cotangents (48 B), and writes three cotangents (36 B): 125 B; one
// that misses needs no lane id (121 B). A dead lane is the identity on the
// o, d and throughput cotangents: alive and three cotangents in, three
// out, 73 B. What holds it back is issued instructions and, at the narrow
// stages, one lane's chain: two brute-force sweeps and a few hundred
// flops of shading and VJP a live lane, built -fmad=false.
#include "bounce_body.cuh"

#include <algorithm>
#include <cstring>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// Blocks an SM must hold: the registers' cap (65,536 / (128 x 5) = 102,
// from 116), whose few spills cost less than the fifth block gains
// (PERF.md 6.10).
constexpr int kMinBlocks = 5;

enum { INSTANCE_SMALL = 1 };

// VJP of n = u / max(|u|, 1e-20) at |u| = len: (g - n (n.g)) / max(len, 1e-20).
__device__ __forceinline__ V3 norm_vjp(V3 n, V3 g, float len) {
  const float ndg = dot(n, g);
  const float inv = 1.0f / fmaxf(len, 1e-20f);
  return scale(sub(g, scale(n, ndg)), inv);
}

// What one lane adds to the row table.
struct RowGrads {
  int mat = -1;   // main hit's row: albedo and emission
  int smat = -1;  // NEE light hit's row: emission through l_e
  bool missed = false;  // the sky term
  V3 a{0.f, 0.f, 0.f}, e{0.f, 0.f, 0.f}, en{0.f, 0.f, 0.f}, sky{0.f, 0.f, 0.f};
};

// Adds the warp's sums of the sky (where a lane missed) and of each row
// its lanes touch, ascending, to the warp's table `mine`: six (three)
// independent butterflies a row. Every lane of the warp calls it.
__device__ __forceinline__ void add_warp_rows(const RowGrads& rg, float* mine, int nm, int lid) {
  if (__any_sync(kFull, rg.missed)) {
    V3 s = rg.sky;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(kFull, s.x, off);
      s.y += __shfl_xor_sync(kFull, s.y, off);
      s.z += __shfl_xor_sync(kFull, s.z, off);
    }
    if (lid == 0) {
      mine[6 * nm] += s.x;
      mine[6 * nm + 1] += s.y;
      mine[6 * nm + 2] += s.z;
    }
  }
  // Rows outside the table add nothing, as in the plain version.
  unsigned pa = rg.mat >= 0 && rg.mat < nm ? (unsigned)rg.mat : kFull;
  unsigned pb = rg.smat >= 0 && rg.smat < nm ? (unsigned)rg.smat : kFull;
  while (true) {
    const unsigned r = __reduce_min_sync(kFull, min(pa, pb));
    if (r == kFull) break;
    const bool in_a = pa == r, in_b = pb == r;
    float v[6] = {in_a ? rg.a.x : 0.f, in_a ? rg.a.y : 0.f, in_a ? rg.a.z : 0.f,
                  (in_a ? rg.e.x : 0.f) + (in_b ? rg.en.x : 0.f),
                  (in_a ? rg.e.y : 0.f) + (in_b ? rg.en.y : 0.f),
                  (in_a ? rg.e.z : 0.f) + (in_b ? rg.en.z : 0.f)};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
    }
    if (lid == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) mine[6 * r + k] += v[k];
    }
    if (in_a) pa = kFull;
    if (in_b) pb = kFull;
  }
}

// The last block: column j's `blocks` partials (contiguous) summed by one
// warp, lane l adding blocks l, l + 32, ... in order, then a butterfly;
// four columns at a time, so that their loads and chains interleave.
__device__ __forceinline__ void finish_rows(const float* partial, float* rows, int width,
                                            int blocks, int warp, int lid) {
  for (int j0 = 4 * warp; j0 < width; j0 += 4 * kWarps) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b = lid; b < blocks; b += 32) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + c < width) s[c] += __ldcg(partial + (int64_t)(j0 + c) * blocks + b);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] += __shfl_xor_sync(kFull, s[c], off);
    }
    if (lid == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + c < width) rows[j0 + c] = s[c];
      }
    }
  }
}

template <class Isect>
__global__ void __launch_bounds__(kBlock, kMinBlocks) bounce_bwd_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const float* __restrict__ thr_in, const uint8_t* __restrict__ alive_in,
    const int32_t* __restrict__ lane_in, const float* __restrict__ go_in,
    const float* __restrict__ gd_in, const float* __restrict__ gt_in,
    const float* __restrict__ ga_in, float* __restrict__ o_bar, float* __restrict__ d_bar,
    float* __restrict__ t_bar, float* __restrict__ rows, float* __restrict__ partial,
    unsigned* __restrict__ ticket, uint8_t* __restrict__ alive_out, Scene sc, Isect isect,
    int n, int tiles, int bounce, int flags, float rr_scale) {
  extern __shared__ float tables[];  // kWarps x width: each warp's row table
  __shared__ bool last;
  const uint32_t seed = __ldg(sc.args + ARG_SEED);
  const int width = 6 * sc.nm + 3;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  float* mine = tables + warp * width;
  for (int j = lid; j < width; j += 32) mine[j] = 0.f;
  __syncwarp();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i = tile * kBlock + threadIdx.x;
    RowGrads rg;
    if (i < n) {
      const V3 gop = load3(go_in, i), gdp = load3(gd_in, i), gTp = load3(gt_in, i);
      const V3 zero = v3(0.f, 0.f, 0.f);
      V3 go_out = gop, gd_out = gdp, gT0 = gTp;
      bool alive3 = false;
      if (alive_in[i] != 0) {  // a dead lane reads nothing more
        const V3 o = load3(o_in, i), d = load3(d_in, i), T0 = load3(thr_in, i);
        const V3 gA = load3(ga_in, i);
        const Hit hp = isect(o, d, LLR_INF, -LLR_INF);
        if (!hp.hit) {  // sky on miss
          gT0 = add(gT0, mul(gA, arg_v3(sc.args, ARG_SKY)));
          rg.sky = mul(gA, T0);
          rg.missed = true;
        } else {
          // ---- primal recompute, as the forward kernel runs it ----
          const Mat ms = load_mat<FAM_LAMBERT>(sc.mats, sc.nm, hp.mat);
          const Mat me = load_mat<FAM_LAMBERT>(sc.mats_eval, sc.nm, hp.mat);
          const V3 out = neg(d);
          const uint32_t lane = (uint32_t)lane_in[i];
          const uint32_t ctr = (uint32_t)bounce * 8u;
          float r[4];
          uniform4(seed, lane, ctr, r);
          const float prob = rr_prob(ms, flags, rr_scale);
          const bool alive2 = prob == 1.0f || r[0] < prob;
          const float pc = fmaxf(prob, 1e-12f);
          V3 sd, w;
          alive3 = alive2 && scatter<FAM_LAMBERT>(ms, me, hp, out, r, sd, w);
          rg.mat = hp.mat;

          // ---- cotangents ----
          V3 gpos = zero, gn = zero;
          if (alive3) {
            gpos = gop;
            go_out = zero;
            gd_out = zero;
            gT0 = zero;
          }
          if ((flags & FLAG_EMIT) && dot(out, hp.n) > 0.f) {
            gT0 = add(gT0, mul(gA, me.emi));
            rg.e = mul(gA, T0);
          }
          if (alive2) {
            const V3 T1 = v3(T0.x / pc, T0.y / pc, T0.z / pc);
            const float ck = checker(hp.pos.x, hp.pos.z);
            const float sigma = dot(hp.n, out) < 0.f ? -1.0f : 1.0f;
            V3 gT1 = zero;
            if (alive3) {  // throughput' = T1 * albedo * checker
              gT1 = mul(gTp, scale(me.col, ck));
              rg.a = scale(mul(gTp, T1), ck);
            }
            if (flags & FLAG_NEE) {
              const Nee e = nee_geometry<FAM_LAMBERT>(sc, isect, hp, out, ms, seed, lane, ctr);
              if (e.ok) {
                rg.smat = e.s.mat;
                const float pdf = 1.0f / sc.total_area;
                const float q = dot(e.path, e.path);
                const float qg = fmaxf(q, 1e-20f);
                const float g = e.cos_p * e.light_cos / qg;
                const V3 f1 = divs(scale(me.col, ck), LLR_PI);
                const V3 le = load_mat<FAM_LAMBERT>(sc.mats_eval, sc.nm, e.s.mat).emi;
                const float gp = g / pdf;
                const V3 gat1 = mul(gA, T1);
                gT1 = add(gT1, mul(gA, scale(mul(f1, le), gp)));
                rg.a = add(rg.a, scale(mul(gat1, le), gp * ck / LLR_PI));
                rg.en = scale(mul(gat1, f1), gp);
                const float gg = dot(mul(gat1, f1), le) / pdf;
                const float gcos_p = gg * e.light_cos / qg;
                const float glcos = gg * e.cos_p / qg;
                const float gq = q > 1e-20f ? -gg * e.cos_p * e.light_cos / (qg * qg) : 0.f;
                V3 gpath = scale(e.path, 2.0f * gq);
                V3 gwi = scale(e.pn, gcos_p);
                gn = scale(e.wi, gcos_p * sigma);
                gwi = sub(gwi, scale(e.s.n, glcos));
                const V3 gsn = scale(e.wi, -glcos);
                if (e.s.sph) {  // sphere light hit: s_n = normalize(pos + wi s_t - c)
                  const V3 gu = norm_vjp(e.s.n, gsn, norm(sub(e.s.pos, e.s.c)));
                  const float den = dot(e.s.n, e.wi);
                  const float inv_den = fabsf(den) > 1e-12f ? 1.0f / den : 0.f;
                  const V3 ptgu = sub(gu, scale(e.s.n, dot(e.wi, gu) * inv_den));
                  gpos = add(gpos, ptgu);
                  gwi = add(gwi, scale(ptgu, e.s.t));
                }
                // wi = path / max(dist, 1e-20)
                const float wdg = dot(e.wi, gwi);
                gpath = add(gpath, scale(sub(gwi, scale(e.wi, wdg)), 1.0f / fmaxf(e.dist, 1e-20f)));
                gpos = sub(gpos, gpath);  // path = light point - pos
              }
            }
            gT0 = add(gT0, divs(gT1, pc));  // T1 = T0 / prob, prob detached
            if (hp.sph) {
              if (alive3) {  // d' = u cp r2s + v sp r2s + on sqrt(1 - r2), on = sigma n
                const V3 on = orienting(out, hp.n);
                V3 u, v;
                onb(on, u, v);
                const float phi = LLR_TWO_PI * r[1];
                const float cp = cosf(phi), sp = sinf(phi);
                const float r2s = sqrtf(r[2]);
                V3 gon = scale(gdp, sqrtf(1.0f - r[2]));
                V3 gu = scale(gdp, cp * r2s);
                const V3 gv = scale(gdp, sp * r2s);
                gon = add(gon, cross(u, gv));  // v = on x u
                gu = add(gu, cross(gv, on));
                const bool use_y = fabsf(on.x) > LLR_EPS;  // u = normalize(a x on)
                const V3 a = use_y ? v3(0.f, 1.f, 0.f) : v3(1.f, 0.f, 0.f);
                const V3 c = cross(a, on);
                gon = add(gon, cross(norm_vjp(u, gu, norm(c)), a));
                gn = add(gn, scale(gon, sigma));
              }
              // n = normalize(pos - c)
              gpos = add(gpos, norm_vjp(hp.n, gn, norm(sub(hp.pos, hp.c))));
            }
          }
          // pos = o + d t, t by the plane equation at the winner's normal.
          go_out = add(go_out, gpos);
          gd_out = add(gd_out, scale(gpos, hp.t));
          const float gt = dot(gpos, d);
          const float dn = dot(d, hp.n);
          if (fabsf(dn) > 1e-20f) {
            const float ginv = gt / dn;
            go_out = sub(go_out, scale(hp.n, ginv));
            gd_out = sub(gd_out, scale(hp.n, ginv * hp.t));
            if (hp.sph) {
              const float rad = ginv * hp.t * hp.t / fmaxf(norm(sub(hp.pos, hp.c)), 1e-20f);
              gd_out = add(gd_out, scale(d, rad));
            }
          }
        }
      }
      store3(o_bar, i, go_out);
      store3(d_bar, i, gd_out);
      store3(t_bar, i, gT0);
      if (alive_out != nullptr) alive_out[i] = alive3 ? 1 : 0;
    }
    add_warp_rows(rg, mine, sc.nm, lid);
  }

  // The block's warps in warp order, into its column of `partial`.
  __syncthreads();
  for (int j = threadIdx.x; j < width; j += kBlock) {
    float s = tables[j];
    for (int k = 1; k < kWarps; ++k) s += tables[k * width + j];
    partial[(int64_t)j * gridDim.x + blockIdx.x] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish_rows(partial, rows, width, gridDim.x, warp, lid);
  if (threadIdx.x == 0) *ticket = 0u;
}

// A persistent grid: as many blocks as the card holds at once with this
// shared memory, at most one a tile, at most `max_blocks` (the partial
// table's columns).
template <class Isect>
int launch_bwd(const float* o_in, const float* d_in, const float* thr_in, const uint8_t* alive_in,
               const int32_t* lane_in, const float* go_in, const float* gd_in,
               const float* gt_in, const float* ga_in, float* o_bar, float* d_bar, float* t_bar,
               float* rows, float* partial, int max_blocks, unsigned* ticket,
               uint8_t* alive_out, const Scene& sc, const Isect& isect, int n, int bounce,
               int flags, float rr_scale, void* stream) {
  const size_t smem = sizeof(float) * kWarps * (6 * (size_t)sc.nm + 3);
  auto kernel = bounce_bwd_kernel<Isect>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  const int tiles = (int)(((long long)n + kBlock - 1) / kBlock);
  const int grid = std::min(std::min(tiles, std::max(sms * per_sm, 1)), max_blocks);
  if (grid == 0) {  // no lanes: the row table is zero
    return (int)cudaMemsetAsync(rows, 0, smem / kWarps, (cudaStream_t)stream);
  }
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      o_in, d_in, thr_in, alive_in, lane_in, go_in, gd_in, gt_in, ga_in, o_bar, d_bar, t_bar,
      rows, partial, ticket, alive_out, sc, isect, n, tiles, bounce, flags, rr_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// `instance`: INSTANCE_SMALL (prims by value from `small_rows`, the host
// copy of a SmallPrims: nt <= 16, ns <= 8) or not. `partial` holds
// (6*nm + 3) x `max_blocks` floats; `ticket` one zero uint32 (the kernel
// leaves it 0); `args` the launch's step values (bounce_body.cuh ARG_*:
// the seed and the uniform sky colour are read). Returns 1
// (cudaErrorInvalidValue) on an argument outside that.
extern "C" int llr_bounce_bwd(const float* o_in, const float* d_in, const float* thr_in,
                              const uint8_t* alive_in, const int32_t* lane_in,
                              const float* go_in, const float* gd_in, const float* gt_in,
                              const float* ga_in, float* o_bar, float* d_bar, float* t_bar,
                              float* rows, uint8_t* alive_out, const float* tris, int nt,
                              const float* sph, int ns, const float* mats,
                              const float* mats_eval, int nm, const float* lights, int nl,
                              float total_area, int n, int bounce, const uint32_t* args,
                              int flags, float rr_scale, int instance, const float* small_rows,
                              float* partial, int max_blocks, unsigned* ticket, void* stream) {
  const Scene sc{sph, ns, mats, mats_eval, nm, lights, nl, total_area, args, nullptr, 0, 0, false};
  const bool small = (instance & INSTANCE_SMALL) != 0;
  if ((small && (small_rows == nullptr || nt > kSmallTris || ns > kSmallSpheres)) ||
      max_blocks < 1 || args == nullptr || reinterpret_cast<uintptr_t>(args) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (small) {
    SmallIsect isect{};
    std::memcpy(&isect.p, small_rows, sizeof(SmallPrims));
    isect.nt = nt;
    isect.ns = ns;
    return launch_bwd(o_in, d_in, thr_in, alive_in, lane_in, go_in, gd_in, gt_in, ga_in, o_bar,
                      d_bar, t_bar, rows, partial, max_blocks, ticket, alive_out, sc, isect, n,
                      bounce, flags, rr_scale, stream);
  }
  return launch_bwd(o_in, d_in, thr_in, alive_in, lane_in, go_in, gd_in, gt_in, ga_in, o_bar,
                    d_bar, t_bar, rows, partial, max_blocks, ticket, alive_out, sc,
                    BruteIsect{tris, nt, sph, ns}, n, bounce, flags, rr_scale, stream);
}
