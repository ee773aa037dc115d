// The closed-form backward pass of one brute-force bounce on a Lambert-only
// scene under a uniform sky, one thread per lane: from the cotangents of
// the bounce's outputs (o', d', throughput', accum') to those of its inputs
// (o, d, throughput; accum's passes through, since accum is add-only) and
// to the per-row albedo and emission gradients of the evaluation table and
// the sky colour's gradient.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bounce.py::
// _bounce_bwd_kernel (called by make_step_diff). Its plain version is
// ops/bounce_bwd.py::plain_bounce_bwd, followed term for term:
//   * the primal is recomputed with the forward kernel's own code
//     (bounce_body.cuh: BruteIsect, rr_prob, nee_geometry, scatter), so the
//     backward sees the decisions the forward took; `alive_out`, when not
//     null, receives the recomputed alive' for checking that;
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
// Per-row gradients go to a per-block partial table (blocks, 6*nm + 3):
// row r's albedo at 6r..6r+2, its emission at 6r+3..6r+5, the sky colour at
// 6nm..6nm+2. Each block reduces its lanes with warp shuffles and shared
// memory in a fixed order, and the wrapper sums the blocks: no atomics, so
// two runs give the same bits. The TPU kernel's 15-row cap is gone: the
// table is read from global memory and reduced in chunks.
//
// Bound on an H100: memory. A live lane that hits reads o, d, throughput
// (36 B), alive (1 B), its lane id (4 B) and four cotangents (48 B), and
// writes three cotangents (36 B): 125 B; one that misses needs no lane id
// (121 B). A dead lane is the identity on the o, d and throughput
// cotangents: alive and three cotangents in, three out, 73 B. The
// arithmetic, two brute-force passes over the prims and a few hundred flops
// of shading and VJP, stays below the FP32 rate at the flagship's 14
// prims. The design: the state and cotangents are read and written once in
// their own (N,3) rows, and a dead lane reads only what it passes through;
// tables stay in global memory (warp-wide broadcasts).
#include "bounce_body.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 64;  // table entries reduced per shared-memory round

// VJP of n = u / max(|u|, 1e-20) at |u| = len: (g - n (n.g)) / max(len, 1e-20).
__device__ __forceinline__ V3 norm_vjp(V3 n, V3 g, float len) {
  const float ndg = dot(n, g);
  const float inv = 1.0f / fmaxf(len, 1e-20f);
  return scale(sub(g, scale(n, ndg)), inv);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// What one lane adds to the per-row table.
struct RowGrads {
  int mat = -1;   // main hit's row: albedo and emission
  int smat = -1;  // NEE light hit's row: emission through l_e
  V3 a{0.f, 0.f, 0.f}, e{0.f, 0.f, 0.f}, en{0.f, 0.f, 0.f}, sky{0.f, 0.f, 0.f};

  __device__ float entry(int j, int nm) const {
    if (j >= 6 * nm) return comp(sky, j - 6 * nm);
    const int r = j / 6, k = j % 6;
    if (k < 3) return mat == r ? comp(a, k) : 0.f;
    const float v = mat == r ? comp(e, k - 3) : 0.f;
    return v + (smat == r ? comp(en, k - 3) : 0.f);
  }
  __device__ static float comp(V3 v, int c) { return c == 0 ? v.x : (c == 1 ? v.y : v.z); }
};

__global__ void __launch_bounds__(kBlock) bounce_bwd_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const float* __restrict__ thr_in, const uint8_t* __restrict__ alive_in,
    const int32_t* __restrict__ lane_in, const float* __restrict__ go_in,
    const float* __restrict__ gd_in, const float* __restrict__ gt_in,
    const float* __restrict__ ga_in, float* __restrict__ o_bar, float* __restrict__ d_bar,
    float* __restrict__ t_bar, float* __restrict__ partial, uint8_t* __restrict__ alive_out,
    Scene sc, BruteIsect isect, int n, int bounce, uint32_t seed, int flags, float rr_scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
        gT0 = add(gT0, mul(gA, sc.sky));
        rg.sky = mul(gA, T0);
      } else {
        // ---- primal recompute, as the forward kernel runs it ----
        const Mat ms = load_mat(sc.mats, sc.nm, hp.mat);
        const Mat me = load_mat(sc.mats_eval, sc.nm, hp.mat);
        const V3 out = neg(d);
        const uint32_t lane = (uint32_t)lane_in[i];
        const uint32_t ctr = (uint32_t)bounce * 8u;
        float r[4];
        uniform4(seed, lane, ctr, r);
        const float prob = rr_prob(ms, flags, rr_scale);
        const bool alive2 = prob == 1.0f || r[0] < prob;
        const float pc = fmaxf(prob, 1e-12f);
        V3 sd, w;
        alive3 = alive2 && scatter(ms, me, hp, out, r, sd, w);
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
            const Nee e = nee_geometry(sc, isect, hp, out, ms, seed, lane, ctr);
            if (e.ok) {
              rg.smat = e.s.mat;
              const float pdf = 1.0f / sc.total_area;
              const float q = dot(e.path, e.path);
              const float qg = fmaxf(q, 1e-20f);
              const float g = e.cos_p * e.light_cos / qg;
              const V3 f1 = divs(scale(me.col, ck), LLR_PI);
              const V3 le = load_mat(sc.mats_eval, sc.nm, e.s.mat).emi;
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

  // Per-block reduction of the row table, in a fixed order.
  __shared__ float red[kWarps][kChunk];
  const int width = 6 * sc.nm + 3;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  for (int base = 0; base < width; base += kChunk) {
    const int m = min(kChunk, width - base);
    for (int j = 0; j < m; ++j) {
      const float v = warp_sum(rg.entry(base + j, sc.nm));
      if (lid == 0) red[warp][j] = v;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      float s = red[0][j];
      for (int k = 1; k < kWarps; ++k) s += red[k][j];
      partial[(int64_t)blockIdx.x * width + base + j] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int llr_bounce_bwd(const float* o_in, const float* d_in, const float* thr_in,
                              const uint8_t* alive_in, const int32_t* lane_in,
                              const float* go_in, const float* gd_in, const float* gt_in,
                              const float* ga_in, float* o_bar, float* d_bar, float* t_bar,
                              float* partial, uint8_t* alive_out, const float* tris, int nt,
                              const float* sph, int ns, const float* mats,
                              const float* mats_eval, int nm, const float* lights, int nl,
                              float total_area, int n, int bounce, uint32_t seed, int flags,
                              float rr_scale, float sky_r, float sky_g, float sky_b,
                              void* stream) {
  const Scene sc{sph, ns, mats, mats_eval, nm, lights, nl, total_area, V3{sky_r, sky_g, sky_b},
                 nullptr, 0, 0, 0.f};
  const int grid = (n + kBlock - 1) / kBlock;
  if (grid > 0) {
    bounce_bwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        o_in, d_in, thr_in, alive_in, lane_in, go_in, gd_in, gt_in, ga_in, o_bar, d_bar, t_bar,
        partial, alive_out, sc, BruteIsect{tris, nt, sph, ns}, n, bounce, seed, flags, rr_scale);
  }
  return (int)cudaGetLastError();
}
