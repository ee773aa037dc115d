// The body of one bounce per lane, written once for both intersectors:
// nearest hit, sky on miss (uniform, IBL or simple), front-face emission, Russian
// roulette, next-event estimation (CDF light pick, point on light, capped
// shadow ray, no-MIS contribution), BSDF sample/eval/coef for the five
// families, and the throughput / accum / alive update. One thread per lane,
// or a group of G threads per lane (GroupIsect below).
//
// The TPU package shares its body the same way
// (lumillyrender_tpu/ops/pallas_bounce.py::_bounce_body, used by
// _bounce_kernel and _bounce_kernel_bvh). Here the intersector is a template
// argument: `Hit isect(o, d, t_init, t_stop)`, the nearest hit closer than
// t_init; t_stop lets a BVH walk stop early on shadow rays. bounce.cu
// instantiates it with brute force (llr_bounce: SmallIsect, BruteIsect or
// GroupIsect below), bounce_bvh.cu with the sphere pre-pass and the BVH
// walk (llr_bounce_bvh; its warp walk is asked by every lane at once,
// `Isect::kWarpQueries`). The plain version is
// integrator/wavefront.py::plain_bounce_step, followed operation for
// operation.
//
// Specialised to the scene, as the TPU kernel is (its static nt, ns and
// `present`, pallas_bounce.py:786-791, :305-400); each piece is kept only
// where it measured faster than the kernel before it (H100, in turns,
// tools/torch_bounce_ab.py; PERF.md 6.10):
//   * `kFam`, a mask of the material families an instance shades: only
//     their cases are compiled, and a mask of one family (Lambert, the
//     whole differentiable path) compiles that family's code alone, inlined,
//     reading the rows at a per-lane index (the hit's material, the picked
//     light) as 16-byte vectors. The all-family instances keep the code of
//     the kernel before them (the BSDF functions out of line, scalar
//     reads), as kernel 4 does;
//   * SmallIsect carries the triangle and sphere rows by value in the
//     kernel's parameters (the constant bank), swept by a loop unrolled to
//     compile-time caps behind a uniform `i < nt`, so every field is an
//     operand at a fixed constant-bank offset: no load, no address, no
//     loop counter. It serves the narrower launches; at full width
//     BruteIsect's compact loop is faster;
//   * GroupIsect splits the sweep of the narrowest launches over a group of
//     threads per lane.
// The stack frame every instance keeps (32 B) is sinf/cosf's reduction of
// large arguments (IEEE, no fast math).
//
// The sky term is added to accum first, in the plain step's order; the IBL
// lookup runs here (the TPU kernel left it to a host epilogue: Mosaic has
// no per-lane gather).
//
// Two material tables, as the TPU kernel reads them: the sampling table
// drives Russian roulette, the NEE emitter test and BSDF sampling; the
// evaluation table drives emission, the BRDF, coef and NEE's f and l_e. The
// differentiable path passes a detached copy as the first and the live
// parameters as the second; the forward render passes one table twice, and
// launch_bounce then picks the instance that loads each hit's row once.
// The pieces the backward kernel (bounce_bwd.cu) recomputes are functions
// here (the intersectors, rr_prob, light_point, nee_geometry,
// scatter), so both kernels take the same decisions on a lane.
//
// Rounding: built with -fmad=false and IEEE division and sqrt. Tables are
// float32 rows (ids stored as exact floats), 16-byte aligned:
//   tris   (nt, 16): p0 3 | e1 3 | e2 3 | n 3 | mat | pad 3
//   sph    (ns, 8):  c 3 | r | mat | pad 3
//   mats   (nm, 16): type | color 3 | emission 3 | alpha | ior | absorb | pad 6
//   lights (nl, 16): is_tri | p0 3 | e1 3 | e2 3 | c 3 | r | cdf | pad
#pragma once

#include "common.cuh"

enum { MAT_LAMBERT = 0, MAT_PHONG = 1, MAT_BLINN_PHONG = 2, MAT_GGX = 3, MAT_REFRACTION = 4 };

// Family masks (bit 1 << MAT_*) of the compiled instances.
enum { FAM_LAMBERT = 1 << MAT_LAMBERT, FAM_ALL = 0x1f };

enum {
  FLAG_NEE = 1,       // pt-direct with lights: next-event estimation
  FLAG_EMIT = 2,      // this bounce adds front-face emission
  FLAG_RR_FORCE = 4,  // bounce <= depth: positive RR probabilities become 1
};

// What shading, NEE and the sky read; the intersector carries the prims.
struct Scene {
  const float* sph;
  int ns;
  const float* mats;       // sampling table
  const float* mats_eval;  // evaluation table (may be `mats`)
  int nm;
  const float* lights;
  int nl;
  float total_area;
  const uint32_t* args;  // the launch's step values (ARG_*), on the card
  const float* ibl;  // (h*w, 3) equirect texture, or null for the uniform sky
  int ibl_w, ibl_h;
  bool simple;  // the simple sky: meridian and horizon blended by |d.y|
};

// The values of a launch that change from one training step to the next,
// read from the card (ops/cuda_bounce.py::kernel_args) so that a launch
// captured in a CUDA graph takes each replay's: the seed, the sky colour
// (the simple sky's meridian), the simple sky's horizon and the IBL
// longitude offset in radians, as 32-bit words, 16-byte aligned.
enum { ARG_SEED = 0, ARG_SKY = 1, ARG_HORIZON = 4, ARG_LON = 7, ARG_WORDS = 8 };

__device__ __forceinline__ float arg_f(const uint32_t* args, int k) {
  return __uint_as_float(__ldg(args + k));
}

__device__ __forceinline__ V3 arg_v3(const uint32_t* args, int k) {
  return v3(arg_f(args, k), arg_f(args, k + 1), arg_f(args, k + 2));
}

struct Hit {
  float t;
  bool hit;
  bool sph;  // a sphere won (its normal then depends on the position)
  int mat;
  V3 pos, n;
  V3 c;  // the winning sphere's center
};

// The hit of ops/intersect.py::_finish: position, the outward normal (the
// triangle's face normal, or from the sphere's center), the material row.
__device__ __forceinline__ Hit make_hit(V3 o, V3 d, float best_t, bool hit, bool tri, int best_m,
                                        V3 best_f) {
  Hit h;
  h.t = best_t;
  h.hit = hit;
  h.sph = hit && !tri;
  h.mat = h.hit ? best_m : -1;
  h.pos = add(o, scale(d, best_t));
  h.c = best_f;
  if (!h.hit) {
    h.n = v3(0.f, 0.f, 1.f);
  } else if (tri) {
    h.n = best_f;
  } else {
    h.n = safe_normalize(sub(h.pos, best_f));
  }
  return h;
}

// Spheres ascending from the running best, strict <: kind becomes 2 and
// best_f the center when one wins.
__device__ __forceinline__ void fold_spheres(const float* sph, int ns, V3 o, V3 d, float& best_t,
                                             int& kind, int& best_m, V3& best_f) {
  for (int i = 0; i < ns; ++i) {
    const float* r = sph + 8 * i;
    const V3 c = v3(r[0], r[1], r[2]);
    float t;
    if (sphere_test(o, d, c, r[3], t) && t < best_t) {
      best_t = t;
      kind = 2;
      best_m = (int)r[4];
      best_f = c;
    }
  }
}

// One triangle row (p0, e1, e2, n, mat in four float4: a | b | c | e) and
// one sphere row (c, r | mat) folded into the running best, strict <.
__device__ __forceinline__ void fold_tri(float4 a, float4 b, float4 c, float mat, V3 o, V3 d,
                                         float& best_t, int& kind, int& best_m, V3& best_f) {
  float t;
  if (tri_test(o, d, v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), v3(b.z, b.w, c.x), t) &&
      t < best_t) {
    best_t = t;
    kind = 1;
    best_m = (int)mat;
    best_f = v3(c.y, c.z, c.w);
  }
}

__device__ __forceinline__ void fold_sph(float4 a, float mat, V3 o, V3 d, float& best_t,
                                         int& kind, int& best_m, V3& best_f) {
  const V3 c = v3(a.x, a.y, a.z);
  float t;
  if (sphere_test(o, d, c, a.w, t) && t < best_t) {
    best_t = t;
    kind = 2;
    best_m = (int)mat;
    best_f = c;
  }
}

// Brute force, the general instance: the nearest hit with t < t_init,
// triangles ascending, then spheres ascending, strict < (the first of
// equal candidates wins; a triangle wins a tie). A compact loop over the
// rows in global memory (every lane of a warp reads the same row: one
// broadcast through L1), any table size. At 1M and 2M lanes it beat the
// unrolled sweep below by 7-12% with the same shading, though that one
// reads no rows and holds fewer registers (63 against 72); why is not
// measured (ncu does not run on the card's machine).
struct BruteIsect {
  const float* tris;
  int nt;
  const float* sph;
  int ns;
  static constexpr bool kWarpQueries = false;  // queries asked inside the lanes' branches
  static constexpr int kLog2Group = 0;         // one thread per lane

  __device__ Hit operator()(V3 o, V3 d, float t_init, float /*t_stop*/) const {
    float best_t = t_init;
    int kind = 0, best_m = -1;  // kind: 0 miss, 1 triangle, 2 sphere
    V3 best_f = v3(0.f, 0.f, 0.f);
    for (int i = 0; i < nt; ++i) {
      const float* r = tris + 16 * i;
      float t;
      if (tri_test(o, d, v3(r[0], r[1], r[2]), v3(r[3], r[4], r[5]), v3(r[6], r[7], r[8]), t) &&
          t < best_t) {
        best_t = t;
        kind = 1;
        best_m = (int)r[12];
        best_f = v3(r[9], r[10], r[11]);
      }
    }
    fold_spheres(sph, ns, o, d, best_t, kind, best_m, best_f);
    return make_hit(o, d, best_t, kind != 0, kind == 1, best_m, best_f);
  }
};

// Brute force on a small scene (nt <= kSmallTris, ns <= kSmallSpheres) at
// the narrower stages: the rows by value in the kernel's parameters,
// 16 * 64 + 8 * 32 = 1,280 B of the constant bank; the same sweep,
// unrolled, each field an operand at a fixed constant-bank offset.
constexpr int kSmallTris = 16;
constexpr int kSmallSpheres = 8;

struct SmallPrims {
  float4 tri[kSmallTris][4];    // the tris rows
  float4 sph[kSmallSpheres][2];  // the sph rows
};

struct SmallIsect {
  SmallPrims p;
  int nt;
  int ns;
  static constexpr bool kWarpQueries = false;
  static constexpr int kLog2Group = 0;

  __device__ __forceinline__ Hit operator()(V3 o, V3 d, float t_init, float /*t_stop*/) const {
    float best_t = t_init;
    int kind = 0, best_m = -1;
    V3 best_f = v3(0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kSmallTris; ++i) {
      if (i >= nt) break;
      fold_tri(p.tri[i][0], p.tri[i][1], p.tri[i][2], p.tri[i][3].x, o, d, best_t, kind, best_m,
               best_f);
    }
#pragma unroll
    for (int i = 0; i < kSmallSpheres; ++i) {
      if (i >= ns) break;
      fold_sph(p.sph[i][0], p.sph[i][1].x, o, d, best_t, kind, best_m, best_f);
    }
    return make_hit(o, d, best_t, kind != 0, kind == 1, best_m, best_f);
  }
};

// Brute force split over a group of 2^log2g threads per lane, for the
// narrow stages whose one-thread-per-lane grid fills under one wave: the
// thread of rank g in its group tests triangles g, g + G, ... then spheres
// g, g + G, ... (ascending, strict <, from global memory), and the group
// keeps the lexicographic minimum of (t, prim index), triangles before
// spheres: the first index among equal t, the winner of BruteIsect's
// ascending strict-< sweep. Every thread of the group runs the lane's body
// (the same operations, so the same values) and the first stores it; the
// queries are asked outside the lanes' branches (`kWarpQueries`) so that
// the whole group calls them.
struct GroupIsect {
  const float* tris;
  int nt;
  const float* sph;
  int ns;
  int log2g;  // 1..4
  static constexpr bool kWarpQueries = true;
  static constexpr int kLog2Group = -1;  // from log2g

  __device__ __forceinline__ Hit operator()(bool ask, V3 o, V3 d, float t_init,
                                            float /*t_stop*/) const {
    const int g = 1 << log2g;
    const int lane = threadIdx.x & 31;
    const int rank = lane & (g - 1);
    const unsigned mask = ((1u << g) - 1u) << (lane - rank);
    float best_t = t_init;
    int kind = 0, best_m = -1;
    V3 best_f = v3(0.f, 0.f, 0.f);
    int best_i = -1;
    if (ask) {
      const float4* T = reinterpret_cast<const float4*>(tris);
      for (int i = rank; i < nt; i += g) {
        const float bt = best_t;
        fold_tri(__ldg(T + 4 * i), __ldg(T + 4 * i + 1), __ldg(T + 4 * i + 2),
                 __ldg(tris + 16 * i + 12), o, d, best_t, kind, best_m, best_f);
        if (best_t != bt) best_i = i;
      }
      const float4* S = reinterpret_cast<const float4*>(sph);
      for (int i = rank; i < ns; i += g) {
        const float bt = best_t;
        fold_sph(__ldg(S + 2 * i), __ldg(sph + 8 * i + 4), o, d, best_t, kind, best_m, best_f);
        if (best_t != bt) best_i = nt + i;
      }
    }
    // (t, index) as one 64-bit key: a hit's t >= EPS > 0 orders as its
    // bits; no hit sorts last.
    unsigned long long key = best_i >= 0
        ? ((unsigned long long)__float_as_uint(best_t) << 32) | (unsigned)best_i
        : ~0ull;
    for (int off = 1; off < g; off <<= 1) {
      const unsigned long long other = __shfl_xor_sync(mask, key, off);
      key = other < key ? other : key;
    }
    if (key == ~0ull) return make_hit(o, d, t_init, false, false, -1, v3(0.f, 0.f, 0.f));
    const unsigned win = __ballot_sync(mask, best_i == (int)(unsigned)key);
    const int src = __ffs(win) - 1;
    best_m = __shfl_sync(mask, best_m, src);
    best_f = v3(__shfl_sync(mask, best_f.x, src), __shfl_sync(mask, best_f.y, src),
                __shfl_sync(mask, best_f.z, src));
    return make_hit(o, d, __uint_as_float((unsigned)(key >> 32)), true, (int)(unsigned)key < nt,
                    best_m, best_f);
  }
};

// Equirect sky lookup, ops/sky.py::ibl_texel: y-up, nearest texel, u offset
// by the longitude in radians, IEEE divisions (the plain lookup divides by
// tensors for the same rounding), torch.remainder's floor-mod (not fmodf's
// sign) and the int64 wrap of y*w + x over the flattened image.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

// The simple sky, ops/sky.py::simple_radiance in its order of operations:
// meridian * w + horizon * (1 - w), w = |d.y|.
__device__ __forceinline__ V3 sky_radiance(const Scene& sc, V3 d) {
  if (sc.simple) {
    const float w = fabsf(d.y);
    return add(scale(arg_v3(sc.args, ARG_SKY), w),
               scale(arg_v3(sc.args, ARG_HORIZON), 1.0f - w));
  }
  if (sc.ibl == nullptr) return arg_v3(sc.args, ARG_SKY);
  const float theta = acosf(fminf(fmaxf(d.y, -1.0f), 1.0f));
  const float phi = atan2f(d.z, d.x);
  const float u = floor_mod((phi + LLR_PI + arg_f(sc.args, ARG_LON)) / LLR_TWO_PI, 1.0f);
  const float v = floor_mod(theta / LLR_PI, 1.0f);
  const long long w = sc.ibl_w, h = sc.ibl_h;
  const long long x = (long long)floorf((float)sc.ibl_w * u);
  const long long y = (long long)floorf((float)sc.ibl_h * v);
  long long idx = (y * w + x) % (w * h);
  if (idx < 0) idx += w * h;
  return load3(sc.ibl, idx);
}

struct Mat {
  int type;
  V3 col, emi;
  float alpha, ior, absorb;
};

// Row `row` (clamped) of a material table of `nm` rows: as three float4s
// for a pruned instance (the loads of fields it does not read are dead),
// as scalars for the all-family instances and kernel 4, whose registers
// the vectors raised (PERF.md 6.10).
template <int kFam = FAM_ALL>
__device__ __forceinline__ Mat load_mat(const float* table, int nm, int row) {
  row = min(max(row, 0), nm - 1);
  Mat m;
  if constexpr (kFam == FAM_ALL) {
    const float* r = table + 16 * row;
    m.type = (int)r[0];
    m.col = v3(r[1], r[2], r[3]);
    m.emi = v3(r[4], r[5], r[6]);
    m.alpha = r[7];
    m.ior = r[8];
    m.absorb = r[9];
  } else {
    const float4* r = reinterpret_cast<const float4*>(table) + 4 * row;
    const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
    m.type = (int)a.x;
    m.col = v3(a.y, a.z, a.w);
    m.emi = v3(b.x, b.y, b.z);
    m.alpha = b.w;
    m.ior = c.x;
    m.absorb = c.y;
  }
  return m;
}

// The family a row of an instance of mask kFam shades: the row's own, or,
// where the mask holds one family, that family as a constant, so that the
// switches below fold to its case.
template <int kFam>
__device__ __forceinline__ int family(const Mat& m) {
  constexpr bool one = (kFam & (kFam - 1)) == 0;
  constexpr int only = (kFam & 1) ? 0 : (kFam & 2) ? 1 : (kFam & 4) ? 2 : (kFam & 8) ? 3 : 4;
  return one ? only : m.type;
}

__device__ __forceinline__ V3 orienting(V3 out, V3 n) { return dot(n, out) < 0.f ? neg(n) : n; }

__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return add(neg(v), scale(n, 2.0f * dot(v, n))); }

__device__ __forceinline__ void onb(V3 w, V3& t, V3& b) {
  const bool use_y = fabsf(w.x) > LLR_EPS;
  const V3 a = use_y ? v3(0.f, 1.f, 0.f) : v3(1.f, 0.f, 0.f);
  t = safe_normalize(cross(a, w));
  b = cross(w, t);
}

__device__ __forceinline__ float signed_mod(float b, float m) {
  return b > 0.f ? fmodf(b, m) : m - fmodf(-b, m);
}

// Out of line: one copy for both of a lane's BRDF evaluations, 1-2%
// faster than inlined at most widths (PERF.md 6.10).
__device__ __noinline__ float checker(float u, float v) {
  const float lu = signed_mod(u, 150.f), lv = signed_mod(v, 150.f);
  const float su = signed_mod(u, 30.f), sv = signed_mod(v, 30.f);
  const float cu = signed_mod(u, 300.f), cv = signed_mod(v, 300.f);
  const bool big_line = lu < 2.f || lv < 2.f;
  const bool small_line = su < 1.f || sv < 1.f;
  const bool cell = (cu < 150.f || cv < 150.f) && !(cu < 150.f && cv < 150.f);
  float out = cell ? 0.8f : 1.0f;
  if (small_line) out = 0.6f;
  if (big_line) out = 0.5f;
  return out;
}

__device__ __forceinline__ float pow_clamped(float base, float e) {
  return base > 0.f ? powf(fmaxf(base, 1e-30f), e) : 0.f;
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ float ggx_g1(V3 v, V3 n, float a2) {
  const float c = dot(v, n);
  const float tan2 = 1.0f / fmaxf(c * c, 1e-20f) - 1.0f;
  return 2.0f / (1.0f + sqrtf(1.0f + a2 * a2 * tan2 * tan2));
}

__device__ __forceinline__ float ggx_ndf(V3 m, V3 n, float a2) {
  const float mdn = dot(m, n);
  float x = (a2 * a2 - 1.0f) * mdn * mdn + 1.0f;
  x = x != 0.f ? x : 1.0f;
  return a2 * a2 / (LLR_PI * x * x);
}

__device__ __forceinline__ float schlick_f0(float ior) {
  const float nnn = 1.0f - ior, nnp = 1.0f + ior;
  return (nnn * nnn) / (nnp * nnp);
}

__device__ __forceinline__ float fresnel_exact(float n1, float n2, V3 out, V3 in, V3 on) {
  const float cos1 = dot(out, on);
  const float cos2 = dot(in, neg(on));
  const float rs0 = (n1 * cos1 - n2 * cos2) / (n1 * cos1 + n2 * cos2);
  const float rp0 = (n1 * cos2 - n2 * cos1) / (n1 * cos2 + n2 * cos1);
  return (rs0 * rs0 + rp0 * rp0) / 2.0f;
}

// Snell refraction; `valid` false on total internal reflection.
__device__ __forceinline__ V3 refract(V3 v, V3 n, float eta, bool& valid) {
  const float dn = dot(v, n);
  const float cos2 = 1.0f - (eta * eta) * (1.0f - dn * dn);
  valid = cos2 > 0.f;
  const float safe = sqrtf(valid ? cos2 : 1.0f);
  return sub(scale(neg(v), eta), scale(n, eta * -dn + safe));
}

// f(out, in); `n` is the geometric normal, oriented here.
template <int kFam>
__device__ __forceinline__ V3 eval_brdf_body(const Mat& m, V3 out, V3 in, V3 n, V3 pos) {
  const V3 on = orienting(out, n);
  const float i_dot_on = dot(in, on);
  const bool front = i_dot_on > 0.f;
  const V3 zero = v3(0.f, 0.f, 0.f);
  switch (family<kFam>(m)) {
    case MAT_LAMBERT:
      if constexpr ((kFam >> MAT_LAMBERT) & 1) {
        return divs(scale(m.col, checker(pos.x, pos.z)), LLR_PI);
      }
      break;
    case MAT_PHONG:
      if constexpr ((kFam >> MAT_PHONG) & 1) {
        const V3 r = reflect(out, on);
        const float s = (m.alpha + 2.0f) / LLR_TWO_PI * pow_clamped(dot(r, in), m.alpha);
        return front ? scale(m.col, s) : zero;
      }
      break;
    case MAT_BLINN_PHONG:
      if constexpr ((kFam >> MAT_BLINN_PHONG) & 1) {
        const V3 h = safe_normalize(add(in, out));
        const float a = m.alpha;
        const float s = (a + 2.0f) * (a + 4.0f) / (LLR_EIGHT_PI * (exp2f(-a / 2.0f) + a)) *
                        pow_clamped(dot(h, on), a);
        return front ? scale(m.col, s) : zero;
      }
      break;
    case MAT_GGX:
      if constexpr ((kFam >> MAT_GGX) & 1) {
        const V3 h = safe_normalize(add(in, out));
        const float a2 = m.alpha * m.alpha;
        const float fr_s =
            schlick_f0(m.ior) + (1.0f - schlick_f0(m.ior)) * pow5(1.0f - dot(in, h));
        const float g = ggx_g1(in, on, a2) * ggx_g1(out, on, a2);
        const float d_ndf = ggx_ndf(h, on, a2);
        const float denom = 4.0f * i_dot_on * dot(out, on);
        const float s = fr_s * g * d_ndf / (denom != 0.f ? denom : 1.0f);
        return front ? scale(m.col, s) : zero;
      }
      break;
    case MAT_REFRACTION:
      if constexpr ((kFam >> MAT_REFRACTION) & 1) {
        const bool entering = dot(out, n) > 0.f;
        const float from_ior = entering ? 1.0f : m.ior;
        const float to_ior = entering ? m.ior : 1.0f;
        bool valid;
        const V3 refr = refract(out, on, from_ior / to_ior, valid);
        const float fr = fresnel_exact(from_ior, to_ior, out, refr, on);
        const float i_dot_n = dot(in, n);
        const float inv_idn = 1.0f / (i_dot_n != 0.f ? i_dot_n : 1.0f);
        const float q = to_ior / from_ior;
        const float ft = (1.0f - fr) * (q * q);
        const float w_refl = i_dot_on > 0.f ? fr : ft;
        return scale(scale(m.col, valid ? w_refl : 1.0f), inv_idn);
      }
      break;
  }
  return zero;
}

// Importance-sample the lane's BSDF -> direction, pdf.
template <int kFam>
__device__ __forceinline__ V3 sample_bsdf_body(const Mat& m, V3 out, V3 n, float r1, float r2,
                                          float r3, float& pdf) {
  const V3 on = orienting(out, n);
  const float phi = LLR_TWO_PI * r1;
  const float cp = cosf(phi), sp = sinf(phi);
  switch (family<kFam>(m)) {
    case MAT_LAMBERT:
      if constexpr ((kFam >> MAT_LAMBERT) & 1) {
        V3 u, v;
        onb(on, u, v);
        const float r2s = sqrtf(r2);
        const V3 d =
            add(add(scale(u, cp * r2s), scale(v, sp * r2s)), scale(on, sqrtf(1.0f - r2)));
        pdf = dot(d, n) / LLR_PI;
        return d;
      }
      break;
    case MAT_PHONG:
      if constexpr ((kFam >> MAT_PHONG) & 1) {
        const float a = m.alpha;
        const V3 r = reflect(out, on);
        V3 ur, vr;
        onb(r, ur, vr);
        const float t = powf(r2, 1.0f / (a + 2.0f));
        const float ts = sqrtf(fmaxf(1.0f - t * t, 0.f));
        const V3 d = add(add(scale(ur, cp * ts), scale(vr, sp * ts)), scale(r, t));
        pdf = (a + 2.0f) / LLR_TWO_PI * pow_clamped(dot(r, d), a);
        return d;
      }
      break;
    case MAT_BLINN_PHONG:
      if constexpr ((kFam >> MAT_BLINN_PHONG) & 1) {
        const float a = m.alpha;
        V3 u, v;
        onb(on, u, v);
        const float t = powf(r2, 1.0f / (a + 2.0f));
        const float ts = sqrtf(fmaxf(1.0f - t * t, 0.f));
        const V3 h = add(add(scale(u, cp * ts), scale(v, sp * ts)), scale(on, t));
        const V3 d = sub(scale(h, 2.0f * dot(out, h)), out);
        pdf = (a + 2.0f) / LLR_TWO_PI * pow_clamped(dot(on, h), a);
        return d;
      }
      break;
    case MAT_GGX:
      if constexpr ((kFam >> MAT_GGX) & 1) {
        const float a2 = m.alpha * m.alpha;
        V3 u, v;
        onb(on, u, v);
        const float tn = a2 * sqrtf(r2 / fmaxf(1.0f - r2, 1e-12f));
        const float x = 1.0f + tn * tn;
        const float cos_g = 1.0f / sqrtf(x);
        const float sin_g = tn / sqrtf(x);
        const V3 h = add(add(scale(u, cp * sin_g), scale(v, sp * sin_g)), scale(on, cos_g));
        const float o_h = dot(out, h);
        const V3 d = sub(scale(h, 2.0f * o_h), out);
        pdf = ggx_ndf(h, on, a2) * dot(h, on) / (4.0f * (o_h != 0.f ? o_h : 1.0f));
        return d;
      }
      break;
    case MAT_REFRACTION:
      if constexpr ((kFam >> MAT_REFRACTION) & 1) {
        const bool entering = dot(out, n) > 0.f;
        const float from_ior = entering ? 1.0f : m.ior;
        const float to_ior = entering ? m.ior : 1.0f;
        bool valid;
        const V3 refr = refract(out, on, from_ior / to_ior, valid);
        const float fr = fresnel_exact(from_ior, to_ior, out, refr, on);
        const V3 refl = reflect(out, on);
        const bool choose_refl = r3 < fr;
        pdf = valid ? (choose_refl ? fr : 1.0f - fr) : 1.0f;
        return valid ? (choose_refl ? refl : refr) : refl;
      }
      break;
  }
  pdf = 0.f;
  return v3(0.f, 0.f, 0.f);
}

// The all-family instances (and kernel 4) keep the two BSDF functions as
// the compiler's own functions, as before the pruned instances: inlined
// into both call sites they raised its registers (PERF.md 6.10). A pruned
// instance inlines its families' code.
__device__ V3 eval_brdf_all(const Mat& m, V3 out, V3 in, V3 n, V3 pos) {
  return eval_brdf_body<FAM_ALL>(m, out, in, n, pos);
}

__device__ V3 sample_bsdf_all(const Mat& m, V3 out, V3 n, float r1, float r2, float r3,
                              float& pdf) {
  return sample_bsdf_body<FAM_ALL>(m, out, n, r1, r2, r3, pdf);
}

template <int kFam>
__device__ __forceinline__ V3 eval_brdf(const Mat& m, V3 out, V3 in, V3 n, V3 pos) {
  if constexpr (kFam == FAM_ALL) {
    return eval_brdf_all(m, out, in, n, pos);
  } else {
    return eval_brdf_body<kFam>(m, out, in, n, pos);
  }
}

template <int kFam>
__device__ __forceinline__ V3 sample_bsdf(const Mat& m, V3 out, V3 n, float r1, float r2,
                                          float r3, float& pdf) {
  if constexpr (kFam == FAM_ALL) {
    return sample_bsdf_all(m, out, n, r1, r2, r3, pdf);
  } else {
    return sample_bsdf_body<kFam>(m, out, n, r1, r2, r3, pdf);
  }
}

// Beer-Lambert absorption when exiting a refractive medium; 1 otherwise.
template <int kFam>
__device__ __forceinline__ V3 coef(const Mat& m, V3 out, V3 n, float dist) {
  if constexpr (!((kFam >> MAT_REFRACTION) & 1)) {
    return v3(1.f, 1.f, 1.f);
  } else {
    if (family<kFam>(m) != MAT_REFRACTION || !(dot(out, n) < 0.f)) return v3(1.f, 1.f, 1.f);
    const float ad = m.absorb * dist;
    return v3(expf(-(1.0f - m.col.x) * ad), expf(-(1.0f - m.col.y) * ad),
              expf(-(1.0f - m.col.z) * ad));
  }
}

// Russian-roulette probability (`scene.rs:64-76`) from the sampling row:
// max albedo, halved per bounce past depth_limit (`rr_scale`), forced to 1
// while bounce <= depth when positive.
__device__ __forceinline__ float rr_prob(const Mat& ms, int flags, float rr_scale) {
  float prob = fmaxf(fmaxf(ms.col.x, ms.col.y), ms.col.z) * rr_scale;
  if ((flags & FLAG_RR_FORCE) && prob > 0.f) prob = 1.0f;
  return prob;
}

// NEE's point on a light (`objects.rs:37-51`): area-proportional pick, the
// first CDF entry >= roulette (searchsorted left), then a uniform point on
// the picked triangle or sphere, its row read as float4s in a pruned
// instance and as scalars otherwise (as load_mat). Draws slot ctr + 1.
template <int kFam = FAM_ALL>
__device__ __forceinline__ V3 light_point(const Scene& sc, uint32_t seed, uint32_t lane,
                                          uint32_t ctr) {
  float r[4];
  uniform4(seed, lane, ctr + 1u, r);
  const float u1 = r[1], u2 = r[2];
  const float roulette = sc.total_area * r[0];
  int lo = 0, hi = sc.nl;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sc.lights[16 * mid + 14] < roulette) lo = mid + 1; else hi = mid;
  }
  if constexpr (kFam == FAM_ALL) {
    const float* L = sc.lights + 16 * min(lo, sc.nl - 1);
    if (L[0] > 0.f) {  // triangle: min/max trick (`triangle.rs:140-149`)
      const V3 p0 = v3(L[1], L[2], L[3]), e1 = v3(L[4], L[5], L[6]), e2 = v3(L[7], L[8], L[9]);
      const float mn = fminf(u1, u2), mx = fmaxf(u1, u2);
      return add(add(scale(p0, mn), scale(add(p0, e1), 1.0f - mx)), scale(add(p0, e2), mx - mn));
    }
    // sphere: uniform over the full sphere (quirk #10)
    const float phi = LLR_TWO_PI * u1;
    const float z = u2 * 2.0f - 1.0f;
    const float zs = sqrtf(fmaxf(1.0f - z * z, 0.f));
    return add(v3(L[10], L[11], L[12]), scale(v3(cosf(phi) * zs, sinf(phi) * zs, z), L[13]));
  } else {
    const float4* L = reinterpret_cast<const float4*>(sc.lights) + 4 * min(lo, sc.nl - 1);
    const float4 a = __ldg(L);  // is_tri | p0
    if (a.x > 0.f) {
      const float4 b = __ldg(L + 1), c = __ldg(L + 2);  // e1 | e2.x, e2.yz | c.xy
      const V3 p0 = v3(a.y, a.z, a.w), e1 = v3(b.x, b.y, b.z), e2 = v3(b.w, c.x, c.y);
      const float mn = fminf(u1, u2), mx = fmaxf(u1, u2);
      return add(add(scale(p0, mn), scale(add(p0, e1), 1.0f - mx)), scale(add(p0, e2), mx - mn));
    }
    const float4 c = __ldg(L + 2), e = __ldg(L + 3);  // c.xy at c.zw, c.z | r at e.xy
    const float phi = LLR_TWO_PI * u1;
    const float z = u2 * 2.0f - 1.0f;
    const float zs = sqrtf(fmaxf(1.0f - z * z, 0.f));
    return add(v3(c.z, c.w, e.x), scale(v3(cosf(phi) * zs, sinf(phi) * zs, z), e.y));
  }
}

// NEE's geometry (`scene.rs:104-151`): the light point, the oriented
// normal, the capped shadow query and its verdict. `ok` says whether the
// lane gathers light.
struct Nee {
  V3 path, wi, pn;
  float dist, cos_p, light_cos;
  Hit s;  // the shadow query's hit (read only when ok)
  bool ok;
};

template <int kFam, class Isect>
__device__ __forceinline__ Nee nee_geometry(const Scene& sc, const Isect& isect, const Hit& sp,
                                            V3 out, const Mat& ms, uint32_t seed, uint32_t lane,
                                            uint32_t ctr) {
  Nee e{};
  e.path = sub(light_point<kFam>(sc, seed, lane, ctr), sp.pos);
  e.dist = norm(e.path);
  e.wi = divs(e.path, fmaxf(e.dist, 1e-20f));
  e.pn = orienting(out, sp.n);
  e.cos_p = dot(e.wi, e.pn);
  // No NEE from emitters (`scene.rs:105-108`), by the sampling row.
  if (!(e.cos_p > 0.f) || !(dot(ms.emi, ms.emi) <= 0.f)) return e;
  // Shadow ray capped at dist + 2*EPS; visible iff the hit is the light
  // point itself (|t - dist| <= EPS). A walk may stop at any hit below
  // cap - 4*EPS: that hit already settles the verdict as occluded.
  const float cap = e.dist + 0.002f;
  e.s = isect(sp.pos, e.wi, cap, cap - 0.004f);
  if (!(e.s.hit && fabsf(e.s.t - e.dist) <= LLR_EPS)) return e;
  e.light_cos = dot(neg(e.wi), e.s.n);
  e.ok = e.light_cos > 0.f;
  return e;
}

// NEE contribution of one lane: f from the evaluation row `me`, l_e from
// the evaluation table's row of the light hit.
template <int kFam, class Isect>
__device__ __forceinline__ V3 direct_light(const Scene& sc, const Isect& isect, const Hit& sp,
                                           V3 out, const Mat& ms, const Mat& me, uint32_t seed,
                                           uint32_t lane, uint32_t ctr) {
  const Nee e = nee_geometry<kFam>(sc, isect, sp, out, ms, seed, lane, ctr);
  if (!e.ok) return v3(0.f, 0.f, 0.f);
  const float pdf = 1.0f / sc.total_area;
  const float g = e.cos_p * e.light_cos / fmaxf(dot(e.path, e.path), 1e-20f);
  const V3 f = eval_brdf<kFam>(me, out, e.wi, e.pn, sp.pos);
  const V3 le = load_mat<kFam>(sc.mats_eval, sc.nm, e.s.mat).emi;
  return scale(mul(f, le), g / pdf);
}

// NEE where the queries are asked outside the lanes' branches
// (`Isect::kWarpQueries`): nee_geometry and direct_light cut at the shadow
// query, with the same operations. `nee_setup` fills the geometry and
// returns whether the lane asks the query (from sp.pos along wi, t_init
// e.dist + 0.002f); `nee_verdict` takes its hit; `nee_light` gives the
// contribution. The per-thread instances keep nee_geometry and
// direct_light whole: built from these helpers instead, their code
// changed (kernel 4's per-thread instances 116 / 113 registers against
// 117 / 114) and kernels 2 and 4 ran 1.1-1.5% slower at full width (H100,
// tools/torch_bounce_ab.py in turns, ranges disjoint).
template <int kFam>
__device__ __forceinline__ bool nee_setup(const Scene& sc, const Hit& sp, V3 out, const Mat& ms,
                                          uint32_t seed, uint32_t lane, uint32_t ctr, Nee& e) {
  e.path = sub(light_point<kFam>(sc, seed, lane, ctr), sp.pos);
  e.dist = norm(e.path);
  e.wi = divs(e.path, fmaxf(e.dist, 1e-20f));
  e.pn = orienting(out, sp.n);
  e.cos_p = dot(e.wi, e.pn);
  return e.cos_p > 0.f && dot(ms.emi, ms.emi) <= 0.f;
}

__device__ __forceinline__ void nee_verdict(Nee& e, const Hit& s) {
  e.s = s;
  if (!(e.s.hit && fabsf(e.s.t - e.dist) <= LLR_EPS)) return;
  e.light_cos = dot(neg(e.wi), e.s.n);
  e.ok = e.light_cos > 0.f;
}

template <int kFam>
__device__ __forceinline__ V3 nee_light(const Scene& sc, const Nee& e, const Hit& sp, V3 out,
                                        const Mat& me) {
  if (!e.ok) return v3(0.f, 0.f, 0.f);
  const float pdf = 1.0f / sc.total_area;
  const float g = e.cos_p * e.light_cos / fmaxf(dot(e.path, e.path), 1e-20f);
  const V3 f = eval_brdf<kFam>(me, out, e.wi, e.pn, sp.pos);
  const V3 le = load_mat<kFam>(sc.mats_eval, sc.nm, e.s.mat).emi;
  return scale(mul(f, le), g / pdf);
}

// BSDF sampling and the throughput weight (`scene.rs:78-102`): direction
// `sd` sampled from the sampling row with r[1..3], w = f * coef * cos / pdf
// from the evaluation row. False where the lane dies (w == 0 or pdf == 0).
template <int kFam>
__device__ __forceinline__ bool scatter(const Mat& ms, const Mat& me, const Hit& hp, V3 out,
                                        const float r[4], V3& sd, V3& w) {
  float pdf;
  sd = sample_bsdf<kFam>(ms, out, hp.n, r[1], r[2], r[3], pdf);
  const V3 f = eval_brdf<kFam>(me, out, sd, hp.n, hp.pos);
  const V3 cf = coef<kFam>(me, out, hp.n, hp.t);
  const float ws = dot(sd, hp.n) / (pdf != 0.f ? pdf : 1.0f);
  w = scale(mul(f, cf), ws);
  return (w.x != 0.f || w.y != 0.f || w.z != 0.f) && pdf != 0.f;
}

// The lane of this thread: one thread per lane, or the groups of
// GroupIsect (`lead`: the thread that stores the lane's outputs).
template <class Isect>
__device__ __forceinline__ int lane_index(const Isect& isect, bool& lead) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (Isect::kLog2Group >= 0) {
    lead = true;
    return t >> Isect::kLog2Group;
  } else {
    lead = (t & ((1 << isect.log2g) - 1)) == 0;
    return t >> isect.log2g;
  }
}

// One bounce per lane; `isect(o, d, t_init, t_stop)` is the intersector,
// asked inside the branch that needs it. Where `Isect::kWarpQueries` (the
// BVH bounce's warp walk, bvh_warp_walk.cuh, and GroupIsect), both queries,
// the primary ray and the NEE shadow ray, are asked instead at points
// outside the lanes' branches by every lane still running, as `isect(ask,
// o, d, t_init, t_stop)` with `ask` false where a lane has nothing to ask,
// so that the warp (or group) has all its threads to test a leaf (or the
// prims); the locals that cross those points live outside the branches in
// that body only. Both bodies make the same operations on every lane.
// `kSplit`: the two material tables differ; without it (the forward
// render's one table passed twice) a hit's row is loaded once. `kFam`: the
// families shaded.
template <class Isect, bool kSplit, int kFam>
__global__ void __launch_bounds__(128) bounce_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const float* __restrict__ thr_in, const float* __restrict__ acc_in,
    const uint8_t* __restrict__ alive_in, const int32_t* __restrict__ lane_in,
    float* __restrict__ o_out, float* __restrict__ d_out, float* __restrict__ thr_out,
    float* __restrict__ acc_out, uint8_t* __restrict__ alive_out, float* __restrict__ rays_out,
    Scene sc, Isect isect, int n, int bounce, int flags, float rr_scale) {
  bool lead;
  const int i = lane_index(isect, lead);
  if (i >= n) return;
  const V3 o = load3(o_in, i), d = load3(d_in, i), thr = load3(thr_in, i);
  V3 acc = load3(acc_in, i);
  const bool alive_entry = alive_in[i] != 0;
  float rays = alive_entry ? 1.0f : 0.0f;
  bool alive = false;
  V3 new_o = o, new_d = d, new_thr = thr;

  if constexpr (!Isect::kWarpQueries) {
    if (alive_entry) {
      const Hit hp = isect(o, d, LLR_INF, -LLR_INF);
      if (!hp.hit) {  // sky on miss, at every depth
        acc = add(acc, mul(thr, sky_radiance(sc, d)));
      } else {
        const Mat ms = load_mat<kFam>(sc.mats, sc.nm, hp.mat);
        const Mat me = kSplit ? load_mat<kFam>(sc.mats_eval, sc.nm, hp.mat) : ms;
        const V3 out = neg(d);
        if ((flags & FLAG_EMIT) && dot(out, hp.n) > 0.f) acc = add(acc, mul(thr, me.emi));

        // The seed is read where a hit lane first needs it, not held
        // through the walk.
        const uint32_t seed = __ldg(sc.args + ARG_SEED);
        const uint32_t lane = (uint32_t)lane_in[i];
        const uint32_t ctr = (uint32_t)bounce * 8u;
        float r[4];
        uniform4(seed, lane, ctr, r);

        // Russian roulette (`scene.rs:180-183`).
        const float prob = rr_prob(ms, flags, rr_scale);
        alive = prob == 1.0f || r[0] < prob;
        if (alive) {
          const float pc = fmaxf(prob, 1e-12f);
          V3 t2 = v3(thr.x / pc, thr.y / pc, thr.z / pc);
          if (flags & FLAG_NEE) {
            const V3 dl = direct_light<kFam>(sc, isect, hp, out, ms, me, seed, lane, ctr);
            acc = add(acc, mul(t2, dl));
            rays += 1.0f;  // the shadow ray
          }
          V3 sd, w;
          alive = scatter<kFam>(ms, me, hp, out, r, sd, w);
          if (alive) {
            new_o = hp.pos;
            new_d = sd;
            new_thr = mul(t2, w);
          }
        }
      }
    }
  } else {
    const V3 out = neg(d);
    Mat ms{}, me{};
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    V3 t2 = v3(0.f, 0.f, 0.f);
    Nee e{};
    bool ask = false;  // the lane asks a shadow query
    const Hit hp = isect(alive_entry, o, d, LLR_INF, -LLR_INF);
    if (alive_entry) {
      if (!hp.hit) {  // sky on miss, at every depth
        acc = add(acc, mul(thr, sky_radiance(sc, d)));
      } else {
        ms = load_mat<kFam>(sc.mats, sc.nm, hp.mat);
        me = kSplit ? load_mat<kFam>(sc.mats_eval, sc.nm, hp.mat) : ms;
        if ((flags & FLAG_EMIT) && dot(out, hp.n) > 0.f) acc = add(acc, mul(thr, me.emi));

        const uint32_t seed = __ldg(sc.args + ARG_SEED);
        const uint32_t lane = (uint32_t)lane_in[i];
        const uint32_t ctr = (uint32_t)bounce * 8u;
        uniform4(seed, lane, ctr, r);

        // Russian roulette (`scene.rs:180-183`).
        const float prob = rr_prob(ms, flags, rr_scale);
        alive = prob == 1.0f || r[0] < prob;
        if (alive) {
          const float pc = fmaxf(prob, 1e-12f);
          t2 = v3(thr.x / pc, thr.y / pc, thr.z / pc);
          if (flags & FLAG_NEE) ask = nee_setup<kFam>(sc, hp, out, ms, seed, lane, ctr, e);
        }
      }
    }
    const float cap = e.dist + 0.002f;
    const Hit shadow = isect(ask, hp.pos, e.wi, cap, cap - 0.004f);
    if (ask) nee_verdict(e, shadow);
    if (alive) {
      if (flags & FLAG_NEE) {
        acc = add(acc, mul(t2, nee_light<kFam>(sc, e, hp, out, me)));
        rays += 1.0f;  // the shadow ray
      }
      V3 sd, w;
      alive = scatter<kFam>(ms, me, hp, out, r, sd, w);
      if (alive) {
        new_o = hp.pos;
        new_d = sd;
        new_thr = mul(t2, w);
      }
    }
  }
  if (!lead) return;
  store3(o_out, i, new_o);
  store3(d_out, i, new_d);
  store3(thr_out, i, new_thr);
  store3(acc_out, i, acc);
  alive_out[i] = alive ? 1 : 0;
  rays_out[i] = rays;
}

// The launch behind each entry point: 128 threads a block, one per lane
// (a group per lane for GroupIsect, `threads_per_lane`); the instance of
// mask kFam that reads one material table when both are the same.
template <int kFam, class Isect>
int launch_bounce(const float* o_in, const float* d_in, const float* thr_in, const float* acc_in,
                  const uint8_t* alive_in, const int32_t* lane_in, float* o_out, float* d_out,
                  float* thr_out, float* acc_out, uint8_t* alive_out, float* rays_out,
                  const Scene& sc, const Isect& isect, int n, int bounce, int flags,
                  float rr_scale, void* stream, int threads_per_lane = 1) {
  const int block = 128;
  const long long threads = (long long)n * threads_per_lane;
  const int grid = (int)((threads + block - 1) / block);
  if (grid > 0 && sc.mats_eval == sc.mats) {
    bounce_kernel<Isect, false, kFam><<<grid, block, 0, (cudaStream_t)stream>>>(
        o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out, thr_out, acc_out, alive_out,
        rays_out, sc, isect, n, bounce, flags, rr_scale);
  } else if (grid > 0) {
    bounce_kernel<Isect, true, kFam><<<grid, block, 0, (cudaStream_t)stream>>>(
        o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out, thr_out, acc_out, alive_out,
        rays_out, sc, isect, n, bounce, flags, rr_scale);
  }
  return (int)cudaGetLastError();
}
