// Shared device helpers for the render kernels: float3 arithmetic written
// out one IEEE operation at a time, the triangle and sphere tests, the pcg4d
// counter RNG, and constants.
//
// The kernels are built with -fmad=false (see ops/cuda_bounce.py): every
// a*b+c below rounds twice, exactly as the plain PyTorch version's separate
// elementwise ops do, so a kernel lane and a plain lane take the same
// discrete decisions (hit winner, checker texel, shadow verdict) unless a
// transcendental differs in its last bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LLR_EPS 1e-3f
#define LLR_INF 1e5f
// Python computes 2*PI, 8*PI etc. in double and PyTorch rounds the
// product to float32 once; the same constants here.
#define LLR_PI ((float)3.14159265358979323846)
#define LLR_TWO_PI ((float)(2.0 * 3.14159265358979323846))
#define LLR_EIGHT_PI ((float)(8.0 * 3.14159265358979323846))

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  float px = a.x * b.x, py = a.y * b.y, pz = a.z * b.z;
  return px + py + pz;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(fmaxf(dot(a, a), 0.0f)); }
__device__ __forceinline__ V3 normalize(V3 a) { return divs(a, norm(a)); }
__device__ __forceinline__ V3 safe_normalize(V3 a) { return divs(a, fmaxf(norm(a), 1e-20f)); }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// pcg4d (Jarzynski & Olano 2020) in native uint32: (lane, ctr, seed, salt)
// -> four U[0,1) floats from the top 24 bits of each word.
__device__ __forceinline__ void uniform4(uint32_t seed, uint32_t lane, uint32_t ctr,
                                         float out[4]) {
  uint32_t v[4] = {lane, ctr, seed, 0xB5297A4Du};
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = v[i] * 1664525u + 1013904223u;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    v[0] += v[1] * v[3];
    v[1] += v[2] * v[0];
    v[2] += v[0] * v[1];
    v[3] += v[1] * v[2];
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] ^= v[i] >> 16;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (float)(v[i] >> 8) * (1.0f / 16777216.0f);
}

// Moller-Trumbore (ops/intersect.py::_mt, the same operations in the same
// order): true with the hit distance in `t` when the ray hits the triangle
// at t >= EPS.
__device__ __forceinline__ bool tri_test(V3 o, V3 d, V3 p0, V3 e1, V3 e2, float& t) {
  const V3 pv = cross(d, e2);
  const float det = e1.x * pv.x + e1.y * pv.y + e1.z * pv.z;
  const bool det_ok = fabsf(det) >= LLR_EPS;
  const float inv = 1.0f / (det_ok ? det : 1.0f);
  const V3 tv = sub(o, p0);
  const float u = (tv.x * pv.x + tv.y * pv.y + tv.z * pv.z) * inv;
  const V3 qv = cross(tv, e1);
  const float v = (d.x * qv.x + d.y * qv.y + d.z * qv.z) * inv;
  t = (e2.x * qv.x + e2.y * qv.y + e2.z * qv.z) * inv;
  return det_ok && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t >= LLR_EPS;
}

// Sphere test (ops/intersect.py::_sph_t): true with the distance in `t`.
// The one fused multiply-add: see ops/intersect.py::_fma.
__device__ __forceinline__ bool sphere_test(V3 o, V3 d, V3 c, float rad, float& t) {
  const V3 co = sub(o, c);
  const float cod = co.x * d.x + co.y * d.y + co.z * d.z;
  const float det = fmaf(cod, cod, -(co.x * co.x + co.y * co.y + co.z * co.z)) + rad * rad;
  const float sq = sqrtf(det > 0.f ? det : 1.0f);
  const float t1 = -cod - sq, t2 = -cod + sq;
  t = t1 > LLR_EPS ? t1 : t2;
  return det > 0.f && t > LLR_EPS;
}
