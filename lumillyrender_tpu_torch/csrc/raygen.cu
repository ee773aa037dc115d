// Camera ray generation: one thread per camera lane.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bounce.py::_raygen_kernel.
// Per lane: the tile (or raster) pixel decode of integrator/render.py, the
// lane's four random numbers at counter 0x40000000 (pcg4d, or under
// LLR_RNG=threefry two Threefry-2x32 blocks: the template parameter
// kThreefry, one kernel with two instances), and the camera math of
// ops/camera.py for all four
// kinds: the ideal pinhole, the thin lens, the realistic pinhole and the
// omnidirectional camera (an equirect direction from the aperture position
// that ignores the camera basis, quirk #13 of ops/camera.py). Outputs o, d
// (N,3), for the finite-aperture kinds the geometry term g (N,), and, when
// asked, the lane's four random numbers (N,4). The ideal pinhole and the
// omnidirectional camera have g = pdf = 1 and write no g.
//
// Bound on an H100: 24 B/lane (28 with g) written, nothing read: 0.0150 ms
// at 2,097,152 lanes. What a lane of the function needs takes less on its
// busiest pipe (chip_smoke.py phase 27, `raygen_ops`: threefry's 90 integer
// ALU operations for the ideal pinhole, 0.0113 ms), so the bytes bound both
// instances. The design keeps every lane's work its own: the pixel decode
// divides by multiply-high with the wrapper's magic numbers, the threefry
// key schedule and counter words come from the wrapper (RaygenConsts), a
// kind that uses two random words draws one threefry block, and the camera
// is a kernel argument, so no load reaches memory. Each lane stores its
// 12-byte rows itself (consecutive threads, consecutive rows): staging a
// warp's rows in shared memory for 16-byte stores was 11% slower on an
// H100.
//
// Rounding: built with -fmad=false and IEEE division and sqrt, and the
// direction is normalised by dividing by the norm, as the plain version
// does: a last-ulp difference in d seeds chaotic divergence over 80
// bounces. Lane ids wrap in uint32: glane = lane + lane_offset.
#include <cstring>

#include "common.cuh"

// The launch's constants, computed by the wrapper
// (ops/cuda_bounce.py::raygen_consts): the pixel decode's divisors and the
// threefry key schedule, which are the same for every lane.
//
// A divisor d as (m, s1, s2, d): n / d = (t + ((n - t) >> s1)) >> s2 with t
// the high word of m * n, exact for every uint32 n (Granlund & Montgomery
// 1994, fig. 4.1): five instructions where a division by a runtime value
// takes a few dozen.
struct Divisor {
  uint32_t m, s1, s2, d;
};
struct RaygenConsts {
  Divisor wh, a, b, c;  // w*h; raster: a = w; tiles: a = tw*th, b = w/tw, c = tw
  uint32_t x1[2];       // each threefry block's x1 after the first injection
  uint32_t k0[5], k1[5];  // the injections after rounds 4, 8, .., 20
};

__device__ __forceinline__ uint32_t udiv(uint32_t n, const Divisor& q) {
  const uint32_t t = __umulhi(n, q.m);
  return (t + ((n - t) >> q.s1)) >> q.s2;
}

// Threefry-2x32, 20 rounds, in native uint32 (ops/rng.py::threefry2x32):
// add, rotate (the funnel shift) and xor a round, the key injected every 4
// from the launch's schedule. x0 enters with its first injection added.
__device__ __forceinline__ void threefry_rounds(const RaygenConsts& k, uint32_t& x0,
                                                uint32_t& x1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, kRot[i % 8]) ^ x0;
    if (i % 4 == 3) {
      x0 += k.k0[i / 4];
      x1 += k.k1[i / 4];
    }
  }
}

__device__ __forceinline__ float word_to_unit(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

struct CameraRow {
  float v[24];  // position3 | aperture3 | right3 | sensor2 | up3 | forward3 |
                // aperture_radius | focus_distance | aperture_sensor_distance | pad
};

enum { CAM_IDEAL_PINHOLE = 0, CAM_THIN_LENS = 1, CAM_OMNIDIRECTIONAL = 2, CAM_PINHOLE = 3 };

template <bool kThreefry>
__global__ void __launch_bounds__(256) raygen_kernel(
    float* __restrict__ o_out, float* __restrict__ d_out, float* __restrict__ g_out,
    float* __restrict__ u_out, int n, uint32_t seed, uint32_t lane_offset, int w, int h, int tw,
    int th, int kind, CameraRow cam, RaygenConsts k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  // The pixel: lane % (w h), then raster or tw x th tiles in row-major order.
  const uint32_t l = (uint32_t)lane;
  const uint32_t pixel = l - udiv(l, k.wh) * k.wh.d;
  uint32_t px, py;
  if (tw == 0) {
    py = udiv(pixel, k.a);
    px = pixel - py * k.a.d;
  } else {
    const uint32_t tile = udiv(pixel, k.a), within = pixel - tile * k.a.d;
    const uint32_t ty = udiv(tile, k.b), wy = udiv(within, k.c);
    px = (tile - ty * k.b.d) * (uint32_t)tw + (within - wy * k.c.d);
    py = ty * (uint32_t)th + wy;
  }
  // The lane's four random numbers at counter 0x40000000. Threefry's second
  // block (words 2 and 3) only where they are used: the aperture kinds, or
  // the words asked for.
  const bool aperture = kind == CAM_THIN_LENS || kind == CAM_PINHOLE;
  float r[4];
  if (kThreefry) {
    const uint32_t x0 = (uint32_t)lane + lane_offset + seed;
    uint32_t a0 = x0, a1 = k.x1[0];
    threefry_rounds(k, a0, a1);
    r[0] = word_to_unit(a0);
    r[1] = word_to_unit(a1);
    r[2] = r[3] = 0.0f;
    if (aperture || u_out != nullptr) {
      uint32_t b0 = x0, b1 = k.x1[1];
      threefry_rounds(k, b0, b1);
      r[2] = word_to_unit(b0);
      r[3] = word_to_unit(b1);
    }
  } else {
    uniform4(seed, (uint32_t)lane + lane_offset, 0x40000000u, r);
  }
  const float u = r[0], v = r[1], u2 = r[2], v2 = r[3];
  if (u_out != nullptr) {  // the random numbers themselves, for checking
    float* ul = u_out + 4 * (int64_t)lane;
    ul[0] = u;
    ul[1] = v;
    ul[2] = u2;
    ul[3] = v2;
  }

  const V3 ap = v3(cam.v[3], cam.v[4], cam.v[5]);
  V3 o, d;
  if (kind == CAM_OMNIDIRECTIONAL) {
    // Longitude p over [0, 2pi), colatitude t over [0, pi), z up.
    const float p = ((float)px + u) / (float)w * LLR_TWO_PI;
    const float t = ((float)py + v) / (float)h * LLR_PI;
    const float st = sinf(t), ct = cosf(t);
    o = ap;
    d = v3(st * cosf(p), st * sinf(p), ct);
  } else {
    const V3 pos = v3(cam.v[0], cam.v[1], cam.v[2]);
    const V3 right = v3(cam.v[6], cam.v[7], cam.v[8]);
    const V3 up = v3(cam.v[11], cam.v[12], cam.v[13]);
    const V3 fwd = v3(cam.v[14], cam.v[15], cam.v[16]);

    const float sx = (((float)px + u) / (float)w - 0.5f) * cam.v[9];
    const float sy = (((float)py + v) / (float)h - 0.5f) * cam.v[10];
    const V3 sp = add(sub(pos, scale(right, sx)), scale(up, sy));

    if (!aperture) {  // the ideal pinhole
      o = ap;
      d = normalize(sub(ap, sp));
    } else {
      // Finite aperture: a disk sample on the aperture.
      const float theta = LLR_TWO_PI * u2;
      const float rad = sqrtf(v2) * cam.v[17];
      const V3 apt =
          add(add(ap, scale(right, cosf(theta) * rad)), scale(up, sinf(theta) * rad));
      const V3 d0 = normalize(sub(apt, sp));
      const float c = dot(d0, fwd);
      const float dist = cam.v[19] / c;
      g_out[lane] = c * c / (dist * dist);
      o = apt;
      if (kind == CAM_PINHOLE) {
        d = d0;
      } else {
        // Thin lens: aim at the focus-plane point of the sensor->aperture-center ray.
        const V3 sc = sub(ap, sp);
        const V3 op = scale(sc, cam.v[18] / dot(sc, fwd));
        d = normalize(sub(add(ap, op), apt));
      }
    }
  }
  store3(o_out, lane, o);
  store3(d_out, lane, d);
}

// `consts`: the launch's RaygenConsts as 28 uint32 words
// (ops/cuda_bounce.py::raygen_consts); `threefry`: 0 draws pcg4d, 1
// Threefry-2x32 (ops/rng.py's mixer).
extern "C" int llr_raygen(float* o_out, float* d_out, float* g_out, float* u_out, int n,
                          uint32_t seed, uint32_t lane_offset, int w, int h, int tw, int th,
                          int kind, const float* cam_row, const uint32_t* consts, int threefry,
                          void* stream) {
  static_assert(sizeof(RaygenConsts) == 28 * sizeof(uint32_t), "RaygenConsts is 28 words");
  CameraRow cam;
  for (int i = 0; i < 24; ++i) cam.v[i] = cam_row[i];
  RaygenConsts k;
  memcpy(&k, consts, sizeof k);
  const int block = 256;
  const int grid = (n + block - 1) / block;
  const cudaStream_t s = (cudaStream_t)stream;
  if (grid > 0 && threefry) {
    raygen_kernel<true><<<grid, block, 0, s>>>(o_out, d_out, g_out, u_out, n, seed, lane_offset,
                                               w, h, tw, th, kind, cam, k);
  } else if (grid > 0) {
    raygen_kernel<false><<<grid, block, 0, s>>>(o_out, d_out, g_out, u_out, n, seed,
                                                lane_offset, w, h, tw, th, kind, cam, k);
  }
  return (int)cudaGetLastError();
}
