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
// Bound on an H100: a pure store. 24 B/lane (28 with g) written, nothing
// read; the arithmetic (one pcg4d, a few divisions, a sqrt, sin/cos for
// the aperture and omnidirectional kinds) is far below the FP32 rate.
// Threefry's two blocks add 120 SASS instructions a lane to pcg4d's (81 on
// the integer ALU pipe, 49 IMAD on the FMA pipe): on an H100 the ALU pipe
// needs 0.0102 ms at 2,097,152 lanes, under the stores' 0.0150 ms, so the
// bytes bound both instances (chip_smoke.py phase 27 counts the SASS). The
// design keeps the stores coalesced (consecutive threads write consecutive
// 12-byte rows) and reads the camera as a kernel argument, so no load
// reaches memory.
//
// Rounding: built with -fmad=false and IEEE division and sqrt, and the
// direction is normalised by dividing by the norm, as the plain version
// does: a last-ulp difference in d seeds chaotic divergence over 80
// bounces. Lane ids wrap in uint32: glane = lane + lane_offset.
#include "common.cuh"

// Threefry-2x32, 20 rounds, in native uint32 (ops/rng.py::threefry2x32):
// add, rotate (the funnel shift) and xor a round, the key injected every 4.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, kRot[i % 8]) ^ x0;
    if (i % 4 == 3) {
      const int j = i / 4 + 1;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + (uint32_t)j;
    }
  }
}

// ops/rng.py::uniform4 under threefry: blocks keyed (seed, seed ^
// 0x9E3779B9) on (lane, ctr) and (lane, ctr ^ 0x80000000).
__device__ __forceinline__ void uniform4_threefry(uint32_t seed, uint32_t lane, uint32_t ctr,
                                                  float out[4]) {
  const uint32_t k1 = seed ^ 0x9E3779B9u;
  uint32_t v[4] = {lane, ctr, lane, ctr ^ 0x80000000u};
  threefry2x32(seed, k1, v[0], v[1]);
  threefry2x32(seed, k1, v[2], v[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (float)(v[i] >> 8) * (1.0f / 16777216.0f);
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
    int th, int kind, CameraRow cam) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint32_t wh = (uint32_t)w * (uint32_t)h;
  const uint32_t pixel = (uint32_t)lane % wh;
  uint32_t px, py;
  if (tw == 0) {  // raster order
    px = pixel % (uint32_t)w;
    py = pixel / (uint32_t)w;
  } else {  // tw x th tiles, tiles in row-major order
    const uint32_t tsz = (uint32_t)(tw * th);
    const uint32_t tile = pixel / tsz, within = pixel % tsz;
    const uint32_t tpr = (uint32_t)(w / tw);
    px = (tile % tpr) * (uint32_t)tw + within % (uint32_t)tw;
    py = (tile / tpr) * (uint32_t)th + within / (uint32_t)tw;
  }
  float r[4];
  if (kThreefry) {
    uniform4_threefry(seed, (uint32_t)lane + lane_offset, 0x40000000u, r);
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
  if (kind == CAM_OMNIDIRECTIONAL) {
    // Longitude p over [0, 2pi), colatitude t over [0, pi), z up.
    const float p = ((float)px + u) / (float)w * LLR_TWO_PI;
    const float t = ((float)py + v) / (float)h * LLR_PI;
    const float st = sinf(t), ct = cosf(t);
    store3(o_out, lane, ap);
    store3(d_out, lane, v3(st * cosf(p), st * sinf(p), ct));
    return;
  }
  const V3 pos = v3(cam.v[0], cam.v[1], cam.v[2]);
  const V3 right = v3(cam.v[6], cam.v[7], cam.v[8]);
  const V3 up = v3(cam.v[11], cam.v[12], cam.v[13]);
  const V3 fwd = v3(cam.v[14], cam.v[15], cam.v[16]);

  const float sx = (((float)px + u) / (float)w - 0.5f) * cam.v[9];
  const float sy = (((float)py + v) / (float)h - 0.5f) * cam.v[10];
  const V3 sp = add(sub(pos, scale(right, sx)), scale(up, sy));

  if (kind == CAM_IDEAL_PINHOLE) {
    store3(o_out, lane, ap);
    store3(d_out, lane, normalize(sub(ap, sp)));
    return;
  }
  // Finite aperture: a disk sample on the aperture.
  const float theta = LLR_TWO_PI * u2;
  const float rad = sqrtf(v2) * cam.v[17];
  const V3 apt = add(add(ap, scale(right, cosf(theta) * rad)), scale(up, sinf(theta) * rad));
  const V3 d0 = normalize(sub(apt, sp));
  const float c = dot(d0, fwd);
  const float dist = cam.v[19] / c;
  g_out[lane] = c * c / (dist * dist);
  store3(o_out, lane, apt);
  if (kind == CAM_PINHOLE) {
    store3(d_out, lane, d0);
    return;
  }
  // Thin lens: aim at the focus-plane point of the sensor->aperture-center ray.
  const V3 sc = sub(ap, sp);
  const V3 op = scale(sc, cam.v[18] / dot(sc, fwd));
  store3(d_out, lane, normalize(sub(add(ap, op), apt)));
}

// `threefry`: 0 draws pcg4d, 1 Threefry-2x32 (ops/rng.py's mixer).
extern "C" int llr_raygen(float* o_out, float* d_out, float* g_out, float* u_out, int n,
                          uint32_t seed, uint32_t lane_offset, int w, int h, int tw, int th,
                          int kind, const float* cam_row, int threefry, void* stream) {
  CameraRow cam;
  for (int i = 0; i < 24; ++i) cam.v[i] = cam_row[i];
  const int block = 256;
  const int grid = (n + block - 1) / block;
  const cudaStream_t s = (cudaStream_t)stream;
  if (grid > 0 && threefry) {
    raygen_kernel<true><<<grid, block, 0, s>>>(o_out, d_out, g_out, u_out, n, seed, lane_offset,
                                               w, h, tw, th, kind, cam);
  } else if (grid > 0) {
    raygen_kernel<false><<<grid, block, 0, s>>>(o_out, d_out, g_out, u_out, n, seed,
                                                lane_offset, w, h, tw, th, kind, cam);
  }
  return (int)cudaGetLastError();
}
