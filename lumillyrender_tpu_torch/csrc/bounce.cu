// One whole brute-force bounce per lane (bounce_body.cuh with a sweep over
// every triangle and sphere). One thread per lane.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bounce.py::_bounce_kernel
// (body _bounce_body, intersection _intersect_all). Its plain version is
// integrator/wavefront.py::plain_bounce_step on a brute-force scene.
//
// Bound on an H100: at full width (2M lanes) memory. Each lane reads
// o, d, throughput, accum (48 B), alive (1 B) and its lane id (4 B), and
// writes o, d, throughput, accum (48 B), alive (1 B) and its ray count (4 B):
// 106 B/lane. The arithmetic is ~nt+ns primary tests plus as many shadow
// tests per live lane, a few hundred flops each way, below the FP32 rate at
// the flagship's 14 prims. At the 4096-lane tail stages the launch itself
// bounds it. The design: the state is read and written once, in the
// PathState's own (N,3) rows (no tiling pass around the kernel); the prim,
// material and light tables stay in global memory, where every lane of a
// warp reads the same row at the same time (one broadcast through L1); dead
// lanes leave after the sky test; the light is picked by binary search
// over the CDF, so the kernel has no cap on prims, lights or materials.
//
// The triangle table and the intersector, BruteIsect, are in
// bounce_body.cuh, which the backward kernel (bounce_bwd.cu) shares.
#include "bounce_body.cuh"

extern "C" int llr_bounce(const float* o_in, const float* d_in, const float* thr_in,
                          const float* acc_in, const uint8_t* alive_in, const int32_t* lane_in,
                          float* o_out, float* d_out, float* thr_out, float* acc_out,
                          uint8_t* alive_out, float* rays_out, const float* tris, int nt,
                          const float* sph, int ns, const float* mats,
                          const float* mats_eval, int nm, const float* lights, int nl,
                          float total_area, int n, int bounce,
                          uint32_t seed, int flags, float rr_scale, float sky_r, float sky_g,
                          float sky_b, const float* ibl, int ibl_w, int ibl_h, float lon,
                          void* stream) {
  const Scene sc{sph, ns, mats, mats_eval, nm, lights, nl, total_area, V3{sky_r, sky_g, sky_b},
                 ibl, ibl_w, ibl_h, lon};
  return launch_bounce(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out, thr_out,
                       acc_out, alive_out, rays_out, sc, BruteIsect{tris, nt, sph, ns}, n, bounce,
                       seed, flags, rr_scale, stream);
}
