// One whole brute-force bounce per lane (bounce_body.cuh with a sweep over
// every triangle and sphere).
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bounce.py::_bounce_kernel
// (body _bounce_body, intersection _intersect_all). Its plain version is
// integrator/wavefront.py::plain_bounce_step on a brute-force scene.
//
// Bound on an H100: at full width (2M lanes) memory by the bytes it must
// move. Each lane reads o, d, throughput, accum (48 B), alive (1 B) and
// its lane id (4 B), and writes o, d, throughput, accum (48 B), alive (1 B)
// and its ray count (4 B): 106 B/lane. What holds it back is the
// instructions it issues: built -fmad=false with IEEE division, each live
// lane runs two brute-force sweeps (primary and shadow ray, ~60-90
// instructions a prim test) and shading of a few hundred more, which the
// flop count of the bound understates. The design cuts the instructions
// that carry no arithmetic, as the TPU kernel's static scene arguments do,
// with instances chosen per launch (`instance`, `group`) by
// ops/cuda_bounce.py::launch_instance from the table shapes, the families
// and the width:
//   * the sweep: SmallIsect (nt <= 16, ns <= 8, at most 262,144 lanes; the
//     prim rows in the kernel's parameters, an unrolled sweep with
//     constant-bank operands) or BruteIsect (any size or width; a compact
//     loop over the rows);
//   * the shading: Lambert only (FAM_LAMBERT, inlined) or every family
//     (FAM_ALL), each in a one- and a two-table variant (launch_bounce);
//   * at the narrow stages (`group` > 1 threads per lane), GroupIsect
//     splits each sweep over a group of threads, so a launch whose grid
//     fills under one wave costs a shorter chain per lane.
// The state is read and written once, in the PathState's own (N,3) rows;
// dead lanes leave after the sky test; the light is picked by binary
// search over the CDF, so the kernel has no cap on lights or materials.
#include "bounce_body.cuh"

#include <cstring>

namespace {

enum { INSTANCE_SMALL = 1, INSTANCE_LAMBERT = 2 };

template <int kFam>
int launch_family(const float* o_in, const float* d_in, const float* thr_in, const float* acc_in,
                  const uint8_t* alive_in, const int32_t* lane_in, float* o_out, float* d_out,
                  float* thr_out, float* acc_out, uint8_t* alive_out, float* rays_out,
                  const Scene& sc, const float* tris, int nt, const float* sph, int ns,
                  const float* small_rows, bool small, int group, int n, int bounce,
                  int flags, float rr_scale, void* stream) {
  if (group > 1) {
    const int log2g = group == 2 ? 1 : group == 4 ? 2 : group == 8 ? 3 : 4;
    return launch_bounce<kFam>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                               thr_out, acc_out, alive_out, rays_out, sc,
                               GroupIsect{tris, nt, sph, ns, log2g}, n, bounce, flags,
                               rr_scale, stream, 1 << log2g);
  }
  if (small) {
    SmallIsect isect{};
    std::memcpy(&isect.p, small_rows, sizeof(SmallPrims));
    isect.nt = nt;
    isect.ns = ns;
    return launch_bounce<kFam>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                               thr_out, acc_out, alive_out, rays_out, sc, isect, n, bounce, flags,
                               rr_scale, stream);
  }
  return launch_bounce<kFam>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                             thr_out, acc_out, alive_out, rays_out, sc,
                             BruteIsect{tris, nt, sph, ns}, n, bounce, flags, rr_scale,
                             stream);
}

}  // namespace

// `instance`: INSTANCE_SMALL (prims by value from `small_rows`, the host
// copy of a SmallPrims, which needs nt <= 16 and ns <= 8) and
// INSTANCE_LAMBERT (every row Lambert) bits; `group` threads per lane (1,
// or 2, 4, 8, 16 for GroupIsect, which reads the tables whatever the
// instance); `args` the launch's step values (bounce_body.cuh ARG_*, 16-byte
// aligned, on the card). Returns 1 (cudaErrorInvalidValue) on an argument
// outside that.
extern "C" int llr_bounce(const float* o_in, const float* d_in, const float* thr_in,
                          const float* acc_in, const uint8_t* alive_in, const int32_t* lane_in,
                          float* o_out, float* d_out, float* thr_out, float* acc_out,
                          uint8_t* alive_out, float* rays_out, const float* tris, int nt,
                          const float* sph, int ns, const float* mats,
                          const float* mats_eval, int nm, const float* lights, int nl,
                          float total_area, int n, int bounce, const uint32_t* args,
                          int flags, float rr_scale, const float* ibl, int ibl_w, int ibl_h,
                          int simple, int instance, int group, const float* small_rows,
                          void* stream) {
  const Scene sc{sph, ns, mats, mats_eval, nm, lights, nl, total_area, args, ibl, ibl_w, ibl_h,
                 simple != 0};
  const bool small = (instance & INSTANCE_SMALL) != 0;
  if ((small && (small_rows == nullptr || nt > kSmallTris || ns > kSmallSpheres)) ||
      !(group == 1 || group == 2 || group == 4 || group == 8 || group == 16) ||
      args == nullptr || reinterpret_cast<uintptr_t>(args) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (instance & INSTANCE_LAMBERT) {
    return launch_family<FAM_LAMBERT>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out,
                                      d_out, thr_out, acc_out, alive_out, rays_out, sc, tris, nt,
                                      sph, ns, small_rows, small, group, n, bounce, flags,
                                      rr_scale, stream);
  }
  return launch_family<FAM_ALL>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                                thr_out, acc_out, alive_out, rays_out, sc, tris, nt, sph, ns,
                                small_rows, small, group, n, bounce, flags, rr_scale,
                                stream);
}
