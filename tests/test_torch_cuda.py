"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card (this file imports no
JAX, so it runs on a machine that has only PyTorch). Run them there with
`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q`. Here
the kernels run at a few thousand lanes; chip_smoke.py makes the same
comparisons at the main paths' own widths: the brute-force bounce on
new-cbox at 2,097,152 lanes and on every launch of one chunk (2,097,152,
32,768 and 4,096 lanes), the BVH kernels on welcome-geo at 2,072,576 lanes
and on every launch of one chunk (2,072,576, 259,072, 32,512 and 4,096
lanes), the AOV walks and the K=128 bounce on the 1M- and
1.5M-triangle terrains at 2,097,152 lanes. The capability probes' kernels
run at their tools' own shapes here and there.

Tolerances: raygen's random bits and origins are exact, directions within
2e-7 (one ulp of a unit vector's components, from the card's own sqrt and
division being compared with PyTorch's); the BVH walks, per thread
(csrc/bvh.cu, its K=32, K=128 and runtime-K instances) and the AOV walks
(csrc/bvh_aov.cu, wide and streamed), every output bit-equal (their
operations are the plain walk's, in the same order, without contraction;
each lane tests exactly the plain walk's leaves in its order, slot by slot
with a strict <, and the warp's reduction keeps the plain walk's slot among
equal t), on camera, random and axis-aligned rays, tie leaves, leaves with
padding inside and at the end that holds live triangles, partial warps and
warps that mix capped and open queries; the bounces follow
lumillyrender_tpu_torch/parity.py's lane rules, and the BVH bounce on the
hand-written tie leaves and on warps of chosen leaf requests also has its
new origins, directions, alive and ray count bit-equal to the plain step's,
with no tie and no accum flip (`assert_walks_agree`); the backward kernel is
compared on its backward rules' lanes (`bwd_comparable`) within
`parity.KERNEL_BWD_RTOL` (1e-5) of each cotangent's and table's largest
magnitude, with the recomputed alive' equal to the forward kernel's on
every lane and two runs bit-equal; the capability probes' kernels
(csrc/probes.cu) every output bit-equal, the packet walk, the link walk,
the four-read sum and smem_input's 64-read sum (at each table size) on
seeded tables too, the scatter on seeded index sets (wrapped and dropped
indices), the link walk NaN on cyclic tables; kernel 1's two instances for every camera kind in both pixel orders,
d and g within 1e-6 where the film's dims are no powers of 2 (PyTorch on
the card divides by a host scalar through its reciprocal); the forward stage loop captured
as a CUDA graph, every stage-end state and the ray count bit-equal to a
host loop over the same kernels (and under fused="off" over the plain
step), the films within chip_smoke.py's film gate (the banks add with
atomics); the hybrid training step on BVH and
IBL scenes (make_step_diff's `make_step_hybrid`: kernel 4 or 2 forward,
kernel 3 in the backward's recompute) against autograd of the plain step
with the plain walk, within `parity.AUTOGRAD_BWD_RTOL` on the lanes
`parity.bwd_comparable` keeps, and its film_and_grads repeating bit for
bit; film_and_grads's training plan (its first call captured as a CUDA
graph, every later one a replay) bit-equal to the eager step, with the
same launches, as the albedo, the sky and the seed change (new-cbox,
ibl-material, welcome-geo) and of the plain step kind (fused="off",
welcome-geo, under "full" and "isect");
under `fused="off"` the plain step with kernel 3 as its walk, its
gradients bit-equal under the four recompute policies and its backward
pass walking nothing under the `isect` ones; under `LLR_RNG=threefry`
(set as `rng._MIXER`), kernel 1's threefry instance with its random words
bit-equal to `rng.uniform4`'s, the bounce kernels refused before anything
is packed and `fused="off"` rendering with kernel 1 and the plain step;
kernels 3 and 4 at leaf widths K = 8, 16, 24, 48 and 64 (kernel 3
bit-equal to the plain walk, kernel 4 under parity.py's rules); kernel 4
on the hero scenes ridaisai (refraction through closed meshes, pure pt)
and welcome (GGX on triangles), and ridaisai's full-width chunk through
the captured stage loop; vec.sqrt and vec.over (the plain step's sqrt and
host-scalar divisions) bit-equal to numpy's IEEE results; the estimator
gates of tools/torch_oracle_gate.py through the kernels: the white
furnace (exact at 48^2 x 8 spp; at 2,097,152 lanes on its lattice with
the few samples trapped inside the sphere counted) and the oracle gate on
pt-spheres and mesh-thinlens at the CI size against the committed stacks
(tests/oracle_stacks.npz; chip_smoke.py's phase 29 runs all six configs
at ORACLE.json's size); FD against AD through make_step_diff's hybrid
(tools/torch_grad_gates.py, the gates tests/test_torch_grad_gates.py holds
on the CPU against the JAX package): ibl-material's GGX roughness through
kernel 2, welcome's GGX bunny (roughness, reflectance) under a camera it
fills through kernel 4, each with its launch counts; an AOV chunk as a
captured plan (welcome-geo through kernel 3, a 20,000-triangle terrain at
K=128 through kernel 7 and, under a lowered wide cap, kernel 6): its first
call and a replay bit-equal to the eager chunk with the same launches, two
eager AOV renders bit-equal (the ordered bank), and kernel 4 on that
terrain's streamed route under parity.py's rules against the
`fused="off"` step, whose walk is kernel 6.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lumillyrender_tpu_torch import parity, probes
from lumillyrender_tpu_torch.convert import state_from_numpy
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.constants import EPS, INF
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh
from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd
from lumillyrender_tpu_torch.ops.intersect import _walk_tris, intersect_shade, intersect_shade_brute
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from torch_tie_leaves import TIE_LAYOUTS, tie_bvh, tie_rays, with_live_padding
from torch_many_rows import bounce_grads, tiled_scene

ASSETS = Path(__file__).resolve().parents[1] / "assets"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _random_state(scene, n, seed):
    g = scene.geometry
    ref = torch.cat([g.tri_p0, g.sph_c]).cpu().numpy()
    rng = np.random.default_rng(seed)
    o = rng.uniform(ref.min(0) - 1, ref.max(0) + 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    thr = rng.uniform(0.1, 1.5, size=(n, 3)).astype(np.float32)
    acc = rng.uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.85
    lane = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    return o, d, thr, acc, alive, lane



def assert_walks_agree(want, got):
    """A bounce kernel's state against the plain step's where the walk
    decides it: the new origins (the hit points, o + d t), the new
    directions (sampled about the winner's normal), alive and the ray count
    bit-equal; throughput and accum, whose shading arithmetic differs from
    the plain step's in its last bits (max rel 2.4e-7 in every earlier
    run), under parity.py's rules with no tie and no accum flip."""
    for name in ("o", "d", "alive", "rays_traced"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    m = parity.agreement(want, got)
    assert parity.failures(m) == [] and m["tie"] == 0.0 and m["accum_flip"] == 0.0, m

@pytest.mark.cuda
def test_raygen_kernel_matches_plain(card):
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    o, d, pdf, g = cuda_bounce.generate_rays(c.data, c.settings, 5, 32, 65536)
    o_p, d_p, pdf_p, g_p = cuda_bounce.plain_generate_rays(
        c.data, c.settings, 5, 32, 65536)
    torch.cuda.synchronize()
    assert torch.equal(o, o_p)
    assert (d - d_p).abs().max().item() < 2e-7
    assert torch.equal(pdf, pdf_p) and torch.equal(g, g_p)


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3, 7, 70])
def test_bounce_kernel_matches_plain(card, bounce):
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    parts = _random_state(c.data, 65536, bounce)
    st = state_from_numpy(bounce, *parts, device=card)
    got = cuda_bounce.bounce(c.data, c.settings, 77, st)
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []


@pytest.fixture(scope="module")
def welcome():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return compile_scene_file(ASSETS / "welcome-geo.toml", device="cuda")


def _bvh_rays(bvh, n, seed):
    """Random rays from the root box, uniform directions; a quarter of them
    axis-aligned from origins on node planes (the slab test's 0 * inf)."""
    rng = np.random.default_rng(seed)
    lo, hi = (bvh.node_min[0].cpu().numpy(), bvh.node_max[0].cpu().numpy())
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = n // 4
    axis = rng.integers(0, 3, size=q)
    d[:q] = 0.0
    d[np.arange(q), axis] = rng.choice([-1.0, 1.0], size=q)
    planes = np.concatenate([bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy()])
    rows = rng.integers(0, planes.shape[0], size=q)
    side = (axis + 1) % 3
    o[np.arange(q), side] = planes[rows, side]
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("rays", ["random and axis-aligned", "camera"])
@pytest.mark.parametrize("want_shade", [False, True])
def test_bvh_kernel_matches_plain_walk(welcome, want_shade, rays):
    """Kernel 3's K=32 instance on welcome-geo: random rays with a quarter
    axis-aligned from origins on node planes (the slab test's 0 * inf), or
    the camera rays of a chunk's first lanes; every output bit-equal to the
    plain walk's."""
    bvh = welcome.data.bvh
    tables = cuda_bvh.tables_of(bvh)
    if rays == "camera":
        o, d, _, _ = cuda_bounce.generate_rays(welcome.data, welcome.settings, 5, 0, 65536)
    else:
        o, d = _bvh_rays(bvh, 8192, 3)
    t0 = torch.full((o.shape[0],), INF, device=o.device)
    stop = torch.full_like(t0, -INF)
    before = cuda_bvh.intersect_tris.launches
    got = cuda_bvh.intersect_tris(o, d, t0, stop, tables, want_shade)
    want = _walk_tris(o, d, t0, stop, bvh, want_shade)
    torch.cuda.synchronize()
    assert cuda_bvh.intersect_tris.launches == before + 1
    assert int((want[1] >= 0).sum()) > o.shape[0] // 8
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bvh_kernel_occlusion_verdicts(welcome):
    """t_cap/occlusion queries: the kernel's visibility verdicts equal the
    plain walk's and the exact nearest-hit query's."""
    bvh = welcome.data.bvh
    tables = cuda_bvh.tables_of(bvh)
    o, d = _bvh_rays(bvh, 8192, 4)
    rng = np.random.default_rng(5)
    dist = torch.from_numpy(rng.uniform(1.0, 600.0, size=o.shape[0]).astype(np.float32)).cuda()
    cap = dist + 2.0 * EPS
    stop = cap - 4.0 * EPS
    got = cuda_bvh.intersect_tris(o, d, cap, stop, tables)
    want = _walk_tris(o, d, cap, stop, bvh, False)
    exact = _walk_tris(o, d, cap, torch.full_like(cap, -INF), bvh, False)
    verdict = lambda r: (r[1] >= 0) & ((r[0] - dist).abs() <= EPS)
    torch.cuda.synchronize()
    assert torch.equal(verdict(got), verdict(want))
    assert torch.equal(verdict(got), verdict(exact))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3, 7, 70])
def test_bvh_bounce_kernel_matches_plain(welcome, bounce):
    c = welcome
    parts = _random_state(c.data, 16384, 100 + bounce)
    st = state_from_numpy(bounce, *parts, device="cuda")
    got = cuda_bounce.bounce_bvh(c.data, c.settings, 77, st)
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []


@pytest.fixture(scope="module")
def heroes():
    """The hero scenes: ridaisai (refraction through two closed bunny
    meshes, pure pt) and welcome (GGX on triangles, pt-direct), both under
    an IBL sky."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return {name: compile_scene_file(ASSETS / f"{name}.toml", device="cuda")
            for name in ("ridaisai", "welcome")}


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3, 7, 70])
@pytest.mark.parametrize("name", ["ridaisai", "welcome"])
def test_bvh_bounce_kernel_matches_plain_on_hero_scenes(heroes, name, bounce):
    c = heroes[name]
    parts = _random_state(c.data, 16384, 200 + bounce + len(name))
    st = state_from_numpy(bounce, *parts, device="cuda")
    got = cuda_bounce.bounce_bvh(c.data, c.settings, 77, st)
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []


@pytest.mark.cuda
def test_sqrt_and_host_divisions_round_as_ieee_on_the_card(card):
    """vec.sqrt and vec.over on the card give numpy's correctly rounded
    float32 sqrt and division bit for bit, as they do on the CPU
    (tests/test_torch_ops.py), so the plain step rounds both alike on the
    two devices; a host-scalar divisor alone (x / c) is the multiply by its
    reciprocal that vec.over avoids."""
    from lumillyrender_tpu_torch.constants import PI
    from lumillyrender_tpu_torch.ops import vec

    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.integers(0, 0x7F800000, size=1 << 20, dtype=np.int64).astype(np.int32).view(
            np.float32),
        np.array([0.0, -0.0, 1.0, 4.0, np.inf, 1e-45, 3.4e38], np.float32)])
    t = torch.from_numpy(x).to(card)
    for got, want in ((vec.sqrt(t), np.sqrt(x)), (torch.sqrt(t), np.sqrt(x)),
                      (vec.over(t, PI), x / np.float32(PI)),
                      (vec.over(t, 2138 * 1536), x / np.float32(2138 * 1536))):
        assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))
    assert not np.array_equal((t / PI).cpu().numpy(), x / np.float32(PI))


@pytest.mark.cuda
def test_bounce_kernel_ibl_matches_plain(card):
    """The brute-force kernel under an IBL sky (ibl-material)."""
    c = compile_scene_file(ASSETS / "ibl-material.toml", device=card)
    parts = _random_state(c.data, 65536, 11)
    st = state_from_numpy(3, *parts, device=card)
    got = cuda_bounce.bounce(c.data, c.settings, 77, st)
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []


def _perturbed(mats, seed):
    """A second material table: the colours and emissions of `mats` moved
    by up to 20%."""
    import dataclasses

    g = torch.Generator().manual_seed(seed)
    f = lambda t: t * (1.0 + 0.2 * (torch.rand(t.shape, generator=g) - 0.5)).to(t.device)
    return dataclasses.replace(mats, color=f(mats.color), emission=f(mats.emission))


@pytest.mark.cuda
def test_two_table_bounce_kernel_matches_plain(card):
    """The bounce kernel with an evaluation table that differs from the
    sampling table, against the plain step given the same two tables."""
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    me = _perturbed(c.data.materials, 1)
    st = state_from_numpy(3, *_random_state(c.data, 65536, 21), device=card)
    got = cuda_bounce.bounce(c.data, c.settings, 77, st, mats_eval=me)
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st, me)
    same = wavefront.plain_bounce_step(c.data, c.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []
    assert not torch.equal(want.accum, same.accum)


@pytest.mark.cuda
def test_one_table_and_two_equal_tables_agree(card):
    """The kernel loads a hit's row once when it is given one table twice
    (the forward render) and twice when given two; with equal contents both
    give the same bits."""
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    st = state_from_numpy(3, *_random_state(c.data, 65536, 22), device=card)
    tables = cuda_bounce.pack_tables(c.data)
    assert tables["mats_eval"].data_ptr() == tables["mats"].data_ptr()
    one = cuda_bounce.bounce(c.data, c.settings, 77, st, tables)
    two = cuda_bounce.bounce(c.data, c.settings, 77, st,
                             dict(tables, mats_eval=tables["mats"].clone()))
    torch.cuda.synchronize()
    for k in ("o", "d", "throughput", "accum", "alive", "rays_traced"):
        assert torch.equal(getattr(one, k), getattr(two, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["new-cbox", "debug-nee", "primitive"])
def test_bounce_bwd_kernel_matches_plain(card, name):
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    me = _perturbed(c.data.materials, 2)
    n = 4096
    st = state_from_numpy(6, *_random_state(c.data, n, 31), device=card)
    rng = np.random.default_rng(32)
    cot = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(card)
           for _ in range(4)]
    fwd_k = cuda_bounce.bounce(c.data, c.settings, 77, st, mats_eval=me)
    fwd_p = wavefront.plain_bounce_step(c.data, c.settings, 77, st, me)
    _, sp = intersect_shade_brute(st.o, st.d, c.data.geometry)
    keep = parity.bwd_comparable(fwd_p, fwd_k, sp.normal)
    assert keep.mean() > parity.BWD_LIMITS["comparable"]
    cot = [g * torch.from_numpy(keep).to(card)[:, None] for g in cot]
    got = cuda_bounce.bounce_bwd(c.data, c.settings, 77, st, *cot, mats_eval=me,
                                 with_alive=True)
    again = cuda_bounce.bounce_bwd(c.data, c.settings, 77, st, *cot, mats_eval=me)
    want = plain_bounce_bwd(c.data, c.settings, 77, st, *cot, mats_eval=me)
    torch.cuda.synchronize()
    assert torch.equal(got.alive, fwd_k.alive)
    errs = parity.bwd_errors(want, got, keep)
    assert parity.bwd_failures(errs, parity.KERNEL_BWD_RTOL) == []
    for k in ("o", "d", "throughput", "albedo", "emission", "sky"):
        assert torch.equal(getattr(got, k), getattr(again, k)), k


# Every brute-force instance (bounce_body.cuh: the small sweep or the
# general one, Lambert-only or all-family shading, one table or two), forced
# through the tables on scenes it serves: each against the plain step, and
# bit-equal to the general all-family instance on every output (the same
# operations).
INSTANCE_CASES = (
    [("new-cbox", sw, sh, two) for sw in ("small", "general") for sh in ("lambert", "all")
     for two in (False, True)]
    + [("brdf", sw, "all", two) for sw in ("small", "general") for two in (False, True)]
    + [("many-light", "general", sh, two) for sh in ("lambert", "all") for two in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,sweep,shading,two", INSTANCE_CASES,
                         ids=[f"{n}-{sw}-{sh}-{'two' if t else 'one'}"
                              for n, sw, sh, t in INSTANCE_CASES])
def test_bounce_instances_match_plain(card, name, sweep, shading, two):
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    me = _perturbed(c.data.materials, 3) if two else None
    st = state_from_numpy(3, *_random_state(c.data, 65536, 23), device=card)
    tables = dict(cuda_bounce.pack_tables(c.data, mats_eval=me), group=1)
    got = cuda_bounce.bounce(c.data, c.settings, 77, st,
                             dict(tables, instance=cuda_bounce.Instance(sweep, shading)))
    ref = cuda_bounce.bounce(c.data, c.settings, 77, st,
                             dict(tables, instance=cuda_bounce.Instance("general", "all")))
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st, me)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []
    for k in ("o", "d", "throughput", "accum", "alive", "rays_traced"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


@pytest.mark.cuda
def test_small_instance_needs_a_small_scene(card):
    """many-light (256 triangles) takes the general sweep; the small one
    has no prim rows for it and refuses."""
    c = compile_scene_file(ASSETS / "many-light.toml", device=card)
    tables = cuda_bounce.pack_tables(c.data)
    assert cuda_bounce.launch_instance(tables, 256)[0] == cuda_bounce.Instance("general", "lambert")
    assert tables["small"] is None
    st = state_from_numpy(3, *_random_state(c.data, 256, 24), device=card)
    with pytest.raises(ValueError, match="small instance"):
        cuda_bounce.bounce(c.data, c.settings, 77, st,
                           dict(tables, instance=cuda_bounce.Instance("small", "lambert")))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4096])
@pytest.mark.parametrize("group", [4, 16])
@pytest.mark.parametrize("name", ["new-cbox", "brdf"])
def test_group_sweep_matches_one_thread_a_lane(card, name, n, group):
    """GroupIsect (a group of threads per lane splitting the sweep) gives
    every output of one thread a lane bit for bit, on partial warps too,
    with one table and two, Lambert-only and with every family."""
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    st = state_from_numpy(3, *_random_state(c.data, n, 25 + n), device=card)
    for me in (None, _perturbed(c.data.materials, 4)):
        tables = cuda_bounce.pack_tables(c.data, mats_eval=me)
        one = cuda_bounce.bounce(c.data, c.settings, 77, st, dict(tables, group=1))
        grp = cuda_bounce.bounce(c.data, c.settings, 77, st, dict(tables, group=group))
        want = wavefront.plain_bounce_step(c.data, c.settings, 77, st, me)
        torch.cuda.synchronize()
        for k in ("o", "d", "throughput", "accum", "alive", "rays_traced"):
            assert torch.equal(getattr(one, k), getattr(grp, k)), k
        assert parity.failures(parity.agreement(want, grp)) == []


def _bwd_against_plain(c, st, tables, me, seed):
    """The backward kernel with `tables` against plain_bounce_bwd on its
    comparable lanes, within KERNEL_BWD_RTOL; its alive' equal to the
    forward kernel's; two runs bit-equal."""
    n = st.o.shape[0]
    dev = st.o.device
    rng = np.random.default_rng(seed)
    cot = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
           for _ in range(4)]
    fwd_k = cuda_bounce.bounce(c.data, c.settings, 77, st, tables)
    fwd_p = wavefront.plain_bounce_step(c.data, c.settings, 77, st, me)
    _, sp = intersect_shade_brute(st.o, st.d, c.data.geometry)
    keep = parity.bwd_comparable(fwd_p, fwd_k, sp.normal)
    assert keep.mean() > parity.BWD_LIMITS["comparable"]
    cot = [g * torch.from_numpy(keep).to(dev)[:, None] for g in cot]
    got = cuda_bounce.bounce_bwd(c.data, c.settings, 77, st, *cot, tables=tables,
                                 with_alive=True)
    again = cuda_bounce.bounce_bwd(c.data, c.settings, 77, st, *cot, tables=tables)
    want = plain_bounce_bwd(c.data, c.settings, 77, st, *cot, mats_eval=me)
    torch.cuda.synchronize()
    assert torch.equal(got.alive, fwd_k.alive)
    errs = parity.bwd_errors(want, got, keep)
    assert parity.bwd_failures(errs, parity.KERNEL_BWD_RTOL) == []
    for k in ("o", "d", "throughput", "albedo", "emission", "sky"):
        assert torch.equal(getattr(got, k), getattr(again, k)), k
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["small", "general"])
def test_bounce_bwd_kernel_with_few_live_lanes(card, sweep):
    """The training step's tail: 4,096 lanes of which 14 live."""
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    me = _perturbed(c.data.materials, 5)
    parts = list(_random_state(c.data, 4096, 33))
    alive = np.zeros(4096, dtype=bool)
    alive[np.random.default_rng(34).choice(4096, size=14, replace=False)] = True
    parts[4] = alive
    st = state_from_numpy(9, *parts, device=card)
    tables = dict(cuda_bounce.pack_tables(c.data, mats_eval=me),
                  instance=cuda_bounce.Instance(sweep, "lambert"))
    got, _ = _bwd_against_plain(c, st, tables, me, 35)
    assert int(got.alive.sum()) <= 14


@pytest.mark.cuda
def test_bounce_bwd_kernel_on_no_lanes(card):
    """A backward launch of no lanes gives empty cotangents and a zero row
    table (the kernel writes the table only when it has blocks)."""
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    z = np.zeros((0, 3), np.float32)
    st = state_from_numpy(3, z, z, z, z, np.zeros(0, bool), np.zeros(0, np.uint32), device=card)
    cot = [torch.zeros((0, 3), device=card) for _ in range(4)]
    tables = cuda_bounce.pack_tables(c.data)
    rows = torch.full((6 * tables["mats"].shape[0] + 3,), float("nan"), device=card)
    got = cuda_bounce.bounce_bwd(c.data, c.settings, 77, st, *cot, tables=tables)
    cuda_bounce.bounce_bwd_launch(c.data, c.settings, 77, st, cot, tables,
                                  (*(torch.empty((0, 3), device=card) for _ in range(3)), rows,
                                   None))
    torch.cuda.synchronize()
    assert got.o.shape == (0, 3)
    for k in ("albedo", "emission", "sky"):
        assert torch.equal(getattr(got, k), torch.zeros_like(getattr(got, k))), k
    assert torch.equal(rows, torch.zeros_like(rows))


# A Lambert scene of 11 named material rows (the compiler adds one more):
# six quads (12 triangles) and five spheres, one a lamp, each with its own
# row, so that the row table has 6 * 12 + 3 = 75 entries.
MANY_ROWS_SCENE = """
[renderer]
samples = 4
integrator = "pt-direct"
depth = 3
depth-limit = 8

[film]
resolution = [16, 16]
output = "png"

[sky]
type = "uniform"
color = [0.3, 0.4, 0.5]

[camera]
type = "ideal-pinhole"
fov = 45
[[camera.transform]]
type = "look-at"
origin = [0, 4, 12]
target = [0, 2, 0]
up = [0, 1, 0]

[[light]]
type = "area"
object = "lamp"
emission = [8, 7, 6]

[[object]]
name = "lamp"
mesh = "ball"
material = "m0"
[[object.transform]]
type = "translate"
vector = [0, 7, 0]
""" + "".join(f"""
[[object]]
mesh = "quad"
material = "m{k}"
[[object.transform]]
type = "scale"
vector = [3, 3, 3]
[[object.transform]]
type = "translate"
vector = [{(k % 3) * 2 - 2}, {k - 1}, {-(k % 2)}]
""" for k in range(1, 7)) + "".join(f"""
[[object]]
mesh = "ball"
material = "m{k}"
[[object.transform]]
type = "translate"
vector = [{(k - 8) * 1.5}, {(k % 3) + 0.5}, 1]
""" for k in range(7, 11)) + "".join(f"""
[[material]]
name = "m{k}"
type = "lambert"
albedo = [{0.3 + 0.05 * k:.2f}, {0.8 - 0.04 * k:.2f}, 0.5]
""" for k in range(11)) + """
[[mesh]]
name = "quad"
type = "obj"
path = "models/simple/quad.obj"

[[mesh]]
name = "ball"
type = "sphere"
radius = 0.7
"""


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["small", "general"])
def test_bounce_bwd_kernel_past_64_table_entries(card, sweep):
    """Kernel 5 on a Lambert scene whose row table (75 entries) passes 64,
    the per-warp chunk of the earlier kernel."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene
    from lumillyrender_tpu_torch.scene.loader import parse_config

    c = compile_scene(parse_config(MANY_ROWS_SCENE, base_dir=ASSETS), device=card)
    assert c.data.materials.type_id.shape[0] >= 11
    assert cuda_bounce.diff_supported(c.data, c.settings)[0]
    me = _perturbed(c.data.materials, 6)
    tables = cuda_bounce.pack_tables(c.data, mats_eval=me)
    assert cuda_bounce.launch_instance(tables, 16384, backward=True) == (
        cuda_bounce.Instance("small", "lambert"), 1)
    st = state_from_numpy(4, *_random_state(c.data, 16384, 36), device=card)
    got, want = _bwd_against_plain(c, st, dict(tables, instance=cuda_bounce.Instance(
        sweep, "lambert")), me, 37)
    touched = (want.albedo.abs().sum(1) > 0).sum().item()
    assert touched >= 9, touched


@pytest.mark.cuda
def test_raygen_sees_an_in_place_camera_update(card):
    """The raygen kernel's camera argument is cached on the CameraData; an
    in-place update of a camera tensor (an optimizer step) must reach the
    next launch."""
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    n = 4096
    o0, d0, _, _ = cuda_bounce.generate_rays(c.data, c.settings, 5, 0, n)
    with torch.no_grad():
        c.data.camera.position.add_(torch.tensor([3.0, -2.0, 1.0], device=card))
    o, d, _, _ = cuda_bounce.generate_rays(c.data, c.settings, 5, 0, n)
    o_p, d_p, _, _ = cuda_bounce.plain_generate_rays(c.data, c.settings, 5, 0, n)
    torch.cuda.synchronize()
    assert torch.equal(o, o_p)
    assert (d - d_p).abs().max().item() < 2e-7
    assert (d - d0).abs().max().item() > 1e-3


class _PlainCalls:
    """While open (a monkeypatch), counts the plain walk's calls, the plain
    step's and the hybrid's recomputes of a bounce (each of which runs the
    plain step once, for its backward)."""

    def __init__(self, monkeypatch):
        from lumillyrender_tpu_torch.ops import intersect

        self.n = dict(walk=0, step=0, recompute=0)
        for mod, name, key in ((intersect, "_walk_tris", "walk"),
                               (wavefront, "plain_bounce_step", "step"),
                               (cuda_bounce, "recompute", "recompute")):
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _key=key, **k):
                self.n[_key] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, counted)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["welcome-geo", "ibl-material"])
def test_diff_step_runs_the_kernels_on_bvh_and_ibl_scenes(card, name, monkeypatch):
    """make_step_diff takes a BVH scene (welcome-geo: K=32, IBL sky, thin
    lens) and a brute-force IBL scene with every family (ibl-material) on
    the card through the hybrid step: a small film_and_grads launches the
    BVH bounce (welcome-geo) or the brute-force bounce forward, 80 of them,
    kernel 3 twice a bounce in the backward's recompute on welcome-geo (the
    bounce's walk and NEE's), no backward kernel and no raygen; it runs the
    plain step only inside the 80 recomputes and the plain walk never; and
    two runs give the loss, the film and every gradient bit for bit. The
    step runs eagerly (`eager_film_and_grads`), so that its calls are seen;
    film_and_grads's captured plan is held to it below."""
    import dataclasses

    from lumillyrender_tpu_torch.diff import eager_film_and_grads as film_and_grads
    from lumillyrender_tpu_torch.diff import params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves

    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    st = dataclasses.replace(c.settings, width=32, height=24)
    assert cuda_bounce.diff_step_kind(c.data, st, on_card=True) == "hybrid"
    p = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, st, p, 3, 2)
    p = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color * 0.8))
    plain = _PlainCalls(monkeypatch)
    cuda_bounce.reset_counts()
    l1, f1, g1 = film_and_grads(c.data, st, p, target, 3, 2)
    torch.cuda.synchronize()
    launches = cuda_bounce.counts()
    calls = dict(plain.n)
    l2, f2, g2 = film_and_grads(c.data, st, p, target, 3, 2)
    torch.cuda.synchronize()
    fwd = "bounce_bvh" if name == "welcome-geo" else "bounce"
    assert launches[fwd] == 80 and launches["bounce_bwd"] == 0, launches
    assert launches["raygen"] == 0 and launches["bvh_wide"] == launches["bvh_streamed"] == 0
    assert launches["bvh"] == (2 * 80 if name == "welcome-geo" else 0), launches
    assert calls == dict(walk=0, step=80, recompute=80), calls
    assert torch.equal(l1, l2) and torch.equal(f1, f2)
    for a, b in zip(leaves(g1), leaves(g2)):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert g1.materials.color.abs().sum() > 0 and g1.sky.ibl.abs().sum() > 0


@pytest.mark.cuda
def test_fused_off_takes_the_plain_step_with_the_walk_kernel(card, monkeypatch):
    """Under fused="off" welcome-geo's training step (64x48 x 2 spp, 80
    bounces) is autograd of the plain step on the card, its BVH walk kernel
    3: 160 launches in the forward pass under every recompute policy (each
    bounce's walk and NEE's), and in the backward pass 160 under "full",
    none under "hybrid" (its stages are narrow), "isect" and "isect+samp";
    no bounce kernel, the plain walk never; the loss, the film and every
    gradient bit-equal across the four policies."""
    import dataclasses

    from lumillyrender_tpu_torch.diff import params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves, map_params

    c = compile_scene_file(ASSETS / "welcome-geo.toml", device=card)
    st = dataclasses.replace(c.settings, width=64, height=48, fused="off")
    assert cuda_bounce.diff_step_kind(c.data, st, on_card=True) == "plain"
    p = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, st, p, 3, 2)
    p = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color * 0.8))
    plain = _PlainCalls(monkeypatch)
    got = {}
    for mode, backward in (("full", 160), ("hybrid", 0), ("isect", 0), ("isect+samp", 0)):
        live = map_params(p, lambda t: t.detach().requires_grad_(t.is_floating_point()))
        cuda_bounce.reset_counts()
        film = render_diff(c.data, dataclasses.replace(st, bwd_remat=mode), live, 3, 2)
        loss = torch.mean((film - target) ** 2)
        torch.cuda.synchronize()
        forward = cuda_bounce.counts()
        xs = [t for t in leaves(live) if t.requires_grad]
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        torch.cuda.synchronize()
        after = cuda_bounce.counts()
        assert forward == dict(after, bvh=160), (mode, forward)
        assert after["bvh"] - forward["bvh"] == backward, (mode, after)
        assert not any(v for k, v in after.items() if k != "bvh"), (mode, after)
        got[mode] = [loss.detach(), film.detach()] + [
            torch.zeros_like(x) if g is None else g for g, x in zip(grads, xs)]
    assert plain.n["walk"] == 0 and plain.n["recompute"] == 0, plain.n
    for mode, vals in got.items():
        assert all(torch.isfinite(v).all() for v in vals)
        assert all(torch.equal(a, b) for a, b in zip(vals, got["full"])), mode
    assert got["full"][2].abs().sum() > 0  # the colours


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["welcome-geo", "ibl-material"])
def test_hybrid_step_matches_plain_autograd_on_bvh_and_ibl_scenes(card, name):
    """One bounce of make_step_diff's hybrid on a random bounce-3 state of
    65,536 lanes (welcome-geo: the BVH bounce forward, kernel 3 in the
    recompute; ibl-material: the brute-force bounce forward) against
    autograd of the plain step with the plain walk, all on the card: the
    forward under parity.py's lane rules, and the gradients in o, d,
    throughput, the colours, emissions and the IBL texture on the lanes
    `parity.bwd_comparable` keeps (cotangents zeroed on the others) within
    `parity.AUTOGRAD_BWD_RTOL` of each one's largest magnitude; the
    backward's recompute takes the kernel forward's input state, so only
    the walk's VJP (plane equation against autograd of the triangle test)
    and the sums' order differ."""
    from torch_diff_steps import step_grads

    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    n = 1 << 16
    state = state_from_numpy(3, *_random_state(c.data, n, 31), device=card)
    rng = np.random.default_rng(32)
    cot = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(card)
           for _ in range(4)]
    fwd_k = cuda_bounce.make_step(c.data, c.settings, 77)(state)
    fwd_p = wavefront.plain_bounce_step(c.data, c.settings, 77, state)
    m = parity.agreement(fwd_p, fwd_k)
    assert not parity.failures(m), m
    _, sp = intersect_shade(state.o, state.d, c.data.geometry, c.data.bvh,
                            c.settings.intersector, plain=True)
    keep = parity.bwd_comparable(fwd_p, fwd_k, sp.normal)
    assert keep.mean() > parity.BWD_LIMITS["comparable"]
    kt = torch.from_numpy(keep).to(card)[:, None]
    cot = [g * kt for g in cot]
    cuda_bounce.reset_counts()
    _, got = step_grads(lambda live, mats: cuda_bounce.make_step_diff(
        live, c.settings, 77, mats), c.data, c.settings, state, cot)
    torch.cuda.synchronize()
    launches = cuda_bounce.counts()
    _, want = step_grads(lambda live, mats: lambda s: wavefront.plain_bounce_step(
        live, c.settings, 77, s, mats), c.data, c.settings, state, cot)
    torch.cuda.synchronize()
    fwd = "bounce_bvh" if name == "welcome-geo" else "bounce"
    assert launches[fwd] == 1 and launches["bounce_bwd"] == 0, launches
    assert launches["bvh"] == (2 if name == "welcome-geo" else 0), launches
    names = ("o", "d", "throughput", "albedo", "emission", "sky")
    errs = parity.bwd_errors(dict(zip(names, want[:3] + want[4:7])),
                             dict(zip(names, got[:3] + got[4:7])), keep)
    assert not parity.bwd_failures(errs, parity.AUTOGRAD_BWD_RTOL), errs
    assert torch.equal(got[3], want[3])  # accum passes through
    assert want[6].abs().sum() > 0  # the texels the missed lanes read


@pytest.mark.cuda
def test_training_step_runs_the_kernels_and_repeats_bit_for_bit(card):
    """film_and_grads on a small new-cbox: 80 bounce and 80 backward
    launches per step, no raygen, and two runs give the same loss and
    gradients bit for bit (no float atomics on the path)."""
    import dataclasses

    from lumillyrender_tpu_torch.diff import film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves

    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    st = dataclasses.replace(c.settings, width=64, height=64)
    p = params_of(c.data)
    target = render_diff(c.data, st, p, 3, 4).detach()
    p = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color * 0.8))
    cuda_bounce.reset_counts()
    l1, f1, g1 = film_and_grads(c.data, st, p, target, 3, 4)
    launches = cuda_bounce.counts()
    l2, f2, g2 = film_and_grads(c.data, st, p, target, 3, 4)
    torch.cuda.synchronize()
    assert launches["bounce"] == 80 and launches["bounce_bwd"] == 80, launches
    assert launches["raygen"] == 0
    assert torch.equal(l1, l2) and torch.equal(f1, f2)
    for a, b in zip(leaves(g1), leaves(g2)):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert g1.materials.color.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,w,h,spp,sky", [("new-cbox", 64, 64, 4, "color"),
                                             ("ibl-material", 64, 48, 2, "ibl"),
                                             ("welcome-geo", 64, 48, 2, "ibl")])
def test_plan_replays_equal_eager_steps(card, name, w, h, spp, sky):
    """film_and_grads on the card runs a TrainPlan: its first call eager and
    then captured, every later one a replay of the graph. Three calls at new
    seeds, the albedo and the sky (new-cbox's uniform colour, the IBL
    texels) moved between them: each equals the eager step
    (`eager_film_and_grads`) bit for bit, loss, film and every gradient,
    and launches what it launched; the calls after the first are replays
    of one plan."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads, film_and_grads, params_of
    from lumillyrender_tpu_torch.diff import render_diff
    from lumillyrender_tpu_torch.diff.render import clear_plans, kept_plan, leaves

    clear_plans()
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    st = dataclasses.replace(c.settings, width=w, height=h)
    p0 = params_of(c.data)
    target = render_diff(c.data, st, p0, 3, spp).detach()
    for k, seed in enumerate((11, 12, 13)):
        scale = 0.8 + 0.1 * k
        p = p0._replace(
            materials=dataclasses.replace(p0.materials, color=p0.materials.color * scale),
            sky=dataclasses.replace(p0.sky, **{sky: getattr(p0.sky, sky) * (2.0 - scale)}))
        cuda_bounce.reset_counts()
        want = eager_film_and_grads(c.data, st, p, target, seed, spp)
        torch.cuda.synchronize()
        eager = cuda_bounce.counts()
        cuda_bounce.reset_counts()
        got = film_and_grads(c.data, st, p, target, seed, spp)
        torch.cuda.synchronize()
        assert cuda_bounce.counts() == eager
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, b in zip(leaves(got[2]), leaves(want[2])):
            assert torch.isfinite(a).all() and torch.equal(a, b)
        assert getattr(got[2].sky, sky).abs().sum() > 0
    plan = kept_plan()
    assert plan is not None and plan.replays == 2 and plan.graph is not None
    clear_plans()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "isect"])
def test_plain_kind_plan_replays_equal_eager_steps(card, mode):
    """Under fused="off" film_and_grads captures the plain step kind too
    (autograd of the plain step under `bwd_remat`, kernel 3 its walk on
    welcome-geo, 64x48 x 2 spp, 80 bounces): three calls at new seeds and
    albedos, each bit-equal to the eager step with the same launches (320
    kernel 3 launches under "full", 160 under "isect"), the calls after the
    first replays of one plain-kind plan."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads, film_and_grads, params_of
    from lumillyrender_tpu_torch.diff import render_diff
    from lumillyrender_tpu_torch.diff.render import clear_plans, kept_plan, leaves

    clear_plans()
    c = compile_scene_file(ASSETS / "welcome-geo.toml", device=card)
    st = dataclasses.replace(c.settings, width=64, height=48, fused="off", bwd_remat=mode)
    p0 = params_of(c.data)
    target = render_diff(c.data, st, p0, 3, 2).detach()
    for k, seed in enumerate((11, 12, 13)):
        p = p0._replace(materials=dataclasses.replace(
            p0.materials, color=p0.materials.color * (0.8 + 0.1 * k)))
        cuda_bounce.reset_counts()
        want = eager_film_and_grads(c.data, st, p, target, seed, 2)
        torch.cuda.synchronize()
        eager = cuda_bounce.counts()
        cuda_bounce.reset_counts()
        got = film_and_grads(c.data, st, p, target, seed, 2)
        torch.cuda.synchronize()
        assert cuda_bounce.counts() == eager
        assert eager["bvh"] == (320 if mode == "full" else 160), eager
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, b in zip(leaves(got[2]), leaves(want[2])):
            assert torch.isfinite(a).all() and torch.equal(a, b)
        assert got[2].materials.color.abs().sum() > 0
    plan = kept_plan()
    assert plan is not None and plan.kind == "plain" and plan.replays == 2
    clear_plans()


# ---------------------------------------------------------------------------
# The BVH walks (per thread, csrc/bvh.cu; the AOV walks, csrc/bvh_aov.cu) on
# a terrain
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def terrain_bvhs():
    """A 20k-triangle terrain's BVH at K=2, 8, 32 and 128, on the card (K=2
    and 8 take the per-thread kernel's runtime-K instance, K=2 the streamed
    kernel's 4-byte rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of
    from lumillyrender_tpu_torch.scene.terrain import make_terrain

    p0, e1, e2, n = make_terrain(20000)
    return {k: Bvh(**{f: tensor_of(v).cuda() for f, v in build_tri_bvh(
        p0, e1, e2, n, max_leaf=k).items()}) for k in (2, 8, 32, 128)}


def _terrain_rays(bvh, n, seed):
    """_bvh_rays, and camera-like rays from above the terrain towards it."""
    o, d = _bvh_rays(bvh, n, seed)
    rng = np.random.default_rng(seed + 1)
    half = n // 2
    tgt = rng.uniform([-10, -1, -10], [10, 1, 10], size=(n - half, 3)).astype(np.float32)
    oc = np.tile(np.array([[0.0, 8.0, 30.0]], np.float32), (n - half, 1))
    dc = tgt - oc
    dc /= np.linalg.norm(dc, axis=1, keepdims=True)
    o[half:] = torch.from_numpy(oc).cuda()
    d[half:] = torch.from_numpy(dc).cuda()
    return o, d


# The AOV walks, then kernel 3's instances: K=32 and K=128, and the
# runtime-K one at K=8 and K=2.
AOV_WALKS = [(128, cuda_bvh.intersect_tris_wide), (128, cuda_bvh.intersect_tris_streamed),
             (32, cuda_bvh.intersect_tris_streamed), (2, cuda_bvh.intersect_tris_streamed),
             (32, cuda_bvh.intersect_tris), (128, cuda_bvh.intersect_tris),
             (8, cuda_bvh.intersect_tris), (2, cuda_bvh.intersect_tris)]
AOV_IDS = ["wide128", "streamed128", "streamed32", "streamed2", "thread32", "thread128",
           "thread8", "thread2"]


@pytest.mark.cuda
@pytest.mark.parametrize("k,walk", AOV_WALKS, ids=AOV_IDS)
@pytest.mark.parametrize("want_shade", [False, True])
def test_aov_kernels_match_plain_walk(terrain_bvhs, k, walk, want_shade):
    """Every output bit-equal to the plain walk: each lane tests the plain
    walk's leaves in its order against its own best t, slot by slot with a
    strict < (per thread), or the warp keeps the smaller t, then the
    smaller slot (csrc/bvh_warp_walk.cuh)."""
    bvh = terrain_bvhs[k]
    tables = cuda_bvh.tables_of(bvh)
    o, d = _terrain_rays(bvh, 8192 + 77, 11)  # a ragged last warp
    t0 = torch.full((o.shape[0],), INF, device=o.device)
    stop = torch.full_like(t0, -INF)
    got = walk(o, d, t0, stop, tables, want_shade)
    want = _walk_tris(o, d, t0, stop, bvh, want_shade)
    torch.cuda.synchronize()
    assert (want[1] >= 0).float().mean() > 0.3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,walk", AOV_WALKS, ids=AOV_IDS)
def test_aov_kernels_occlusion_and_t_init(terrain_bvhs, k, walk):
    """Capped occlusion queries (t_stop) and pruning from t_init: t and prim
    equal the plain walk's on every lane, so the verdicts do too."""
    bvh = terrain_bvhs[k]
    tables = cuda_bvh.tables_of(bvh)
    o, d = _terrain_rays(bvh, 8192, 12)
    rng = np.random.default_rng(13)
    dist = torch.from_numpy(rng.uniform(0.5, 40.0, size=o.shape[0]).astype(np.float32)).cuda()
    cap = dist + 2.0 * EPS
    stop = cap - 4.0 * EPS
    got = walk(o, d, cap, stop, tables)
    want = _walk_tris(o, d, cap, stop, bvh, False)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int((want[1] >= 0).sum()) < o.shape[0]


@pytest.mark.cuda
def test_aov_wrappers_raise_on_what_they_do_not_take(terrain_bvhs):
    bvh = terrain_bvhs[128]
    tables = cuda_bvh.tables_of(bvh)
    n = 256
    o, d = _terrain_rays(bvh, n, 14)
    t0 = torch.full((n,), INF, device=o.device)
    stop = torch.full_like(t0, -INF)
    out = (torch.empty(n, device=o.device), torch.empty(n, dtype=torch.int32, device=o.device))
    for launch in (cuda_bvh.intersect_tris_wide_launch, cuda_bvh.intersect_tris_streamed_launch,
                   cuda_bvh.intersect_tris_launch):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(o.cpu(), d.cpu(), t0.cpu(), stop.cpu(), tables, out)
        with pytest.raises(ValueError, match="float32"):
            launch(o.double(), d, t0, stop, tables, out)
        with pytest.raises(ValueError, match="contiguous"):
            launch(o[:, :2], d, t0, stop, tables, out)
    with pytest.raises(ValueError, match="128-wide"):
        cuda_bvh.intersect_tris_wide_launch(o, d, t0, stop,
                                            cuda_bvh.tables_of(terrain_bvhs[32]), out)


@pytest.mark.cuda
def test_routing_launches_the_aov_kernels(terrain_bvhs):
    """intersect on a K=128 BVH launches the wide kernel (admitted), the
    streamed one with streamed=True or past the wide cap, and the
    per-thread one on K=32; each count rises by one per launch."""
    from lumillyrender_tpu_torch.ops import intersect as isect
    from lumillyrender_tpu_torch.scene.data import Geometry

    # Only the triangle count and the (absent) spheres of the geometry are read.
    f3 = lambda n: torch.zeros((n, 3), device="cuda")
    i1 = lambda n: torch.zeros(n, dtype=torch.int32, device="cuda")
    geom = Geometry(tri_p0=f3(1), tri_e1=f3(1), tri_e2=f3(1), tri_n=f3(1), tri_mat=i1(1),
                    sph_c=f3(0), sph_r=torch.zeros(0, device="cuda"), sph_mat=i1(0))
    o, d = _terrain_rays(terrain_bvhs[128], 1024, 15)
    cases = [(128, {}, "bvh_wide"), (128, dict(streamed=True), "bvh_streamed"),
             (32, {}, "bvh"), (32, dict(streamed=True, reorder=False), "bvh_streamed")]
    for k, kw, name in cases:
        cuda_bounce.reset_counts()
        hit = isect.intersect_bvh(o, d, geom, terrain_bvhs[k], **kw)
        torch.cuda.synchronize()
        c = cuda_bounce.counts()
        assert c[name] == 1 and sum(c.values()) == 1, (k, kw, c)
        want = _walk_tris(o, d, torch.full((1024,), INF, device="cuda"),
                          torch.full((1024,), -INF, device="cuda"), terrain_bvhs[k], False)
        assert torch.equal(hit.prim, want[1])
    cap = cuda_bvh.WIDE_TABLE_BYTES
    try:
        cuda_bvh.WIDE_TABLE_BYTES = cuda_bvh.wide_table_bytes(terrain_bvhs[128]) - 1
        cuda_bounce.reset_counts()
        isect.intersect_bvh(o, d, geom, terrain_bvhs[128])
        assert cuda_bounce.counts()["bvh_streamed"] == 1
    finally:
        cuda_bvh.WIDE_TABLE_BYTES = cap


TIE_WALKS = [("k128", cuda_bvh.intersect_tris_wide), ("k128x", cuda_bvh.intersect_tris_wide),
             ("k128", cuda_bvh.intersect_tris_streamed),
             ("k128x", cuda_bvh.intersect_tris_streamed),
             ("k32", cuda_bvh.intersect_tris_streamed),
             ("k32x4", cuda_bvh.intersect_tris_streamed),
             ("k8x16", cuda_bvh.intersect_tris_streamed)] + [
    (case, cuda_bvh.intersect_tris) for case in TIE_LAYOUTS]
TIE_WALK_IDS = ["wide-k128", "wide-k128x", "streamed-k128", "streamed-k128x",
                "streamed-k32", "streamed-k32x4", "streamed-k8x16"] + [
    f"thread-{case}" for case in TIE_LAYOUTS]


@pytest.mark.cuda
@pytest.mark.parametrize("case,walk", TIE_WALKS, ids=TIE_WALK_IDS)
def test_aov_walks_on_tie_leaves(card, case, walk):
    """The BVH walks on three identical triangles (TIE_LAYOUTS): at K=128
    with the ties in one lane's slots and across three lanes, the first
    slot in the highest; at K=32 in one leaf and across three leaves; at
    K=8 across three of sixteen leaves. Every output bit-equal to the
    plain walk's, which keeps the first tie slot: prim 0, material row 0,
    triangle 0's normal."""
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    g = c.data.geometry
    bvh = Bvh(**{f: tensor_of(v).cuda() for f, v in tie_bvh(g, case).items()})
    n = 4096 + 7
    o, d = (torch.from_numpy(x).cuda() for x in tie_rays(g, n, 320))
    t0 = torch.full((n,), INF, device=card)
    stop = torch.full_like(t0, -INF)
    before = walk.launches
    got = walk(o, d, t0, stop, cuda_bvh.tables_of(bvh), True)
    want = _walk_tris(o, d, t0, stop, bvh, True)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # The tie is exercised: most aimed lanes win on triangle 0's first slot.
    assert int((got[1][::2] == 0).sum()) > n // 4


PADDED = [("k32x4", (110, 127)), ("k128", (110, 127)), ("k8x16", (40,))]


@pytest.mark.cuda
@pytest.mark.parametrize("case,drop", PADDED, ids=[c for c, _ in PADDED])
@pytest.mark.parametrize("walk", [cuda_bvh.intersect_tris, cuda_bvh.intersect_tris_streamed],
                         ids=["thread", "streamed"])
def test_bvh_walks_skip_live_padding(card, case, drop, walk):
    """Leaves with padding inside and at the end (valid counts 6, 9, 27, 6
    at K=32; 102 at K=128; several leaves of padding only at K=8), every
    padding slot holding the aimed-at tie triangle under prim -1
    (tests/torch_tie_leaves.py::with_live_padding): a walk that read a
    padding slot as a triangle, or a slot past a leaf's count, would take
    it. Every output bit-equal to the plain walk's."""
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    g = c.data.geometry
    bvh = Bvh(**{f: tensor_of(v).cuda() for f, v in with_live_padding(
        tie_bvh(g, case), drop).items()})
    n = 4096 + 5
    o, d = (torch.from_numpy(x).cuda() for x in tie_rays(g, n, 330))
    t0 = torch.full((n,), INF, device=card)
    stop = torch.full_like(t0, -INF)
    got = walk(o, d, t0, stop, cuda_bvh.tables_of(bvh), True)
    want = _walk_tris(o, d, t0, stop, bvh, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[1][::2] == 0).sum()) > n // 4


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["leaves", "ids", "nodes"])
def test_bvh_kernel_raises_on_misaligned_tables(welcome, table):
    """Kernel 3 reads node rows as float4s and, at K=128, leaf and id rows
    four slots a load: a table off 16 bytes raises before any launch, with
    no fallback."""
    tables = dict(cuda_bvh.tables_of(welcome.data.bvh))
    t = tables[table]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    tables[table] = buf[1:].view(t.shape).copy_(t)
    assert tables[table].is_contiguous() and tables[table].data_ptr() % 16
    n = 256
    o, d = _bvh_rays(welcome.data.bvh, n, 6)
    t0 = torch.full((n,), INF, device=o.device)
    out = (torch.empty(n, device=o.device), torch.empty(n, dtype=torch.int32, device=o.device))
    before = cuda_bvh.intersect_tris.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_bvh.intersect_tris_launch(o, d, t0, torch.full_like(t0, -INF), tables, out)
    assert cuda_bvh.intersect_tris.launches == before


@pytest.mark.cuda
def test_hybrid_step_past_the_row_cap_matches_plain_autograd(card):
    """A Lambert-only scene the backward kernel refuses for its rows
    (new-cbox, its material table tiled to BWD_MAX_ROWS + 1 rows) runs on
    the card through make_step_diff's hybrid step: one bounce kernel
    launch, no backward kernel. Its gradients against autograd of the
    plain step on the same state: the per-lane ones bit-equal (the hybrid's
    backward is that autograd, recomputed on the same input state), the
    albedo rows (sums over lanes) within parity.KERNEL_BWD_RTOL of their
    largest magnitude."""
    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    scene = tiled_scene(c.data, cuda_bounce.BWD_MAX_ROWS + 1)
    assert not cuda_bounce.diff_supported(scene, c.settings)[0]
    assert cuda_bounce.hybrid_supported(scene, c.settings)[0]
    n = 16384
    st = state_from_numpy(3, *_random_state(c.data, n, 21), device=card)
    rng = np.random.default_rng(22)
    cot = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(card)
           for _ in range(4)]
    cuda_bounce.reset_counts()
    got = bounce_grads(lambda m: cuda_bounce.make_step_diff(scene, c.settings, 77, m), scene,
                       st, cot)
    torch.cuda.synchronize()
    launches = cuda_bounce.counts()
    want = bounce_grads(
        lambda m: lambda s: wavefront.plain_bounce_step(scene, c.settings, 77, s, m), scene, st,
        cot)
    torch.cuda.synchronize()
    assert launches["bounce"] == 1 and launches["bounce_bwd"] == 0, launches
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert want[3].abs().max() > 0
    assert (got[3] - want[3]).abs().max() <= parity.KERNEL_BWD_RTOL * want[3].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
@pytest.mark.parametrize("k,walk", AOV_WALKS, ids=AOV_IDS)
def test_aov_walks_on_partial_warps(terrain_bvhs, k, walk, n):
    """A launch of n lanes leaves its last warp partial (all of it at 1 and
    31 lanes): the threads past the last ray ask nothing and help test. The
    shade outputs bit-equal to the plain walk's."""
    bvh = terrain_bvhs[k]
    o, d = _terrain_rays(bvh, 2048, 16)
    # Every lane from the camera half, so that most of them hit.
    o, d = o[-n:].contiguous(), d[-n:].contiguous()
    t0 = torch.full((n,), INF, device=o.device)
    stop = torch.full_like(t0, -INF)
    got = walk(o, d, t0, stop, cuda_bvh.tables_of(bvh), True)
    want = _walk_tris(o, d, t0, stop, bvh, True)
    torch.cuda.synchronize()
    assert int((want[1] >= 0).sum()) >= (n + 1) // 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,walk", AOV_WALKS, ids=AOV_IDS)
def test_aov_walks_mix_capped_and_open_lanes(terrain_bvhs, k, walk):
    """In every warp the even lanes ask a capped occlusion query (light on
    the lane's nearest hit where it has one, t_stop 4 EPS below the cap) and
    the odd lanes an open nearest-hit query: a capped lane leaves the walk
    at its first hit under t_stop while its warp goes on. Every output
    bit-equal to the plain walk's, so the verdicts are too."""
    bvh = terrain_bvhs[k]
    tables = cuda_bvh.tables_of(bvh)
    n = 4096
    o, d = _terrain_rays(bvh, n, 17)
    inf = torch.full((n,), INF, device=o.device)
    never = torch.full_like(inf, -INF)
    near = _walk_tris(o, d, inf, never, bvh, False)
    rng = np.random.default_rng(18)
    dist = torch.from_numpy(rng.uniform(0.5, 40.0, size=n).astype(np.float32)).cuda()
    dist = torch.where(near[1] >= 0, near[0], dist)
    capped = torch.arange(n, device=o.device) % 2 == 0
    t0 = torch.where(capped, dist + 2.0 * EPS, inf)
    stop = torch.where(capped, t0 - 4.0 * EPS, never)
    got = walk(o, d, t0, stop, tables, True)
    want = _walk_tris(o, d, t0, stop, bvh, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    verdict = (want[1] >= 0) & ((want[0] - dist).abs() <= EPS)
    assert int(verdict[capped].sum()) > n // 8 and int((want[1][~capped] >= 0).sum()) > n // 8


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3, 7, 70])
def test_bvh_bounce_kernel_at_k128_matches_plain(welcome, bounce):
    """The BVH bounce's warp walk on welcome-geo rebuilt with 128-wide
    leaves, under parity.py's lane rules."""
    import dataclasses

    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    g = welcome.data.geometry
    arrays = build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
        "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")), max_leaf=128)
    scene = dataclasses.replace(welcome.data, bvh=Bvh(**{
        f: tensor_of(v).cuda() for f, v in arrays.items()}))
    parts = _random_state(scene, 16384, 200 + bounce)
    st = state_from_numpy(bounce, *parts, device="cuda")
    got = cuda_bounce.bounce_bvh(scene, welcome.settings, 77, st)
    want = wavefront.plain_bounce_step(scene, welcome.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []



def _bvh_bounce_on_tie_leaves(card, arrays_of, bounce):
    """One BVH bounce on new-cbox with the hand-written BVH
    `arrays_of(geometry)` (tests/torch_tie_leaves.py) against the plain
    step: one kernel launch, every output as the plain step's
    (assert_walks_agree), and many aimed lanes going on from triangle 0's
    plane."""
    import dataclasses

    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    c = compile_scene_file(ASSETS / "new-cbox.toml", device=card)
    g = c.data.geometry
    scene = dataclasses.replace(c.data, bvh=Bvh(**{
        f: tensor_of(v).cuda() for f, v in arrays_of(g).items()}))
    settings = dataclasses.replace(c.settings, intersector="bvh")
    n = 8192
    o, d = tie_rays(g, n, 300 + bounce)
    _, _, thr, acc, alive, lane = _random_state(c.data, n, 310 + bounce)
    st = state_from_numpy(bounce, o, d, thr, acc, alive, lane, device=card)
    before = cuda_bounce.bounce_bvh.launches
    got = cuda_bounce.bounce_bvh(scene, settings, 77, st)
    want = wavefront.plain_bounce_step(scene, settings, 77, st)
    torch.cuda.synchronize()
    assert cuda_bounce.bounce_bvh.launches == before + 1
    assert_walks_agree(want, got)
    # The tie is exercised: many aimed lanes go on from triangle 0's plane.
    on_tie = got.alive[::2] & ((got.o[::2] - g.tri_p0[0]) @ g.tri_n[0]).abs().lt(1e-2)
    assert int(on_tie.sum()) > n // 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TIE_LAYOUTS))
@pytest.mark.parametrize("bounce", [0, 3])
def test_bvh_bounce_kernel_on_tie_leaves(card, case, bounce):
    """The BVH bounce on three identical triangles in one leaf
    (TIE_LAYOUTS): at K=128 the warp walk with the ties in one lane's
    rounds and in three lanes, the first slot in the highest; at K=32 the
    per-thread walk. The first slot's triangle wins, as in the plain step
    (tests/test_torch_bvh.py holds the plain walk and the JAX package's
    walk to that), for the primary and the shadow rays, with dead lanes
    among the live ones."""
    _bvh_bounce_on_tie_leaves(card, lambda g: tie_bvh(g, case), bounce)


@pytest.mark.cuda
@pytest.mark.parametrize("case,drop", PADDED, ids=[c for c, _ in PADDED])
@pytest.mark.parametrize("bounce", [0, 3])
def test_bvh_bounce_kernel_skips_live_padding(card, case, drop, bounce):
    """The BVH bounce on test_bvh_walks_skip_live_padding's leaves: padding
    inside and at the end of leaves, every padding slot holding the
    aimed-at tie triangle under prim -1. At K=32 and K=8 the per-thread
    walk reads each leaf up to its valid count (pack_bvh's `counts`), at
    K=128 the warp walk reads every slot; a walk that took a padding slot,
    or a slot past a leaf's count, for a triangle would differ from the
    plain step, for the primary or the shadow rays."""
    _bvh_bounce_on_tie_leaves(card, lambda g: with_live_padding(tie_bvh(g, case), drop),
                              bounce)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2048 + 13])
@pytest.mark.parametrize("pattern", ["same leaf", "different leaves", "mixed"])
def test_bvh_bounce_kernel_at_k128_warp_patterns(welcome, pattern, n):
    """The warp walk at K=128 on welcome-geo rebuilt with 128-wide leaves,
    on warps whose lanes request the same leaf (one origin, directions a
    hair apart), different leaves (each lane from another leaf's centre)
    or a mix (alternating lanes), with every fifth lane dead; at 2048 + 13
    lanes the last warp runs 13 lanes, which test each leaf's slots with a
    stride of 13."""
    import dataclasses

    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    g = welcome.data.geometry
    arrays = build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
        "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")), max_leaf=128)
    scene = dataclasses.replace(welcome.data, bvh=Bvh(**{
        f: tensor_of(v).cuda() for f, v in arrays.items()}))
    leaf_nodes = np.flatnonzero(arrays["node_leaf"] >= 0)
    centres = (arrays["node_min"][leaf_nodes] + arrays["node_max"][leaf_nodes]) / 2
    rng = np.random.default_rng(400)
    warps = -(-n // 32)
    warp = np.arange(n) // 32
    same_o = centres[rng.integers(0, len(centres), size=warps)][warp]
    same_d = rng.normal(size=(warps, 3))[warp] + rng.normal(scale=1e-4, size=(n, 3))
    perm = np.concatenate([rng.permutation(len(centres)) for _ in range(n // len(centres) + 1)])
    diff_o = centres[perm[:n]]
    diff_d = rng.normal(size=(n, 3))
    pick = {"same leaf": np.ones(n, bool), "different leaves": np.zeros(n, bool),
            "mixed": np.arange(n) % 2 == 0}[pattern]
    o = np.where(pick[:, None], same_o, diff_o).astype(np.float32)
    d = np.where(pick[:, None], same_d, diff_d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    _, _, thr, acc, _, lane = _random_state(scene, n, 401)
    alive = np.arange(n) % 5 != 4
    for bounce in (0, 3):
        st = state_from_numpy(bounce, o, d, thr, acc, alive, lane, device="cuda")
        got = cuda_bounce.bounce_bvh(scene, welcome.settings, 77, st)
        want = wavefront.plain_bounce_step(scene, welcome.settings, 77, st)
        torch.cuda.synchronize()
        assert_walks_agree(want, got)

PROBE_CASES = probes.cases()


@pytest.mark.cuda
@pytest.mark.parametrize("tag,probe,params", PROBE_CASES, ids=[c[0] for c in PROBE_CASES])
def test_probe_kernels_match_plain(card, tag, probe, params):
    """Every capability probe's kernel (csrc/probes.cu) bit-equal to its
    plain version, smem_input at each of its four table sizes."""
    before = probe.launches
    ins = probe.inputs(card, *params)
    got = probe.run(ins)
    want = probe.compute(*ins)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", (None,) + probes.pallas.WALK_TABLES)
def test_walk_kernel_matches_plain_on_seeded_tables(card, pattern):
    """packet_walk_core's kernel (the table streamed through shared memory
    by TMA, votes taken ahead of the walk, every thread walking the vote
    mask) bit-equal to its plain version on the tool's arange table (None)
    and on each seeded table: no row votes, every row votes, votes at the
    kernel's tile edges and in the last 7 rows, votes scattered."""
    probe = probes.pallas.packet_walk_core
    ins = probe.inputs(card, pattern)
    before = probe.launches
    got = probe.run(ins)
    want = probe.compute(*ins)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_dyn_lane_kernel_matches_plain_at_every_lane(card):
    """vmem_dyn_lane reads tab[3, idx] straight from L2: bit-equal at each
    lane 0..127."""
    probe = probes.mosaic.vmem_dyn_lane
    tab, _ = probe.inputs(card)
    before = probe.launches
    for lane in range(128):
        ins = (tab, torch.tensor([[lane]], dtype=torch.int32, device=card))
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), lane
    assert probe.launches == before + 128


@pytest.mark.cuda
def test_rowgather_kernel_matches_plain_on_seeded_rows(card):
    """take_rowgather's 16-byte half-row loads, bit-equal on 128 seeded rows
    with the table's first and last."""
    probe = probes.pallas.take_rowgather
    table8, _ = probe.inputs(card)
    ins = (table8, probes.pallas.seeded_rows(card))
    before = probe.launches
    got = probe.run(ins)
    want = probe.compute(*ins)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("set_name", probes.pallas.INDEX_SETS)
def test_gather_kernels_match_plain_on_index_sets(card, set_name):
    """take_along_axis_axis0's and take_rowgather's kernels (both read L2
    directly) follow JAX's index rule: bit-equal to their plain versions on the
    tools' tables at each seeded index set (negative indices wrap, any
    other out-of-range index gives NaN 0x7fc00000)."""
    for probe, sets in ((probes.pallas.take_along_axis_axis0, probes.pallas.take_along_sets),
                        (probes.pallas.take_rowgather, probes.pallas.take_rows_sets)):
        ins = (probe.inputs(card)[0], sets(card)[set_name])
        before = probe.launches
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert probe.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), probe.name


@pytest.mark.cuda
def test_take_along_kernel_refuses_misaligned_indices_and_output(card):
    """take_along_axis_axis0 reads its table straight from L2 (no shared
    memory) with 16-byte index loads and stores: its entry refuses an index
    array or an output 4 bytes off a 16-byte boundary
    (cudaErrorMisalignedAddress, 716) without a launch, nothing written or
    counted."""
    probe = probes.pallas.take_along_axis_axis0
    assert probe.name in probes.DIRECT_PROBES and probes.static_smem(probe.name) == 0
    table, idx = probe.inputs(card)
    bad_idx = torch.empty(idx.numel() + 1, dtype=torch.int32, device=card)[1:]
    bad_idx = bad_idx.view(idx.shape).copy_(idx)
    bad_out = torch.empty(idx.numel() + 1, dtype=torch.float32, device=card)[1:].view(idx.shape)
    assert bad_idx.data_ptr() % 16 == 4 and bad_out.data_ptr() % 16 == 4
    for ins, out in (((table, bad_idx), probe.outputs(card)[0]), ((table, idx), bad_out)):
        out.fill_(float("nan"))
        before = probe.launches
        with pytest.raises(RuntimeError, match="CUDA error 716"):
            probe.launch(ins, [out])
        torch.cuda.synchronize()
        assert probe.launches == before and torch.isnan(out).all()


@pytest.mark.cuda
def test_direct_probes_declare_no_shared_memory(card):
    """The probes of probes.DIRECT_PROBES (vmem_dyn_sublane_static_lane,
    vmem_dyn_lane, take_along_axis_axis0, take_rowgather, vmem_scalar_dynamic_read,
    ref_ds_row_read, scalar_broadcast, dyn_row_vector_read, smem_input,
    scatter_add; the list chip_smoke.py's phase 20 checks) read their
    inputs straight from L2: the loaded kernels report no static shared
    memory."""
    assert {"scalar_broadcast", "vmem_dyn_sublane_static_lane", "vmem_scalar_dynamic_read",
            "dyn_row_vector_read", "smem_input", "scatter_add"} <= set(probes.DIRECT_PROBES)
    assert {name: probes.static_smem(name) for name in probes.DIRECT_PROBES} \
        == dict.fromkeys(probes.DIRECT_PROBES, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,length", [("vmem_dyn_sublane_static_lane", 16),
                                         ("dyn_row_vector_read", 8)])
def test_in_order_sum_kernels_match_plain_on_seeded_sets(card, name, length):
    """vmem_dyn_sublane_static_lane (16 elements of column 5) and
    dyn_row_vector_read (8 rows, float4 lanes) read straight from L2 and add
    in index order from 0.0f: bit-equal to their plain versions at each of
    128 seeded index sets (repeats, rows 0 and 63) of the seeded table,
    whose first row read holds -0.0; both kernels declare no static shared
    memory."""
    probe = next(p for p in probes.PROBES if p.name == name)
    assert name in probes.DIRECT_PROBES and probes.static_smem(name) == 0
    tab = probes.mosaic.seeded_tab(card)
    sets = probes.mosaic.seeded_index_sets(length, device=card)
    before = probe.launches
    for k, idx in enumerate(sets):
        ins = (tab, idx.contiguous())
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
    assert probe.launches == before + len(sets)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", probes.SMEM_ROWS)
def test_smem_input_kernel_matches_plain_on_seeded_tabs(card, rows):
    """smem_input's kernel (one warp, the 64 elements read straight from L2,
    an in-order sum from +0.0) bit-equal to its plain version on the seeded
    table of each size (-0.0 read first, magnitudes over 2^-24 to 2^24) and
    on a table of -0.0 (+0.0 out); it declares no static shared memory."""
    probe = probes.mosaic.smem_input
    assert probe.name in probes.DIRECT_PROBES and probes.static_smem(probe.name) == 0
    tab = probes.mosaic.seeded_smem_tab(rows, card)
    before = probe.launches
    for t in (tab, torch.full_like(tab, -0.0)):
        got = probe.run((t,))
        want = probe.compute(t)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert probe.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", probes.pallas.SCATTER_SETS)
def test_scatter_kernel_matches_plain_on_seeded_sets(card, name):
    """scatter_add's kernel (one warp counting the hits of rows 0-7, no
    scratch, memset or atomics) bit-equal to its plain version on each
    seeded index set: repeats, counts past 512, negative indices that wrap,
    indices past the table dropped; it declares no static shared memory,
    and its entry refuses indices off 16 bytes (error 716) without a
    launch."""
    probe = probes.pallas.scatter_add
    assert probe.name in probes.DIRECT_PROBES and probes.static_smem(probe.name) == 0
    table = probe.inputs(card)[0]
    idx = probes.pallas.scatter_set(name, card)
    before = probe.launches
    got = probe.run((table, idx))
    want = probe.compute(table, idx)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    off = torch.empty(1025, dtype=torch.int32, device=card)[1:].view(8, 128).copy_(idx)
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        probe.run((table, off))
    assert probe.launches == before + 1


@pytest.mark.cuda
def test_sum4_kernel_matches_plain_on_seeded_sets(card):
    """vmem_scalar_dynamic_read reads its 4 elements straight from L2 (one
    warp, no shared memory) and adds them in index order from 0.0f:
    bit-equal to its plain version at each of 128 seeded index sets of the
    seeded table8 (a repeated index, rows 0 and 2047, -0.0 read first and
    read alone); its kernel declares no static shared memory."""
    probe = probes.pallas.vmem_scalar_dynamic_read
    assert probe.name in probes.DIRECT_PROBES and probes.static_smem(probe.name) == 0
    tab = probes.pallas.sum4_table8(card)
    sets = probes.pallas.sum4_sets(device=card)
    before = probe.launches
    for k, idx in enumerate(sets):
        ins = (tab, idx.contiguous())
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
    assert probe.launches == before + len(sets)


@pytest.mark.cuda
@pytest.mark.parametrize("table", probes.mosaic.LINK_TABLES)
def test_link_walk_kernel_matches_plain_on_seeded_tables(card, table):
    """while_walk_smem's kernel (the walk's cursors by pointer doubling, then
    the adds in walk order) bit-equal to its plain version on each seeded
    link table with seeded rays: the tool's chain, a permutation of all 100
    nodes, a 40-node walk beside a cycle, 0 -> -1 at once (out = rays) and
    a walk ending on -5."""
    probe = probes.mosaic.while_walk_smem
    ins = probe.inputs(card, table)
    before = probe.launches
    got = probe.run(ins)
    want = probe.compute(*ins)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("table", probes.mosaic.CYCLIC_TABLES)
def test_link_walk_kernel_writes_nan_on_a_cyclic_table(card, table):
    """A table whose walk from 0 never ends (a cycle, or a link past the
    table) has no sum: the kernel writes NaN to every element, where the
    plain version would never return."""
    probe = probes.mosaic.while_walk_smem
    got = probe.run(probe.inputs(card, table))
    torch.cuda.synchronize()
    assert torch.isnan(got).all()


@pytest.mark.cuda
def test_link_walk_kernel_refuses_more_than_128_links(card):
    """The kernel holds at most 128 links (four a lane of its warp): a
    table of 129 is refused by the entry (cudaErrorInvalidValue), nothing
    written or counted; 128 links in one chain are walked."""
    probe = probes.mosaic.while_walk_smem
    rays = probes.mosaic.seeded_rays(card)
    for n in (128, 129):
        links = torch.cat([torch.arange(1, n, dtype=torch.int32),
                           torch.tensor([-1], dtype=torch.int32)]).reshape(n, 1).to(card)
        outs = probe.outputs(card)
        outs[0].fill_(float("nan"))
        before = probe.launches
        if n == 128:
            probe.launch((links, rays), outs)
            want = probe.compute(links, rays)
            torch.cuda.synchronize()
            assert torch.equal(outs[0].view(torch.int32), want.view(torch.int32))
            assert probe.launches == before + 1
        else:
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                probe.launch((links, rays), outs)
            torch.cuda.synchronize()
            assert probe.launches == before and torch.isnan(outs[0]).all()


@pytest.mark.cuda
def test_onehot_kernel_matches_plain_on_a_random_table(card):
    """onehot_matmul_gather's cluster kernel (partial sums over 8 K slices,
    combined in rank order) bit-equal to its plain version and to the row
    gather, on a seeded table with no zeros, both signs and full mantissas
    at seeded rows with both ends of it, and on the probe's own inputs."""
    probe = probes.pallas.onehot_matmul_gather
    before = probe.launches
    for ins in ((probes.pallas.seeded_table8(card), probes.pallas.seeded_rows(card)),
                probe.inputs(card)):
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), ins[0][ins[1].long()].view(torch.int32))
    assert probe.launches == before + 2


@pytest.mark.cuda
def test_onehot_kernel_spans_the_card(card):
    """onehot_matmul_gather runs 64 blocks in clusters of 8, all of them at
    once: more than the 8 blocks of its first design."""
    geometry = probes.onehot_geometry()
    assert geometry["grid"] == 64 and geometry["cluster"] == 8
    assert geometry["max_active_clusters"] >= geometry["grid"] // geometry["cluster"]


@pytest.mark.cuda
def test_scalar_broadcast_kernel_matches_plain_on_seeded_rows(card):
    """scalar_broadcast reads table8[i, 3] straight from L2: bit-equal at each
    of 128 seeded rows, 0 and 2047 among them, of the seeded table."""
    probe = probes.pallas.scalar_broadcast
    table8 = probes.pallas.seeded_table8(card)
    rows = probes.pallas.seeded_rows().tolist()
    before = probe.launches
    for i in rows:
        ins = (torch.tensor([i], dtype=torch.int32, device=card), table8)
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), i
    assert probe.launches == before + len(rows)



@pytest.mark.cuda
def test_ref_ds_row_read_kernel_matches_plain_on_seeded_rows(card):
    """ref_ds_row_read reads row i of table8 straight from L2 (two 16-byte
    loads, no shared memory): bit-equal at each of 128 seeded rows, 0 and
    2047 among them, of the seeded table; its kernel declares no static
    shared memory; an output 4 bytes off a 16-byte boundary is refused
    (cudaErrorMisalignedAddress) with nothing written or counted."""
    probe = probes.pallas.ref_ds_row_read
    assert "ref_ds_row_read" in probes.DIRECT_PROBES and probes.static_smem(probe.name) == 0
    table8 = probes.pallas.seeded_table8(card)
    rows = probes.pallas.seeded_rows().tolist()
    assert {0, 2047} <= set(rows)
    before = probe.launches
    for i in rows:
        ins = (torch.tensor([i], dtype=torch.int32, device=card), table8)
        got = probe.run(ins)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), i
    assert probe.launches == before + len(rows)
    buf = torch.empty(8 * 8 + 1, dtype=torch.float32, device=card)
    bad = buf[1:].view(8, 8)
    assert bad.data_ptr() % 16 == 4
    bad.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        probe.launch(ins, [bad])
    torch.cuda.synchronize()
    assert probe.launches == before + len(rows) and torch.isnan(bad).all()

@pytest.mark.cuda
@pytest.mark.parametrize("name,which", [("scalar_broadcast", "out"),
                                        ("onehot_matmul_gather", "table"),
                                        ("dyn_row_vector_read", "out"),
                                        ("dyn_row_vector_read", "table")])
def test_float4_probe_kernels_raise_when_misaligned(card, name, which):
    """scalar_broadcast writes float4s, onehot_matmul_gather reads its table
    as float4s and dyn_row_vector_read does both: a tensor 4 bytes off a
    16-byte boundary is refused by
    the entry (cudaErrorMisalignedAddress), the launch raises, nothing is
    written or counted, and the next aligned launch is right."""
    probe = next(p for p in probes.PROBES if p.name == name)
    ins = probe.inputs(card)
    outs = probe.outputs(card)
    off = ins[0] if which == "table" else outs[0]  # onehot's table is its first input
    buf = torch.empty(off.numel() + 1, dtype=off.dtype, device=card)
    bad = buf[1:].view(off.shape)
    assert bad.data_ptr() % 16 == 4
    if which == "table":
        bad.copy_(off)
        bad_ins, bad_outs = (bad, *ins[1:]), probe.outputs(card)
    else:
        bad_ins, bad_outs = ins, [bad]
    bad_outs[0].fill_(float("nan"))
    before = probe.launches
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        probe.launch(bad_ins, bad_outs)
    torch.cuda.synchronize()
    assert probe.launches == before and torch.isnan(bad_outs[0]).all()
    probe.launch(ins, outs)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), probe.compute(*ins).view(torch.int32))


@pytest.mark.cuda
def test_rowgather_kernel_raises_on_a_misaligned_table(card):
    """A table8 4 bytes off a 16-byte boundary: the entry refuses it
    (cudaErrorMisalignedAddress), the launch raises, nothing is written and
    nothing is counted, and the next launch on an aligned table is right."""
    probe = probes.pallas.take_rowgather
    table8, idx = probe.inputs(card)
    buf = torch.empty(table8.numel() + 1, dtype=torch.float32, device=card)
    buf[1:] = table8.reshape(-1)
    bad = buf[1:].view(2048, 8)
    assert bad.data_ptr() % 16 == 4
    outs = probe.outputs(card)
    outs[0].fill_(float("nan"))
    before = probe.launches
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        probe.launch((bad, idx), outs)
    torch.cuda.synchronize()
    assert probe.launches == before and torch.isnan(outs[0]).all()
    probe.launch((table8, idx), outs)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), probe.compute(table8, idx).view(torch.int32))


LIBRARY_CASES = [(tag, p, params) for tag, p, params in probes.cases() if p.library is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("tag,probe,params", LIBRARY_CASES, ids=[c[0] for c in LIBRARY_CASES])
def test_probe_library_calls_match_plain(card, tag, probe, params):
    """The PyTorch call each probe's kernel is timed against computes the
    same function on the card, bit for bit (smem_input's at each of its
    table sizes: the call reads global memory, which no opt-in limits)."""
    assert probe.library_agrees(probe.inputs(card, *params))


@pytest.mark.cuda
@pytest.mark.parametrize("name,length", [("vmem_dyn_sublane_static_lane", 16),
                                         ("dyn_row_vector_read", 8)])
def test_embedding_bag_matches_plain_on_seeded_sets(card, name, length):
    """The embedding_bag call that vmem_dyn_sublane_static_lane and
    dyn_row_vector_read are timed against, bit-equal to their plain versions
    on the card at each of 128 seeded index sets of the seeded table (the
    first read -0.0): the call starts each bag from 0 and adds in index
    order, in float32."""
    probe = next(p for p in probes.PROBES if p.name == name)
    tab = probes.mosaic.seeded_tab(card)
    for k, idx in enumerate(probes.mosaic.seeded_index_sets(length, device=card)):
        assert probe.library_agrees((tab, idx.contiguous())), k


@pytest.mark.cuda
def test_probe_entry_point_runs_on_the_card(card, capsys):
    from lumillyrender_tpu_torch.probes.__main__ import main

    probes.reset_counts()
    assert main([]) == 0
    # One launch a run: smem_input's four table sizes all run on the card.
    assert probes.counts() == {p.name: sum(q is p for _, q, _ in probes.cases())
                               for p in probes.PROBES}
    assert probes.counts()["smem_input"] == 4
    out = capsys.readouterr().out
    assert out.count("\nOK ") == 26 and "\nFAIL " not in out


# ---------------------------------------------------------------------------
# The forward stage loop captured as a CUDA graph (integrator/render.py)
# ---------------------------------------------------------------------------

STATE_FIELDS = ("o", "d", "throughput", "accum", "alive", "lane", "rays_traced")


def _films_agree(a, b):
    """chip_smoke.check_films' gate: |mean| rel < 1e-4 and 99% of pixels
    within 1e-4 of the film max. Banks after the first add with atomics
    (index_add), so two runs of one loop differ in the last bits."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mean_rel = abs(a.mean() - b.mean()) / b.mean()
    within = (np.abs(a - b) <= 1e-4 * np.abs(b).max()).mean()
    return mean_rel < 1e-4 and within >= 0.99


def _host_loop_chunk(c, step, spp, offset):
    """One chunk as trace_film ran it with the stage loop on the host (one
    read of the card per bounce, stopping where no lane is alive), over the
    same raygen, lane ids, step, `_compact` and banks: (each stage's end
    state, film_flat, rays)."""
    from lumillyrender_tpu_torch.integrator.render import global_lanes, tile_decode
    from lumillyrender_tpu_torch.ops import rng
    from lumillyrender_tpu_torch.ops.intersect import _use_brute

    st = c.settings
    w, h = st.width, st.height
    n, n_pix = w * h * spp, w * h
    o, d, pdf, g = cuda_bounce.generate_rays(c.data, st, SEED_LOOP, offset, n)
    lane = global_lanes(st, offset, n, o.device)
    weight = g * c.data.camera.sensor_sensitivity / pdf
    state = wavefront.PathState(
        0, o, d, torch.ones_like(o) * weight[..., None], torch.zeros_like(o),
        torch.ones(n, dtype=torch.bool, device=o.device),
        torch.zeros((), device=o.device), lane)
    decode = tile_decode(st)

    def to_pixel(lanes):
        lanes = rng.as_u32(lanes) % n_pix
        if decode is None:
            return lanes
        px, py = decode(lanes)
        return py * w + px

    def bank(film, s, ordered):
        if ordered and s.accum.shape[0] % n_pix == 0:
            by_lane = s.accum.reshape(-1, n_pix, 3).sum(dim=0)
            if decode is None:
                return film + by_lane
            return film.index_add(0, to_pixel(torch.arange(n_pix, device=o.device)), by_lane)
        return film.index_add(0, to_pixel(s.lane), s.accum)

    film = torch.zeros((n_pix, 3), device=o.device)
    ends, first = [], True
    plan = wavefront._stage_plan(n, st, aggressive=_use_brute(c.data.geometry, st.intersector))
    for si, (width, _, b1) in enumerate(plan):
        if width != state.alive.shape[0]:
            film = bank(film, state, first)
            first = False
            state = wavefront._compact(state, width, SEED_LOOP, 0x50000000 + si, salt=lane[0])
        while state.bounce < b1 and bool(state.alive.any()):
            state = step(state)
        ends.append(state)
    return ends, bank(film, state, first), state.rays_traced


SEED_LOOP = 1234
# ridaisai at its own film: one 3,283,968-lane chunk, 2x32 tiles.
LOOP_SCENES = [("new-cbox", 64, 64, 4), ("welcome-geo", 64, 48, 4), ("ridaisai", 2138, 1536, 1)]


def _graphed_vs_host_loop(card, monkeypatch, c, spp):
    """A ChunkRenderer's first chunk (eager, then captured) and its second
    (a graph replay) of `c` against the host loop over the same step: each
    stage's end state and the ray count bit-equal, the films within the
    film gate; the replay adds the captured launches (and raygen's) to the
    counts. Returns the renderer's plan."""
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer

    w, h = c.settings.width, c.settings.height
    ends = []
    run_stage = wavefront.run_stage

    def recorded(step, state, b1):
        out = run_stage(step, state, b1)
        ends.append([getattr(out, k).clone() for k in STATE_FIELDS])
        return out

    monkeypatch.setattr(wavefront, "run_stage", recorded)
    renderer = ChunkRenderer(c.data, c.settings, SEED_LOOP, card)
    assert renderer.graphed
    film0, rays0 = renderer.chunk(0, spp)
    stages = len(ends) // 2  # the eager run's, then the capture's
    eager = [[t.clone() for t in e] for e in ends[:stages]]
    cuda_bounce.reset_counts()
    film1, rays1 = renderer.chunk(spp, spp)
    torch.cuda.synchronize()
    replayed = [[t.clone() for t in e] for e in ends[stages:]]
    plan = renderer.plans[spp]
    assert plan.graph is not None
    assert cuda_bounce.counts() == dict(
        {k: 0 for k in cuda_bounce.counts()}, raygen=1, **plan.launches)
    monkeypatch.setattr(wavefront, "run_stage", run_stage)

    step = wavefront.make_bounce_step(renderer.scene, c.settings, SEED_LOOP)
    n = w * h * spp
    for got_ends, film, rays, offset in ((eager, film0, rays0, 0),
                                         (replayed, film1, rays1, spp)):
        want_ends, want_film, want_rays = _host_loop_chunk(c, step, spp, offset)
        assert len(got_ends) == len(want_ends) == stages
        for got, want in zip(got_ends, want_ends):
            for k, t in zip(STATE_FIELDS, got):
                assert torch.equal(t, getattr(want, k)), (offset, k)
        assert torch.equal(rays, want_rays + float(n))
        assert _films_agree(film.reshape(-1, 3).cpu(), want_film.cpu())
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("name,w,h,spp", LOOP_SCENES, ids=[s[0] for s in LOOP_SCENES])
def test_graphed_stage_loop_matches_the_host_loop(card, monkeypatch, name, w, h, spp):
    """A ChunkRenderer's first chunk (eager, then captured) and its second
    (a graph replay) against the host loop over the same kernels: each
    stage's end state (o, d, throughput, accum, alive, lane) and the ray
    count bit-equal, the films within the film gate; the replay adds the
    captured launches to the counts."""
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    c.settings = dataclasses.replace(c.settings, width=w, height=h)
    plan = _graphed_vs_host_loop(card, monkeypatch, c, spp)
    assert plan.launches["bounce" if name == "new-cbox" else "bounce_bvh"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,w,h,spp", LOOP_SCENES[:2], ids=[s[0] for s in LOOP_SCENES[:2]])
def test_fused_off_chunk_plan_matches_the_host_loop(card, monkeypatch, name, w, h, spp):
    """Under fused="off" a chunk is a captured ForwardPlan too, of the plain
    step's PyTorch ops (its walk kernel 3 on welcome-geo): the first chunk
    and a replay bit-equal to the host loop over the plain step, as the
    kernels' plan is; no bounce kernel in the graph."""
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    c.settings = dataclasses.replace(c.settings, width=w, height=h, fused="off")
    plan = _graphed_vs_host_loop(card, monkeypatch, c, spp)
    assert not plan.launches.get("bounce") and not plan.launches.get("bounce_bvh")
    assert (plan.launches.get("bvh", 0) > 0) == (name == "welcome-geo"), plan.launches


@pytest.mark.cuda
def test_render_reads_nothing_from_the_card_inside_a_chunk(card, monkeypatch):
    """A four-chunk render under set_sync_debug_mode("error") from its
    second chunk up to the final copy of the film: no chunk reads the card."""
    import dataclasses
    import sys

    from lumillyrender_tpu_torch.integrator import render as render_mod

    c = compile_scene_file(ASSETS / "new-cbox.toml", spp=8, device=card)
    c.settings = dataclasses.replace(c.settings, width=64, height=64)
    chunk, cpu = render_mod.ChunkRenderer.chunk, torch.Tensor.cpu
    seen = {"chunks": 0, "copies": []}

    def counted_chunk(self, offset, spp):
        seen["chunks"] += 1
        if seen["chunks"] == 2:
            torch.cuda.set_sync_debug_mode("error")
        return chunk(self, offset, spp)

    def final_copy(self, *args, **kwargs):
        if seen["chunks"] >= 2:  # the first chunk reads the camera, once
            seen["copies"].append((sys._getframe(1).f_code.co_name, seen["chunks"]))
            torch.cuda.set_sync_debug_mode(0)
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(render_mod.ChunkRenderer, "chunk", counted_chunk)
    monkeypatch.setattr(torch.Tensor, "cpu", final_copy)
    try:
        result = render_mod.render(c, seed=SEED_LOOP, spp_chunk=2, device=card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert seen["chunks"] == 4 and seen["copies"][0] == ("render", 4)
    assert np.isfinite(result.film).all() and result.film.max() > 0


@pytest.mark.cuda
def test_resume_on_the_card(card, tmp_path):
    """8 spp at chunk 2 against 4 spp, checkpointed, then resumed to 8."""
    import dataclasses

    from lumillyrender_tpu_torch.integrator.render import render
    from lumillyrender_tpu_torch.utils import checkpoint as ckpt

    def scene(spp):
        c = compile_scene_file(ASSETS / "new-cbox.toml", spp=spp, device=card)
        c.settings = dataclasses.replace(c.settings, width=64, height=64)
        return c

    ref = render(scene(8), seed=SEED_LOOP, spp_chunk=2, device=card)
    ck = tmp_path / "r.ckpt.npz"
    render(scene(4), seed=SEED_LOOP, spp_chunk=2, device=card, checkpoint=str(ck))
    assert ckpt.load(ck, scene(8).settings, SEED_LOOP)[1] == 4
    resumed = render(scene(8), seed=SEED_LOOP, spp_chunk=2, device=card, checkpoint=str(ck))
    assert resumed.rays == ref.rays
    assert _films_agree(resumed.film, ref.film)


@pytest.mark.cuda
def test_raygen_omnidirectional_matches_plain(card):
    """vr.toml's omnidirectional camera: the kernel's equirect branch
    against camera.sample_rays; random bits and origins exact, directions
    within 2e-7 plus the card's sinf/cosf against PyTorch's (1e-6), and
    g = pdf = 1 on both sides."""
    c = compile_scene_file(ASSETS / "vr.toml", device=card)
    n = c.settings.width * c.settings.height * 4
    uni = torch.empty((n, 4), dtype=torch.float32, device=card)
    o, d, pdf, g = cuda_bounce.generate_rays(c.data, c.settings, 5, 8, n, uniforms=uni)
    o_p, d_p, pdf_p, g_p = cuda_bounce.plain_generate_rays(c.data, c.settings, 5, 8, n)
    torch.cuda.synchronize()
    assert cuda_bounce.counts()["raygen"] >= 1
    assert torch.equal(o, o_p)
    assert (d - d_p).abs().max().item() < 1e-6
    assert torch.equal(pdf, pdf_p) and torch.equal(g, g_p) and bool((g == 1).all())


def _simple_sky(c):
    """`c` under a simple sky with a horizon colour that is not zero."""
    import dataclasses

    from lumillyrender_tpu_torch.scene.data import SKY_SIMPLE

    dev = c.data.sky.color.device
    c.data = dataclasses.replace(c.data, sky=dataclasses.replace(
        c.data.sky, color=torch.tensor([0.1, 0.2, 0.9], device=dev),
        color2=torch.tensor([0.9, 0.8, 0.7], device=dev)))
    c.settings = dataclasses.replace(c.settings, sky_kind=SKY_SIMPLE)
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel", [("new-cbox", "bounce"), ("welcome-geo", "bounce_bvh")])
@pytest.mark.parametrize("bounce", [0, 7])
def test_simple_sky_bounce_kernels_match_plain(card, name, kernel, bounce):
    """Kernels 2 and 4 under the simple sky against the plain step."""
    c = _simple_sky(compile_scene_file(ASSETS / f"{name}.toml", device=card))
    st = state_from_numpy(bounce, *_random_state(c.data, 65536, 40 + bounce), device=card)
    got = getattr(cuda_bounce, kernel)(c.data, c.settings, 77, st)
    want = wavefront.plain_bounce_step(c.data, c.settings, 77, st)
    torch.cuda.synchronize()
    m = parity.agreement(want, got)
    assert parity.failures(m) == [], m
    missed = ~want.alive & st.alive
    assert bool(missed.any())  # lanes that escaped to the sky


@pytest.mark.cuda
def test_render_sharded_on_one_rank_is_render(card):
    """A world-size-1 NCCL group: render_sharded's ray count bit-equal to
    `render`'s in chunks of the same size, with the same launches, and its
    film within 1e-5 of the film's max (the forward banks add with atomics,
    so two runs of `render` itself may differ in the last bits)."""
    import dataclasses
    import socket

    from lumillyrender_tpu_torch.integrator.render import render
    from lumillyrender_tpu_torch.parallel import shard

    c = compile_scene_file(ASSETS / "new-cbox.toml", spp=8, device=card)
    c.settings = dataclasses.replace(c.settings, width=64, height=64)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert shard.init_distributed(f"127.0.0.1:{port}", 1, 0, device=card)
    try:
        cuda_bounce.reset_counts()
        got = shard.render_sharded(c, seed=SEED_LOOP, spp_per_device=2, device=card)
        sharded_counts = cuda_bounce.counts()
    finally:
        shard.dist.destroy_process_group()
    cuda_bounce.reset_counts()
    want = render(c, seed=SEED_LOOP, spp_chunk=2, device=card)
    assert cuda_bounce.counts() == sharded_counts and sharded_counts["bounce"] > 0
    assert got.world == 1 and got.reduce_ms is not None
    assert got.rays == want.rays
    assert np.abs(got.film - want.film).max() <= 1e-5 * max(1.0, np.abs(want.film).max())


@pytest.fixture
def threefry(monkeypatch):
    from lumillyrender_tpu_torch.ops import rng

    monkeypatch.setattr(rng, "_MIXER", "threefry")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["new-cbox", "ibl-material"])
def test_raygen_threefry_instance_matches_plain(card, threefry, name):
    """Kernel 1's threefry instance (LLR_RNG=threefry) against
    `plain_generate_rays` under the same mixer: its random words bit-equal,
    on lanes that wrap past 2^32 (the ideal pinhole of new-cbox, the thin
    lens of ibl-material)."""
    from lumillyrender_tpu_torch.integrator.render import global_lanes
    from lumillyrender_tpu_torch.ops import rng

    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    st = c.settings
    n = 2 * st.width * st.height
    off = 2**32 // (st.width * st.height) - 1  # lanes from 2^32 - w*h on
    uni = torch.empty((n, 4), dtype=torch.float32, device=card)
    o, d, pdf, g = cuda_bounce.generate_rays(c.data, st, 0xFFFFFFFF, off, n, uniforms=uni)
    o_p, d_p, pdf_p, g_p = cuda_bounce.plain_generate_rays(c.data, st, 0xFFFFFFFF, off, n)
    want = torch.stack(rng.uniform4(0xFFFFFFFF, global_lanes(st, off, n, card), 0x40000000), 1)
    torch.cuda.synchronize()
    assert torch.equal(uni.view(torch.int32), want.view(torch.int32))
    rng._MIXER = "pcg4d"
    pcg = torch.stack(rng.uniform4(0xFFFFFFFF, global_lanes(st, off, n, card), 0x40000000), 1)
    assert (uni != pcg).float().mean() > 0.99
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
    assert max(rel(o, o_p), rel(d, d_p), rel(g, g_p), rel(pdf, pdf_p)) <= 1e-5


# Kernel 1's four camera kinds: (scene, camera kind); the realistic pinhole
# is ibl-material's thin-lens camera drawn as CAM_PINHOLE.
RAYGEN_KINDS = {"ideal pinhole": ("new-cbox", 0), "thin lens": ("ibl-material", 1),
                "omnidirectional": ("vr", 2), "realistic pinhole": ("ibl-material", 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["tiles", "raster"])
@pytest.mark.parametrize("kind", list(RAYGEN_KINDS))
@pytest.mark.parametrize("mixer", ["pcg4d", "threefry"])
def test_raygen_instances_match_plain_for_every_camera(card, monkeypatch, mixer, kind, order):
    """Both instances of kernel 1 (pcg4d, threefry) against
    `plain_generate_rays` for each camera kind, in tile order (the scene's
    own film) and in raster order (a 100 x 75 film, whose dims give no 8 x 8
    tile), on 2 w h lanes from the sample offset whose lane ids pass 2^32:
    the random words, o, d, pdf and g bit-equal (the plain version divides
    by the film's dims as IEEE divisions, as the kernel does)."""
    import dataclasses

    from lumillyrender_tpu_torch.integrator.render import global_lanes, tile_dims
    from lumillyrender_tpu_torch.ops import rng

    monkeypatch.setattr(rng, "_MIXER", mixer)
    name, cam = RAYGEN_KINDS[kind]
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    st = dataclasses.replace(c.settings, camera_kind=cam)
    if order == "raster":
        st = dataclasses.replace(st, width=100, height=75)
    assert (tile_dims(st) is None) == (order == "raster")
    n = 2 * st.width * st.height
    off = 2**32 // (st.width * st.height) - 1
    uni = torch.empty((n, 4), dtype=torch.float32, device=card)
    got = cuda_bounce.generate_rays(c.data, st, 0x9E3779B9, off, n, uniforms=uni)
    want = cuda_bounce.plain_generate_rays(c.data, st, 0x9E3779B9, off, n)
    words = torch.stack(rng.uniform4(0x9E3779B9, global_lanes(st, off, n, card), 0x40000000), 1)
    torch.cuda.synchronize()
    assert torch.equal(uni.view(torch.int32), words.view(torch.int32))
    for what, a, b in zip(("o", "d", "pdf", "g"), got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what


@pytest.mark.cuda
@pytest.mark.parametrize("mixer", ["pcg4d", "threefry"])
def test_raygen_writes_a_partial_last_block(card, monkeypatch, mixer):
    """Kernel 1 on 1,000 lanes (a last block of 232, a last warp of 8) of
    the thin lens: o, d and g bit-equal to `plain_generate_rays`, and
    nothing written past the last row."""
    from lumillyrender_tpu_torch.ops import rng

    monkeypatch.setattr(rng, "_MIXER", mixer)
    c = compile_scene_file(ASSETS / "ibl-material.toml", device=card)
    st, n = c.settings, 1000
    want = cuda_bounce.plain_generate_rays(c.data, st, 11, 3, n)
    bufs = [torch.full((3 * n + 4,), -7.0, device=card) for _ in range(2)]
    o, d = (b[:3 * n].view(n, 3) for b in bufs)
    g = torch.empty(n, device=card)
    cuda_bounce.raygen_launch(c.data, st, 11, 3, o, d, g)
    torch.cuda.synchronize()
    for what, a, b in (("o", o, want[0]), ("d", d, want[1]), ("g", g, want[3])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    assert all((b[3 * n:] == -7.0).all() for b in bufs)


@pytest.mark.cuda
def test_threefry_renders_with_the_plain_step_and_refuses_the_kernels(card, threefry):
    """Under threefry the card refuses the bounce kernels before it packs a
    table; `fused="off"` renders with kernel 1's threefry instance and the
    plain step (no bounce kernel), its chunks one captured graph, as the
    CPU renders."""
    import dataclasses

    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, render

    c = compile_scene_file(ASSETS / "new-cbox.toml", spp=4, device=card)
    c.settings = dataclasses.replace(c.settings, width=32, height=32)
    with pytest.raises(ValueError, match=r"LLR_RNG=threefry.*--fused off"):
        ChunkRenderer(c.data, c.settings, 3, card)
    off = dataclasses.replace(c, settings=dataclasses.replace(c.settings, fused="off"))
    cuda_bounce.reset_counts()
    film = render(off, seed=3, spp_chunk=2, device=card).film
    launches = cuda_bounce.counts()
    assert launches["raygen"] == off.settings.spp // 2
    assert not any(v for k, v in launches.items() if k != "raygen"), launches
    assert ChunkRenderer(off.data, off.settings, 3, card).graphed
    assert np.isfinite(film).all() and film.max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 16, 24, 48, 64])
@pytest.mark.parametrize("bounce", [0, 3])
def test_bvh_kernels_at_other_leaf_widths(welcome, k, bounce):
    """welcome-geo rebuilt at LLR_TREELET_K = k: kernel 4 (the per-thread
    walk up to K=32 in its runtime-K instance, the warp walk above it, K=64
    two slots a lane) against the plain step under parity.py's lane rules,
    and kernel 3 (its runtime-K instance) bit-equal to the plain walk. K=24
    and K=48 divide no 128."""
    import dataclasses

    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    g = welcome.data.geometry
    arrays = build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
        "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")), max_leaf=k)
    scene = dataclasses.replace(welcome.data, bvh=Bvh(**{
        f: tensor_of(v).cuda() for f, v in arrays.items()}))
    assert cuda_bounce.bounce_supported(scene, welcome.settings) == (True, "")
    parts = _random_state(scene, 16384, 300 + k + bounce)
    st = state_from_numpy(bounce, *parts, device="cuda")
    got = cuda_bounce.bounce_bvh(scene, welcome.settings, 77, st)
    want = wavefront.plain_bounce_step(scene, welcome.settings, 77, st)
    torch.cuda.synchronize()
    assert parity.failures(parity.agreement(want, got)) == []
    o, d = _bvh_rays(scene.bvh, 4096, 40 + k)
    inf = torch.full((o.shape[0],), INF, device="cuda")
    never = torch.full_like(inf, -INF)
    tables = cuda_bvh.tables_of(scene.bvh)
    for a, b in zip(cuda_bvh.intersect_tris(o, d, inf, never, tables, True),
                    _walk_tris(o, d, inf, never, scene.bvh, True)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_white_furnace_through_the_kernels_at_full_width(card):
    """tests/test_render.py's white furnace through kernels 1 and 2: within
    1e-3 of 1 at the test's 48^2 x 8 spp; at one full chunk (256^2 x 32
    spp, 2,097,152 lanes) every pixel on the 32-sample lattice and the
    samples trapped inside the sphere under tg.FURNACE_LOST_SHARE of them
    (the JAX package loses 7 there, the CPU plain path 6)."""
    from tools import torch_oracle_gate as tg

    from lumillyrender_tpu_torch.integrator.render import render

    film = render(tg.furnace_scene(1.0, device="cuda"), seed=3, device="cuda").film
    assert np.abs(film - 1.0).max() < 1e-3
    c = tg.furnace_scene(1.0, spp=32, device="cuda", width=256, height=256)
    cuda_bounce.reset_counts()
    film = render(c, seed=3, device="cuda").film
    launches = cuda_bounce.counts()
    assert launches["raygen"] == 1 and launches["bounce"] > 0, launches
    lattice_max, lost = tg.furnace_lost_samples(film, 32)
    assert lattice_max < 1e-3 and lost < tg.FURNACE_LOST_SHARE * 256 * 256 * 32, lost


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pt-spheres", "mesh-thinlens"])
def test_oracle_gate_through_the_kernels(card, name):
    """The oracle gate at the CI size (16^2 x 24 spp, seeds 9000-9005)
    through kernels 1 and 2 against the committed CI stack (oracle seeds
    100-105): tests/test_oracle.py's bounds."""
    from tools import torch_oracle_gate as tg

    c = tg.sized_scenes("ci", "cuda", (name,))[name]
    cuda_bounce.reset_counts()
    r = tg.run_gate(name, c, tg.SIZES["ci"]["seeds"], "cuda", "ci")
    launches = cuda_bounce.counts()
    assert launches["bounce"] > 0 and launches["bounce_bvh"] == 0, launches
    assert r["frac_abs_z_gt5"] <= 2 / 256 and r["frac_untestable"] < 0.45, r
    assert r["rel_mean_diff"] < 0.06 and r["passed"], r


def _counted_fd(scene, settings, case):
    """tools/torch_grad_gates.py's fd_vs_ad on the card with the launch
    counts zeroed just before and read just after: (reading, counts)."""
    from tools import torch_grad_gates as gg

    assert cuda_bounce.diff_step_kind(scene, settings, on_card=True) == "hybrid"
    cuda_bounce.reset_counts()
    reading = gg.fd_vs_ad(scene, settings, {"case": case}, "cuda")["case"]
    torch.cuda.synchronize()
    return reading, cuda_bounce.counts()


@pytest.mark.cuda
def test_hybrid_fd_through_the_bounce_kernel_on_ibl_material(card):
    """ibl-material's GGX roughness (tools/torch_grad_gates.py's
    IBL_MATERIAL_FD, which tests/test_torch_grad_gates.py holds on the CPU)
    through make_step_diff's hybrid on the card: kernel 2 forward, autograd
    of the plain step recomputed backward, no backward kernel and no BVH
    bounce."""
    from tools import torch_grad_gates as gg

    c = compile_scene_file(ASSETS / "ibl-material.toml", device=card)
    w, h, spp, bounces = gg.IBL_MATERIAL_SIZE
    st = dataclasses.replace(c.settings, width=w, height=h, spp=spp, max_bounces=bounces)
    reading, n = _counted_fd(c.data, st, gg.IBL_MATERIAL_FD["ggx alpha"])
    assert reading["ok"], reading
    assert n["bounce"] > 0 and n["bounce_bwd"] == 0 and n["bounce_bvh"] == 0, n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["glossy alpha", "glossy reflectance"])
def test_hybrid_fd_through_the_bvh_bounce_kernel_on_welcome(card, case):
    """welcome's GGX bunny (row 0) under a camera it fills
    (tools/torch_grad_gates.py's view_of_rows, 64x48 x 4 spp, the scene's
    own depth) through make_step_diff's hybrid on the card: kernel 4
    forward, kernel 3 the recompute's walk, no brute-force bounce."""
    from tools import torch_grad_gates as gg

    c = compile_scene_file(ASSETS / "welcome.toml", device=card)
    scene, st = gg.view_of_rows(c.data, c.settings, gg.bunny_rows(c.data), 64, 48, 4)
    reading, n = _counted_fd(scene, st, gg.WELCOME_FD[case])
    assert reading["ok"], reading
    assert n["bounce_bvh"] > 0 and n["bvh"] > 0 and n["bounce"] == 0, n


# ---------------------------------------------------------------------------
# The AOV chunks as captured plans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_terrain(tmp_path_factory):
    """scene/terrain.py's terrain at 20,000 triangles under its framing
    camera (64x64 x 4 spp pt-direct) on the card, its BVH rebuilt with
    128-wide leaves (terrain-1m's and terrain-1.5m's layout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.scene import terrain
    from lumillyrender_tpu_torch.scene.compiler import compile_scene
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of
    from lumillyrender_tpu_torch.scene.loader import parse_config

    d = tmp_path_factory.mktemp("terrain")
    terrain.write_obj(d / "terrain.obj", *terrain.make_terrain(20000)[:3])
    c = compile_scene(parse_config(terrain.terrain_scene_toml(
        resolution=(64, 64), samples=4, **terrain.TERRAIN_VIEW), base_dir=d), device="cuda")
    g = c.data.geometry
    arrays = build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
        "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")), max_leaf=128)
    bvh = Bvh(**{f: tensor_of(v).cuda() for f, v in arrays.items()})
    return dataclasses.replace(c, data=dataclasses.replace(c.data, bvh=bvh))


def _streamed_route(monkeypatch, bvh):
    """Lower the wide cap below `bvh`'s tables: its K=128 walk takes the
    streamed route, as terrain-1.5m's does at the JAX package's cap."""
    from lumillyrender_tpu_torch.ops.intersect import bvh_route

    monkeypatch.setattr(cuda_bvh, "WIDE_TABLE_BYTES", cuda_bvh.wide_table_bytes(bvh) - 1)
    assert bvh_route(bvh) == ("streamed", False)


# (scene, AOV, the walk a chunk launches, LLR_REORDER=1): kernels 3, 7 and
# 6, and kernel 3 on sorted rays.
AOV_PLAN_CASES = [("welcome-geo", "depth", "bvh", False), ("welcome-geo", "normal", "bvh", False),
                  ("terrain", "depth", "bvh_wide", False),
                  ("terrain", "normal", "bvh_streamed", False),
                  ("welcome-geo", "depth", "bvh", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,integrator,walk,reorder", AOV_PLAN_CASES,
                         ids=[f"{a}-{b}-{c}" + ("-reorder" if r else "")
                              for a, b, c, r in AOV_PLAN_CASES])
def test_aov_chunk_plan_matches_the_eager_chunk(welcome, small_terrain, monkeypatch, name,
                                                integrator, walk, reorder):
    """A ChunkRenderer's AOV chunk on the card is a captured plan: its first
    call (eager, then captured) and a replay at the next offset each give
    the eager chunk's film and rays bit for bit, with the same launches
    (raygen and the walk once each), the counts zeroed just before and
    read just after each call; under LLR_REORDER=1 the sort is in the
    graph."""
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer
    from lumillyrender_tpu_torch.ops.intersect import bvh_route

    if reorder:
        monkeypatch.setenv("LLR_REORDER", "1")
    c = welcome if name == "welcome-geo" else small_terrain
    if walk == "bvh_streamed":
        _streamed_route(monkeypatch, c.data.bvh)
    route = {"bvh": "thread", "bvh_wide": "wide", "bvh_streamed": "streamed"}[walk]
    assert bvh_route(c.data.bvh)[0] == route
    st = dataclasses.replace(c.settings, width=64, height=48 if name == "welcome-geo" else 64,
                             integrator=integrator)
    spp = 4
    planned = ChunkRenderer(c.data, st, 5, "cuda")
    eager = ChunkRenderer(c.data, st, 5, "cuda")
    eager.graphed = False
    assert planned.graphed
    want = dict({k: 0 for k in cuda_bounce.counts()}, raygen=1, **{walk: 1})
    for offset in (0, spp):
        got = []
        for r in (eager, planned):
            cuda_bounce.reset_counts()
            film, rays = r.chunk(offset, spp)
            torch.cuda.synchronize()
            got.append((film, rays, cuda_bounce.counts()))
        (f_e, r_e, l_e), (f_p, r_p, l_p) = got
        assert torch.equal(f_e, f_p) and torch.equal(r_e, r_p), offset
        assert l_e == l_p == want, (offset, l_e, l_p)
        assert f_p.abs().sum() > 0
    plan = planned.plans[spp]
    assert plan.graph is not None and plan.launches == {walk: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["depth", "normal"])
def test_eager_aov_films_repeat_bit_for_bit(welcome, monkeypatch, integrator):
    """Two eager AOV renders of welcome-geo (8 spp a pixel a chunk, every
    chunk eager) give the same film bit for bit: the ordered bank adds no
    two values into a row with atomics."""
    from lumillyrender_tpu_torch.integrator import render as render_mod

    c = dataclasses.replace(welcome, settings=dataclasses.replace(
        welcome.settings, width=64, height=48, spp=16, integrator=integrator))
    monkeypatch.setattr(render_mod, "captures_chunks", lambda device: False)
    films = [render_mod.render(c, seed=9, spp_chunk=8, device="cuda").film for _ in range(2)]
    assert np.array_equal(films[0], films[1]) and films[0].max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
def test_bvh_bounce_kernel_on_a_streamed_route_terrain(small_terrain, monkeypatch, bounce):
    """Kernel 4 at K=128 on a terrain whose walk the route sends to the
    streamed kernel (terrain-1.5m's case): against the `fused="off"` step,
    whose queries take kernel 6, under parity.py's lane rules."""
    scene, st = small_terrain.data, small_terrain.settings
    _streamed_route(monkeypatch, scene.bvh)
    state = state_from_numpy(bounce, *_random_state(scene, 16384, 500 + bounce), device="cuda")
    cuda_bounce.reset_counts()
    got = cuda_bounce.bounce_bvh(scene, st, 77, state)
    want = wavefront.plain_bounce_step(scene, st, 77, state, plain_walk=False)
    torch.cuda.synchronize()
    n = cuda_bounce.counts()
    assert n["bounce_bvh"] == 1 and n["bvh_streamed"] >= 1 and n["bvh_wide"] == 0, n
    assert parity.failures(parity.agreement(want, got)) == []
