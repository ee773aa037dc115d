"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card (this file imports no
JAX, so it runs on a machine that has only PyTorch). Run them there with
`python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q`. Here
the kernels run at a few thousand lanes; chip_smoke.py makes the same
comparisons at the main paths' own widths: the brute-force bounce on
new-cbox at 2,097,152 lanes and on every launch of one chunk (2,097,152,
32,768 and 4,096 lanes), the BVH kernels on welcome-geo at 2,072,576 lanes
and on every launch of one chunk (2,072,576, 259,072, 32,512 and 4,096
lanes).

Tolerances: raygen's random bits and origins are exact, directions within
2e-7 (one ulp of a unit vector's components, from the card's own sqrt and
division being compared with PyTorch's); the BVH kernel's prim ids and
shadow verdicts exactly, its t within 1e-6 relative (its operations are the
plain walk's, in the same order, without contraction); the bounces follow
lumillyrender_tpu_torch/parity.py's lane rules; the backward kernel is
compared on its backward rules' lanes (`bwd_comparable`) within
`parity.KERNEL_BWD_RTOL` (1e-5) of each cotangent's and table's largest
magnitude, with the recomputed alive' equal to the forward kernel's on
every lane and two runs bit-equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.convert import state_from_numpy
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.constants import EPS, INF
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh
from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd
from lumillyrender_tpu_torch.ops.intersect import _walk_tris, intersect_shade_brute
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

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
@pytest.mark.parametrize("want_shade", [False, True])
def test_bvh_kernel_matches_plain_walk(welcome, want_shade):
    bvh = welcome.data.bvh
    tables = cuda_bvh.tables_of(bvh)
    o, d = _bvh_rays(bvh, 8192, 3)
    t0 = torch.full((o.shape[0],), INF, device=o.device)
    stop = torch.full_like(t0, -INF)
    got = cuda_bvh.intersect_tris(o, d, t0, stop, tables, want_shade)
    want = _walk_tris(o, d, t0, stop, bvh, want_shade)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert ((got[0] - want[0]).abs() <= 1e-6 * want[0].abs().clamp(min=1.0)).all()
    if want_shade:
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


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
    assert torch.equal(got[1], want[1])


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["welcome-geo", "ibl-material"])
def test_diff_step_refuses_what_no_kernel_serves(card, name):
    """A differentiable BVH or IBL scene has no kernel path on the card yet:
    the step raises with a reason instead of running the plain step."""
    c = compile_scene_file(ASSETS / f"{name}.toml", device=card)
    with pytest.raises(NotImplementedError, match="later slice"):
        cuda_bounce.make_step_diff(c.data, c.settings, 77)


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
