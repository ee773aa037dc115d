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
lumillyrender_tpu_torch/parity.py's lane rules.
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
from lumillyrender_tpu_torch.ops.intersect import _walk_tris
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
