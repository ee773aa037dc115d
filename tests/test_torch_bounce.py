"""Per-lane parity of the port's bounce step and camera rays.

* The plain PyTorch step against the JAX package's XLA step
  (`make_bounce_step(..., allow_fused=False)`) on real compiled scenes at
  several bounce depths, with the JAX package's own exclusion rules for
  lanes where float contraction flips a discontinuous decision
  (tests/test_fused_bounce.py::_assert_states_close: tie flips < 0.4%,
  excluded lanes < 8%, accum flips <= 0.5%, rtol 2e-3).
* One new-cbox bounce against the TPU kernel itself (Pallas, interpret
  mode), and the plain camera rays against the Pallas raygen kernel.
The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.integrator.wavefront import make_bounce_step as jax_step
from lumillyrender_tpu.ops import pallas_bounce
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.data import SKY_SIMPLE
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch.convert import (
    scene_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from test_fused_bounce import (
    GGX_REFR_SCENE,
    _assert_states_close,
    _mk_state,
    _random_state,
)
from torch_many_rows import bounce_grads, tiled_scene

torch.set_num_threads(2)

SEED = 77
BOUNCES = (0, 3, 7, 70)
# "simple-sky" is new-cbox under a simple sky (meridian and horizon
# blended by |d.y|), which the compiler gives no asset of its own.
SCENES = ["new-cbox", "primitive", "debug-nee", "brdf", "families", "simple-sky"]


def _jax_compiled(assets_dir, name):
    if name == "families":
        return jax_compile_scene(jax_parse(GGX_REFR_SCENE), spp=1)
    if name == "simple-sky":
        c = jax_compile(assets_dir / "new-cbox.toml", spp=1)
        c.data = dataclasses.replace(c.data, sky=dataclasses.replace(
            c.data.sky, color=jnp.asarray([0.1, 0.2, 0.9], jnp.float32),
            color2=jnp.asarray([0.9, 0.8, 0.7], jnp.float32)))
        c.settings = dataclasses.replace(c.settings, sky_kind=SKY_SIMPLE)
        return c
    return jax_compile(assets_dir / f"{name}.toml", spp=1)


def _port_state(parts, bounce, device="cpu"):
    return state_from_numpy(bounce, *parts, device=device)


def _as_ns(state):
    return types.SimpleNamespace(**state_to_numpy(state))


@pytest.mark.parametrize("name", SCENES)
def test_plain_step_matches_jax_step(assets_dir, name):
    ref = _jax_compiled(assets_dir, name)
    scene = scene_from_numpy(ref.data)
    step_ref = jax_step(ref.data, ref.settings, SEED, allow_fused=False)
    step = wavefront.make_bounce_step(scene, ref.settings, SEED)
    rng = np.random.default_rng(sum(map(ord, name)))
    for bounce in BOUNCES:
        parts = _random_state(rng, ref.data)
        want = step_ref(_mk_state(parts, bounce))
        got = step(_port_state(parts, bounce))
        assert got.bounce == bounce + 1
        _assert_states_close(want, _as_ns(got), f"{name}@b{bounce}")


def test_plain_step_matches_tpu_kernel(assets_dir):
    """The TPU kernel (`_bounce_kernel`, interpret mode) on one new-cbox
    bounce, same rules."""
    ref = _jax_compiled(assets_dir, "new-cbox")
    scene = scene_from_numpy(ref.data)
    kernel = pallas_bounce.make_step(ref.data, ref.settings, SEED,
                                     interpret=True)
    parts = _random_state(np.random.default_rng(9), ref.data)
    want = kernel(_mk_state(parts, 1))
    got = wavefront.plain_bounce_step(scene, ref.settings, SEED,
                                      _port_state(parts, 1))
    _assert_states_close(want, _as_ns(got), "new-cbox@b1 vs tpu kernel")


def test_plain_raygen_matches_tpu_kernel(assets_dir):
    """Plain camera rays vs the TPU raygen kernel at 64^2 x 1 spp (4096
    lanes): o exact; d within 2e-7 (XLA fuses the sensor-point
    multiply-adds, the port rounds each product)."""
    import dataclasses

    ref = _jax_compiled(assets_dir, "new-cbox")
    scene = scene_from_numpy(ref.data)
    settings = dataclasses.replace(ref.settings, width=64, height=64)
    n, seed, off = 64 * 64, 9, 3
    o_k, d_k, g_k = pallas_bounce.generate_rays(ref.data, settings, seed, off,
                                                n, interpret=True)
    assert g_k is None
    o, d, pdf, g = cuda_bounce.generate_rays(scene, settings, seed, off, n)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_k))
    assert np.abs(d.numpy() - np.asarray(d_k)).max() < 2e-7
    assert torch.equal(pdf, torch.ones(n)) and torch.equal(g, torch.ones(n))


def test_wrappers_take_the_plain_path_on_cpu(assets_dir):
    """For CPU tensors the kernel wrappers are their plain versions, and
    they launch nothing."""
    ref = _jax_compiled(assets_dir, "debug-nee")
    scene = scene_from_numpy(ref.data)
    cuda_bounce.reset_counts()
    parts = _random_state(np.random.default_rng(2), ref.data)
    a = cuda_bounce.bounce(scene, ref.settings, SEED, _port_state(parts, 2))
    b = wavefront.plain_bounce_step(scene, ref.settings, SEED,
                                    _port_state(parts, 2))
    for k in ("o", "d", "throughput", "accum", "alive", "lane"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.rays_traced, b.rays_traced)
    assert cuda_bounce.counts() == {"raygen": 0, "bounce": 0, "bvh": 0,
                                    "bvh_wide": 0, "bvh_streamed": 0,
                                    "bounce_bvh": 0, "bounce_bwd": 0}


def test_compact_keeps_live_lanes_and_weights():
    """Prefix compaction keeps every live lane at weight 1; on overflow,
    systematic resampling keeps exactly `width` lanes at weight a/width."""
    n = 64
    alive = torch.zeros(n, dtype=torch.bool)
    alive[[3, 10, 11, 40]] = True
    ones = torch.ones((n, 3))
    st = wavefront.PathState(
        bounce=4, o=torch.arange(n, dtype=torch.float32)[:, None] * ones,
        d=ones, throughput=ones, accum=ones, alive=alive,
        rays_traced=torch.zeros(()), lane=torch.arange(n, dtype=torch.int32),
    )
    c = wavefront._compact(st, 8, SEED, 0x50000001, salt=0)
    assert c.alive.tolist() == [True] * 4 + [False] * 4
    assert c.o[:4, 0].tolist() == [3.0, 10.0, 11.0, 40.0]
    assert torch.equal(c.throughput[:4], torch.ones((4, 3)))
    assert torch.equal(c.accum, torch.zeros((8, 3)))
    c2 = wavefront._compact(st, 2, SEED, 0x50000001, salt=0)
    assert c2.alive.tolist() == [True, True]
    assert set(c2.lane.tolist()) <= {3, 10, 11, 40}
    assert torch.equal(c2.throughput, torch.full((2, 3), 2.0))


@pytest.mark.parametrize("width", [512, 96])
def test_compact_matches_jax(assets_dir, width):
    """The port's compaction picks the same lanes with the same weights as
    the JAX package's, both when the live population fits (512) and when
    it overflows into systematic resampling (96). Exact (tolerance 0)."""
    from lumillyrender_tpu.integrator import wavefront as jax_wavefront

    ref = _jax_compiled(assets_dir, "new-cbox")
    parts = _random_state(np.random.default_rng(4), ref.data)
    parts = parts[:4] + (np.random.default_rng(5).random(len(parts[0])) < 0.2,
                         parts[5])
    want = jax_wavefront._compact(_mk_state(parts, 8), width, SEED,
                                  0x50000001, salt=jnp.uint32(parts[5][0]))
    got = wavefront._compact(_port_state(parts, 8), width, SEED, 0x50000001,
                             salt=int(parts[5][0]))
    got = state_to_numpy(got)
    for k in ("o", "d", "throughput", "accum", "alive", "lane"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["primitive", "new-cbox"])
def test_pack_tables_layout(assets_dir, name):
    """The bounce kernel's table rows (csrc/bounce.cu), also for a scene
    without triangles; the BVH tables only when asked for."""
    ref = _jax_compiled(assets_dir, name)
    scene = scene_from_numpy(ref.data)
    t = cuda_bounce.pack_tables(scene)
    assert "bvh" not in t
    assert cuda_bounce.pack_tables(scene, bvh=True)["bvh"]["k"] == scene.bvh.blk_p0.shape[1]
    g = ref.data.geometry
    nt, ns = np.asarray(g.tri_p0).shape[0], np.asarray(g.sph_c).shape[0]
    assert t["tris"].shape == (nt, 16) and t["sph"].shape == (ns, 8)
    if nt:
        np.testing.assert_array_equal(t["tris"][:, 3:6].numpy(), np.asarray(g.tri_e1))
        np.testing.assert_array_equal(t["tris"][:, 12].numpy(), np.asarray(g.tri_mat))
    np.testing.assert_array_equal(t["sph"][:, 3].numpy(), np.asarray(g.sph_r))
    lt = ref.data.lights
    np.testing.assert_array_equal(t["lights"][:, 14].numpy(), np.asarray(lt.cdf))
    assert t["mats"].shape == (np.asarray(ref.data.materials.type_id).shape[0], 16)
    assert t["total_area"] == float(lt.total_area)


@pytest.mark.parametrize("nt,ns,families,n,want", [
    (16, 8, (0,), 4096, ("small", "lambert")),            # at the caps
    (17, 8, (0,), 4096, ("general", "lambert")),          # one triangle past
    (16, 9, (0, 0), 4096, ("general", "lambert")),        # one sphere past
    (12, 2, (0,), 1 << 18, ("small", "lambert")),         # at the lane cap
    (12, 2, (0,), (1 << 18) + 1, ("general", "lambert")),  # one lane past
    (12, 2, (0,), 1 << 21, ("general", "lambert")),       # new-cbox at full width
    (0, 2, (0,), 32768, ("small", "lambert")),            # primitive
    (6, 5, (0, 3), 32768, ("small", "all")),              # brdf
    (256, 2, (0,), 4096, ("general", "lambert")),         # many-light
    (4, 4, (0, 1, 2, 3, 4), 4096, ("small", "all")),      # ibl-material
    (12, 2, (3,), 4096, ("small", "all")),                # one family, not Lambert
    (81932, 0, (0, 4), 4096, ("general", "all")),
])
def test_bounce_instance_choice(nt, ns, families, n, want):
    """The brute-force kernels' instance: the small sweep up to 16
    triangles and 8 spheres and up to SMALL_MAX_LANES lanes, Lambert-only
    shading where every row is Lambert."""
    inst = cuda_bounce.bounce_instance(nt, ns, families, n)
    assert tuple(inst) == want
    assert inst.code == (1 if want[0] == "small" else 0) | (2 if want[1] == "lambert" else 0)


@pytest.mark.parametrize("n,group", [(1, 16), (4096, 16), (8192, 8), (16384, 4),
                                     (32768, 1), (1 << 20, 1), (1 << 21, 1)])
def test_tail_group(n, group):
    """Threads per lane: groups of 4-16 at the narrow stages, one thread a
    lane where the grid fills the card."""
    assert cuda_bounce.tail_group(n) == group


@pytest.mark.parametrize("name,want", [("new-cbox", ("small", "lambert")),
                                       ("brdf", ("small", "all")),
                                       ("many-light", ("general", "lambert"))])
def test_pack_tables_instance(assets_dir, name, want):
    """pack_tables keeps the families present and, for a scene within the
    small sweep's caps, its prim rows laid out as csrc/bounce_body.cuh's
    SmallPrims (16 rows of 16 floats, then 8 of 8, zero-padded);
    launch_instance picks from them, and takes a fixed instance and group
    where the tables carry one (one thread a lane backward)."""
    c = compile_scene_file(assets_dir / f"{name}.toml", device="cpu")
    t = cuda_bounce.pack_tables(c.data)
    assert t["families"] == c.settings.mat_types
    inst, group = cuda_bounce.launch_instance(t, 4096)
    assert tuple(inst) == want and group == 16
    assert cuda_bounce.launch_instance(t, 4096, backward=True) == (inst, 1)
    assert cuda_bounce.launch_instance(t, 1 << 21)[0].sweep == "general"
    forced = dict(t, instance=cuda_bounce.Instance("general", "all"), group=1)
    assert cuda_bounce.launch_instance(forced, 4096) == (cuda_bounce.Instance("general", "all"), 1)
    with pytest.raises(ValueError):
        cuda_bounce.launch_instance(dict(t, group=4), 4096, backward=True)
    if want[0] == "general":
        assert t["small"] is None
        with pytest.raises(ValueError, match="small instance"):
            cuda_bounce.launch_instance(dict(t, instance=cuda_bounce.Instance("small", "all")), 8)
        return
    block = np.frombuffer(bytes(t["small"]), dtype=np.float32)
    assert block.size == 16 * 16 + 8 * 8
    nt, ns = t["tris"].shape[0], t["sph"].shape[0]
    np.testing.assert_array_equal(block[:nt * 16], t["tris"].numpy().reshape(-1))
    np.testing.assert_array_equal(block[256:256 + ns * 8], t["sph"].numpy().reshape(-1))
    assert not block[nt * 16:256].any() and not block[256 + ns * 8:].any()


def test_diff_supported_caps_material_rows(assets_dir):
    """The backward kernel keeps a row table a warp in shared memory: past
    BWD_MAX_ROWS material rows the scene has no kernel backward."""
    import dataclasses

    c = compile_scene_file(assets_dir / "new-cbox.toml", device="cpu")
    assert cuda_bounce.diff_supported(c.data, c.settings)[0]
    mt = c.data.materials
    k = cuda_bounce.BWD_MAX_ROWS + 1
    rep = lambda t: t[:1].expand(k, *t.shape[1:]).contiguous()
    big = dataclasses.replace(mt, **{f.name: rep(getattr(mt, f.name))
                                     for f in dataclasses.fields(mt)})
    ok, why = cuda_bounce.diff_supported(dataclasses.replace(c.data, materials=big), c.settings)
    assert not ok and "row" in why


def test_hybrid_takes_a_lambert_scene_past_the_row_cap(assets_dir):
    """A Lambert-only scene that the backward kernel refuses for its rows
    (new-cbox with its material table tiled to BWD_MAX_ROWS + 1 rows, rows
    0 .. nm-1 unchanged) takes the hybrid step, as the JAX package's
    `supported_diff_hybrid` takes every scene that `supported_diff` refuses:
    make_step_diff on the CPU returns a step with its own backward
    (`fused_diff`), and one bounce's gradients equal autograd of the plain
    step's."""
    c = compile_scene_file(assets_dir / "new-cbox.toml", device="cpu")
    scene = tiled_scene(c.data, cuda_bounce.BWD_MAX_ROWS + 1)
    assert not cuda_bounce.diff_supported(scene, c.settings)[0]
    assert cuda_bounce.hybrid_supported(scene, c.settings) == (True, "")
    ok, why = cuda_bounce.hybrid_supported(c.data, c.settings)
    assert not ok and "backward kernel" in why
    rng = np.random.default_rng(5)
    st = _port_state(_random_state(rng, scene, 256), 3)
    assert cuda_bounce.make_step_diff(scene, c.settings, SEED, scene.materials).fused_diff
    cot = [torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32)) for _ in range(4)]
    grads = [bounce_grads(step_of, scene, st, cot) for step_of in (
        lambda m: cuda_bounce.make_step_diff(scene, c.settings, SEED, m),
        lambda m: lambda s: wavefront.plain_bounce_step(scene, c.settings, SEED, s, m))]
    assert grads[0][3].abs().max() > 0
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
