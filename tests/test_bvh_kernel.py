"""The CUDA BVH walk's arithmetic and wrapper, checked on the CPU.

The kernel has no interpret mode.  Its per-ray walk (native/bvh_walk.h) is
also compiled by the host compiler into the native library, and those
cases compare it with the XLA walk (ops/traverse_bvh.py), the reference.
The wrapper (ops/bvh_kernel.py) and the choice between the two walks
(scene/query.walk_bvh) are checked by tracing and by exporting the
program for the CUDA platform, which needs no GPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

import chip_smoke
from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.accel import native
from cpu_ray_tracer_tpu.accel.compile import compile_bvh, make_triangle_pool
from cpu_ray_tracer_tpu.core import camera as cam_mod
from cpu_ray_tracer_tpu.ops import bvh_kernel, traverse_bvh
from cpu_ray_tracer_tpu.scene import query
from cpu_ray_tracer_tpu.scene.build import compile_scene

from tests.conftest import OUR_ASSETS

BENCH_XML = os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml")
# XLA:CPU fuses multiply-adds where the host build does not, so t and the
# barycentrics may differ in their last bits, by more on grazing hits whose
# dot products cancel (chip_smoke.walk_limits gives the per-ray limits the
# card's comparison uses too); the walk itself (which nodes, which
# triangles, which hit) must be identical.


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(3)
    base = rng.uniform(-4, 4, size=(400, 1, 3))
    tri_v = (base + rng.normal(0, 0.4, size=(400, 3, 3))).astype(np.float32)
    bvh, _ = compile_bvh(tri_v)
    return bvh, make_triangle_pool(tri_v)


@pytest.fixture(scope="module")
def bench():
    scene, _ = compile_scene(BENCH_XML, layout="tlas")
    return scene


def random_rays(n, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def camera_rays(w, h):
    cam = cam_mod.make_camera(w, h, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
    rays = cam_mod.full_frame_rays(cam)
    return np.asarray(rays.o), np.asarray(rays.d)


def assert_same_walk(bvh, pool, o, d, t0, any_hit=False):
    ref = jax.jit(
        lambda o, d, t0: traverse_bvh.traverse(bvh, pool, o, d, t0, any_hit=any_hit)
    )(o, d, t0)
    got = native.walk_host(bvh, pool, o, d, t0, any_hit)
    for k in ("tri_idx", "obj_id", "mat_id", "traversed", "tested"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    t_lim, bary_lim = chip_smoke.walk_limits(o, d, pool, got["tri_idx"], got["tri_idx"])
    t_ref = np.asarray(ref["t"])
    assert (np.abs(got["t"] - t_ref) <= t_lim * np.abs(t_ref)).all()
    assert (np.abs(got["bary"] - np.asarray(ref["bary"])) <= bary_lim[:, None]).all()
    return got


def _case(name, soup, bench):
    """(bvh, pool, o, d, t0, any_hit) for one named ray set."""
    bvh, pool = soup
    if name == "soup_closest":
        o, d = random_rays(2000)
        return bvh, pool, o, d, np.full(2000, constants.RAY_FAR, np.float32), False
    if name == "soup_any_hit":
        o, d = random_rays(2000, seed=1)
        return bvh, pool, o, d, np.full(2000, constants.RAY_FAR, np.float32), True
    if name == "soup_shadow_tmax":
        o, d = random_rays(2000, seed=2)
        t0 = np.random.default_rng(2).uniform(0.5, 4.0, 2000).astype(np.float32)
        return bvh, pool, o, d, t0, True
    if name == "soup_dead_rays":
        o, d = random_rays(2000, seed=3)
        t0 = np.where(np.arange(2000) % 3 == 0, -1.0, constants.RAY_FAR).astype(np.float32)
        return bvh, pool, o, d, t0, False
    if name == "soup_odd_batch":
        o, d = random_rays(333, seed=4)
        return bvh, pool, o, d, np.full(333, constants.RAY_FAR, np.float32), False
    o, d = camera_rays(96, 54)
    t0 = np.full(o.shape[0], constants.RAY_FAR, np.float32)
    return bench.bvh, bench.tris, o, d, t0, name == "bench_any_hit"


@pytest.mark.parametrize(
    "name",
    [
        "soup_closest", "soup_any_hit", "soup_shadow_tmax", "soup_dead_rays",
        "soup_odd_batch", "bench_closest", "bench_any_hit",
    ],
)
def test_host_walk_matches_xla_walk(name, soup, bench):
    bvh, pool, o, d, t0, any_hit = _case(name, soup, bench)
    got = assert_same_walk(bvh, pool, o, d, t0, any_hit)
    hits = got["tri_idx"] >= 0
    assert 0 < hits.sum() < hits.size  # the set has hits and misses
    if name == "soup_dead_rays":
        dead = t0 < 0
        assert (got["tri_idx"][dead] == -1).all()
        np.testing.assert_array_equal(got["t"][dead], -1.0)
    if name == "soup_shadow_tmax":
        assert (got["t"][hits] < t0[hits]).all()


def test_any_hit_flags_equal_closest_hit_flags(soup):
    bvh, pool = soup
    o, d = random_rays(1000, seed=5)
    t0 = np.full(1000, constants.RAY_FAR, np.float32)
    near = native.walk_host(bvh, pool, o, d, t0, any_hit=False)
    anyh = native.walk_host(bvh, pool, o, d, t0, any_hit=True)
    np.testing.assert_array_equal(near["tri_idx"] >= 0, anyh["tri_idx"] >= 0)
    # any-hit stops early: never more work than the nearest-hit walk
    assert (anyh["traversed"] <= near["traversed"]).all()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("r", [1, 333])
def test_wrapper_shapes_and_dtypes(soup, r, any_hit):
    bvh, pool = soup
    o = jax.ShapeDtypeStruct((r, 3), jnp.float32)
    t0 = jax.ShapeDtypeStruct((r,), jnp.float32)
    out = jax.eval_shape(
        lambda o, d, t0: bvh_kernel.traverse(bvh, pool, o, d, t0, any_hit=any_hit), o, o, t0
    )
    ref = jax.eval_shape(
        lambda o, d, t0: traverse_bvh.traverse(bvh, pool, o, d, t0, any_hit=any_hit), o, o, t0
    )
    assert set(out) == set(ref)
    for k in ref:
        assert (out[k].shape, out[k].dtype) == (ref[k].shape, ref[k].dtype), k


def _exported_text(scene, platform, grad=False):
    def walk(o, d):
        t0 = jnp.full((o.shape[0],), constants.RAY_FAR, jnp.float32)
        return query.walk_bvh(scene, scene.bvh, scene.tris, o, d, t0)["t"]

    fn = walk
    if grad:
        def fn(o, d):
            return jax.grad(lambda o: jnp.sum(query.find_nearest_diff(scene, o, d)["t"]))(o)

    rays = jax.ShapeDtypeStruct((64, 3), jnp.float32)
    exp = export.export(
        jax.jit(fn),
        platforms=(platform,),
        disabled_checks=[export.DisabledSafetyCheck.custom_call(bvh_kernel.TARGET)],
    )(rays, rays)
    return exp.mlir_module()


@pytest.mark.parametrize(
    "platform, traversal, kernel",
    [("cuda", "auto", True), ("cpu", "auto", False), ("cuda", "xla", False)],
)
def test_walk_choice_follows_lowering_platform(soup, platform, traversal, kernel):
    """The CUDA kernel is what a GPU program runs; every other platform, and
    a scene pinned to traversal="xla", gets the XLA walk's while loop."""
    scene, _ = compile_scene(os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml"))
    text = _exported_text(scene.replace(traversal=traversal), platform)
    assert (bvh_kernel.TARGET in text) == kernel
    assert ("stablehlo.while" in text) != kernel


def test_gradient_program_runs_the_kernel_on_cuda():
    scene, _ = compile_scene(os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml"))
    text = _exported_text(scene, "cuda", grad=True)
    assert bvh_kernel.TARGET in text


def test_grad_through_find_nearest_matches_detached_reference(bench):
    """Grads w.r.t. ray origins and vertices through the chooser (detached
    walk, differentiable recomputation of t) equal those through the XLA
    walk called directly."""
    o, d = camera_rays(24, 16)
    o, d = jnp.asarray(o), jnp.asarray(d)

    def loss(o, v0, scene):
        s = scene.replace(tris=scene.tris.replace(v0=v0))
        hit = query.find_nearest_diff(s, o, d)
        return jnp.sum(jnp.where(hit["tri_idx"] >= 0, hit["t"], 0.0))

    g_auto = jax.grad(loss, argnums=(0, 1))(o, bench.tris.v0, bench)
    g_xla = jax.grad(loss, argnums=(0, 1))(o, bench.tris.v0, bench.replace(traversal="xla"))
    assert float(jnp.abs(g_auto[1]).sum()) > 0  # vertex grads flow
    for a, b in zip(g_auto, g_xla):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_masked_rays_report_no_hit(bench):
    o, d = camera_rays(32, 18)
    r = o.shape[0]
    mask = np.arange(r) % 2 == 0
    t0 = jnp.full((r,), constants.RAY_FAR, jnp.float32)
    full = query.walk_bvh(bench, bench.bvh, bench.tris, o, d, t0)
    masked = query.walk_bvh(bench, bench.bvh, bench.tris, o, d, t0, mask=jnp.asarray(mask))
    tri_full, tri_masked = np.asarray(full["tri_idx"]), np.asarray(masked["tri_idx"])
    assert (tri_full[~mask] >= 0).any()
    assert (tri_masked[~mask] == -1).all()
    np.testing.assert_array_equal(tri_masked[mask], tri_full[mask])


def test_walk_maps_under_vmap(bench):
    o, d = camera_rays(16, 8)
    o, d = jnp.asarray(o).reshape(4, -1, 3), jnp.asarray(d).reshape(4, -1, 3)
    t0 = jnp.full(o.shape[:2], constants.RAY_FAR, jnp.float32)
    batched = jax.vmap(lambda o, d, t0: query.walk_bvh(bench, bench.bvh, bench.tris, o, d, t0))(o, d, t0)
    flat = query.walk_bvh(bench, bench.bvh, bench.tris, o.reshape(-1, 3), d.reshape(-1, 3), t0.reshape(-1))
    np.testing.assert_array_equal(np.asarray(batched["tri_idx"]).reshape(-1), np.asarray(flat["tri_idx"]))


@pytest.mark.gpu
def test_kernel_matches_xla_walk_on_card(gpu):
    """chip_smoke.py phase 3 at a small size."""
    scene, camera = chip_smoke.phase_setup(320, 180)
    chip_smoke.phase_walks(scene, camera, reps=1)
