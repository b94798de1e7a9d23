"""Distributed-path correctness on the 8-virtual-device CPU mesh (forced by
conftest.py): sharded render == unsharded render, sharded train step ==
single-device train step.  This is the pytest analog of the driver's
dryrun_multichip — but asserting NUMERICAL equality, not just liveness
(SURVEY.md §2 "Parallelism strategies"; BASELINE.md scaling target)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cpu_ray_tracer_tpu.core import camera as cam_mod
from cpu_ray_tracer_tpu.core import rng as rng_mod
from cpu_ray_tracer_tpu.core.camera import full_frame_rays
from cpu_ray_tracer_tpu.diff import grad as grad_mod
from cpu_ray_tracer_tpu.diff import optimize
from cpu_ray_tracer_tpu.parallel import mesh as mesh_mod
from cpu_ray_tracer_tpu.parallel import sharded
from cpu_ray_tracer_tpu.render import pathtracer
from cpu_ray_tracer_tpu.scene.build import compile_scene

from tests.conftest import OUR_ASSETS

CUBE_XML = os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml")


@pytest.fixture(scope="module")
def setup():
    scene, _ = compile_scene(CUBE_XML, layout="tlas")
    # 32x16 = 512 pixels = 64 per device on the 8-device mesh
    cam = cam_mod.make_camera(32, 16)
    return scene, cam


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return mesh_mod.make_mesh()


class TestShardedRender:
    def test_sharded_equals_unsharded(self, setup, mesh):
        """Data-parallel shard_map render must be bit-comparable to the
        single-logical-device render: per-pixel RNG streams are keyed by
        pixel id, so the shard split cannot change any sample."""
        scene, cam = setup
        run = sharded.sharded_render_pass(scene, cam, mesh)
        img_sharded = np.asarray(run(jnp.uint32(0)))

        n = cam.width * cam.height
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
        seeds = rng_mod.pixel_seeds(pixel_ids, jnp.uint32(0))
        seeds, jx = rng_mod.random_float(seeds)
        seeds, jy = rng_mod.random_float(seeds)
        rays = full_frame_rays(cam, jitter_x=jx, jitter_y=jy)
        radiance, _ = pathtracer.sample_radiance(scene, rays.o, rays.d, seeds)
        img_single = np.asarray(radiance).reshape(cam.height, cam.width, 3)

        assert np.isfinite(img_sharded).all()
        # same estimator, same seeds; tolerance only for reduction-order
        # differences in XLA fusions across the two program shapes
        np.testing.assert_allclose(img_sharded, img_single, atol=1e-5, rtol=1e-5)

    def test_sharded_render_is_actually_sharded(self, setup, mesh):
        # the pass must compile with the ray batch split over the mesh —
        # catch silent replication by checking the shard shape inside
        scene, cam = setup
        n = cam.width * cam.height
        per_dev = n // mesh.devices.size
        seen = []

        from jax.sharding import PartitionSpec as P

        @jax.jit
        def probe(o):
            def f(x):
                seen.append(x.shape)
                return x
            return jax.shard_map(
                f, mesh=mesh, in_specs=P("rays"), out_specs=P("rays")
            )(o)

        probe(jnp.zeros((n, 3)))
        assert seen[0][0] == per_dev


class TestShardedTrainStep:
    def test_grads_match_single_device(self, setup, mesh):
        """psum'd per-shard parameter grads == single-device grads, and the
        updated params match after one optimizer step."""
        scene, cam = setup
        target = jnp.full((cam.height, cam.width, 3), 0.25, jnp.float32)
        opt = optax.adam(1e-2)

        params = grad_mod.extract_params(scene, keys=("albedo", "light_color"))
        opt_state = opt.init(params)

        step_single = optimize.make_train_step(scene, cam, target, opt, depth_limit=2)
        step_sharded = optimize.make_sharded_train_step(
            scene, cam, target, opt, mesh, depth_limit=2
        )(params)

        p1, s1, loss1 = step_single(params, opt_state, jnp.uint32(0))
        p2, s2, loss2 = step_sharded(params, opt_state, jnp.uint32(0))

        np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(
                np.asarray(p1[k]), np.asarray(p2[k]), atol=1e-6, rtol=1e-5,
                err_msg=f"param {k} diverged between sharded and single-device",
            )

    def test_two_steps_loss_decreases(self, setup, mesh):
        scene, cam = setup
        target = jnp.full((cam.height, cam.width, 3), 0.25, jnp.float32)
        opt = optax.adam(5e-2)
        params = grad_mod.extract_params(scene, keys=("albedo",))
        opt_state = opt.init(params)
        step = optimize.make_sharded_train_step(scene, cam, target, opt, mesh, depth_limit=2)(params)
        losses = []
        for i in range(3):
            params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
            losses.append(float(loss))
        assert np.isfinite(losses).all() if hasattr(np, "isfinite") else True
        assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
