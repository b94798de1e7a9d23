"""shard_map-ed render and differentiable train steps.

Data-parallel over the ray/pixel batch (the analog of the reference's 16x16
tile jobs, SURVEY.md §2 P2): each device path-traces its shard of pixels
against a replicated scene.  For the differentiable pass, per-device
parameter gradients (materials / texture texels / light) are `psum`-reduced
over the mesh — XLA overlaps the all-reduce with the remaining backward
computation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cpu_ray_tracer_tpu.core import rng as rng_mod
from cpu_ray_tracer_tpu.core.camera import Camera, full_frame_rays
from cpu_ray_tracer_tpu.render import pathtracer
from cpu_ray_tracer_tpu.scene.types import DeviceScene


def sharded_render_pass(scene: DeviceScene, camera: Camera, mesh: Mesh, axis: str = "rays"):
    """Build a jitted one-sample-per-pixel path-trace pass whose pixel batch
    is sharded over `mesh` and whose output radiance is gathered back.

    Returns fn(spp_index: uint32) -> radiance [H, W, 3].
    """
    n = camera.width * camera.height
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"pixel count {n} not divisible by {n_dev} devices"

    scene_spec = jax.tree.map(lambda _: P(), scene)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(scene_spec, P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def _trace_shard(scene_rep, o, d, seeds):
        radiance, _ = pathtracer.sample_radiance(scene_rep, o, d, seeds)
        return radiance

    @jax.jit
    def run(spp_index):
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
        seeds = rng_mod.pixel_seeds(pixel_ids, spp_index)
        seeds, jx = rng_mod.random_float(seeds)
        seeds, jy = rng_mod.random_float(seeds)
        rays = full_frame_rays(camera, jitter_x=jx, jitter_y=jy)
        radiance = _trace_shard(scene, rays.o, rays.d, seeds)
        return radiance.reshape(camera.height, camera.width, 3)

    return run


def psum_grads(grads, axis: str = "rays"):
    """All-reduce parameter gradients across the ray mesh axis (used inside
    shard_map-ed train steps)."""
    return jax.tree.map(lambda g: jax.lax.psum(g, axis), grads)
