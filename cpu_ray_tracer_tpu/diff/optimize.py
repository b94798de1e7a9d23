"""Inverse-rendering optimization loop (BASELINE.json config 5): recover
material/texture/light parameters from a target image by gradient descent,
optionally sharded over a ray mesh with psum'd parameter gradients."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from cpu_ray_tracer_tpu.core import rng as rng_mod
from cpu_ray_tracer_tpu.core.camera import Camera, full_frame_rays
from cpu_ray_tracer_tpu.diff import grad as grad_mod
from cpu_ray_tracer_tpu.render import pathtracer
from cpu_ray_tracer_tpu.scene.types import DeviceScene


def make_value_and_grad(
    scene: DeviceScene,
    camera: Camera,
    target: jnp.ndarray,
    depth_limit: int = 3,
):
    """fn(params, spp_index) -> (L2 loss vs target, parameter grads) of one
    differentiable path-traced pass on a single device."""

    def loss_fn(params, spp_index):
        s = grad_mod.apply_params(scene, params)
        img, _ = pathtracer.render_pass(
            s, camera, spp_index, depth_limit=depth_limit, differentiable=True
        )
        return grad_mod.l2_image_loss(img, target)

    return jax.value_and_grad(loss_fn)


def make_train_step(
    scene: DeviceScene,
    camera: Camera,
    target: jnp.ndarray,
    optimizer: optax.GradientTransformation,
    depth_limit: int = 3,
):
    """Single-device differentiable train step:
    params -> render -> L2 vs target -> optimizer update."""
    value_and_grad = make_value_and_grad(scene, camera, target, depth_limit)

    @jax.jit
    def step(params, opt_state, spp_index):
        loss, grads = value_and_grad(params, spp_index)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_sharded_value_and_grad(
    scene: DeviceScene,
    camera: Camera,
    target: jnp.ndarray,
    mesh: Mesh,
    axis: str = "rays",
    depth_limit: int = 3,
):
    """Multi-device loss and grads: pixels sharded over `axis`, scene+params
    replicated, per-shard parameter grads psum-reduced inside shard_map (the
    all-reduce overlaps the backward pass under XLA latency hiding).

    `target` is either one [H, W, 3] image, or a [K, H, W, 3] stack for
    common-random-numbers training: step `spp_index` then compares against
    target `spp_index % K` while drawing the SAME per-pixel RNG streams the
    target render at that index used, so the per-step objective is
    deterministic (zero at the true parameters) instead of a fresh-MC-noise
    draw — convergence becomes provable rather than arguable."""
    n = camera.width * camera.height
    n_dev = mesh.devices.size
    assert n % n_dev == 0

    scene_spec = jax.tree.map(lambda _: P(), scene)
    crn = target.ndim == 4
    target_flat = target.reshape((-1, n, 3) if crn else (n, 3))
    n_targets = target_flat.shape[0] if crn else 1

    def shard_loss(params, scene_rep, o, d, seeds, tgt):
        s = grad_mod.apply_params(scene_rep, params)
        radiance, _ = pathtracer.sample_radiance(
            s, o, d, seeds, depth_limit=depth_limit, differentiable=True
        )
        # mean over the local shard; psum of per-shard means / n_dev = global
        return jnp.sum((radiance - tgt) ** 2) / (n * 3)

    def build(params_example):
        """fn(params, spp_index) -> (loss, grads) for params shaped like
        `params_example`."""
        params_spec = jax.tree.map(lambda _: P(), params_example)

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(params_spec, scene_spec, P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), params_spec),
            check_vma=False,
        )
        def grad_shard(params, scene_rep, o, d, seeds, tgt):
            loss, grads = jax.value_and_grad(shard_loss)(params, scene_rep, o, d, seeds, tgt)
            loss = jax.lax.psum(loss, axis)
            grads = jax.tree.map(lambda g: jax.lax.psum(g, axis), grads)
            return loss, grads

        def value_and_grad(params, spp_index):
            spp_index = jnp.asarray(spp_index, jnp.uint32)
            if crn:
                spp_index = spp_index % jnp.uint32(n_targets)
                tgt = jnp.take(target_flat, spp_index.astype(jnp.int32), axis=0)
            else:
                tgt = target_flat
            pixel_ids = jnp.arange(n, dtype=jnp.uint32)
            seeds = rng_mod.pixel_seeds(pixel_ids, spp_index)
            seeds, jx = rng_mod.random_float(seeds)
            seeds, jy = rng_mod.random_float(seeds)
            rays = full_frame_rays(camera, jitter_x=jx, jitter_y=jy)
            return grad_shard(params, scene, rays.o, rays.d, seeds, tgt)

        return value_and_grad

    return build


def make_sharded_train_step(
    scene: DeviceScene,
    camera: Camera,
    target: jnp.ndarray,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    axis: str = "rays",
    depth_limit: int = 3,
):
    """Multi-device train step over make_sharded_value_and_grad (see there
    for the sharding and the common-random-numbers `target` stack).
    Returns build(params_example) -> step(params, opt_state, spp_index)."""
    build_vg = make_sharded_value_and_grad(scene, camera, target, mesh, axis, depth_limit)

    def build(params_example):
        value_and_grad = build_vg(params_example)

        @jax.jit
        def step(params, opt_state, spp_index):
            loss, grads = value_and_grad(params, spp_index)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return step

    return build
