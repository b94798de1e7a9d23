"""Run the five BASELINE.json staged configs end-to-end and report metrics.

  1. cube.obj, Whitted, 640x480, flat (mono) BVH
  2. teapot.obj SAH-BVH, Whitted + reflective material + skydome, 1280x720
  3. bunny.obj path tracer, 16 spp, diffuse+mirror, 1280x720
  4. TLAS wok scene (wok.obj + textures + skydome substitute), 64 spp
  5. multi-object TLAS scene, differentiable pass: optimize materials from a
     target image (sharded across the available devices)

Usage: python benchmarks/run_configs.py [--configs 1,2,3] [--small]
JSONL metrics to stdout, each line with the device it ran on; the card's
name and power limit first.  `--small` shrinks resolutions/spp.  Fails
without a GPU.  Timings are the median of repeated runs after a compiling
first run, and every run's time is printed.  Configs 4 and 5 use the
upstream scenes when CRT_UPSTREAM_ASSETS holds them, else the bench scene.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUR = os.path.join(REPO, "assets", "scenes")
DEVICE = {}


def _xml(name):
    return os.path.join(OUR, name)


def _upstream_xml(name):
    """An upstream scene when CRT_UPSTREAM_ASSETS holds it, else the bench
    scene."""
    from cpu_ray_tracer_tpu.io.scene_xml import UPSTREAM_ASSETS

    path = os.path.join(UPSTREAM_ASSETS, "scenes", name) if UPSTREAM_ASSETS else ""
    return path if path and os.path.isfile(path) else _xml("bunny_teapot.xml")


def _emit(cfg, **kw):
    print(json.dumps({"config": cfg, "device": DEVICE, **kw}), flush=True)


def _timed(fn, n=5):
    """One compiling call, then n timed calls each ending in
    block_until_ready.  Returns (median seconds, all seconds, last output)."""
    import jax
    import numpy as np

    out = jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times, out


def _timed_passes(pathtracer, scene, cam, spp):
    """Progressive-pass timing with device-resident accumulators (no
    per-pass host syncs) after a compiling run."""
    import jax
    import jax.numpy as jnp

    def run(p0):
        film = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
        rays = jnp.float32(0.0)
        for p in range(p0, p0 + spp):
            img, stats = pathtracer.render_pass_jit(scene, cam, jnp.uint32(p))
            film = film + img
            rays = rays + stats["rays_traced"].astype(jnp.float32)
        return film, rays

    f, r = run(0)  # compile
    jax.block_until_ready((f, r))
    t0 = time.perf_counter()
    film, rays = run(0)
    jax.block_until_ready((film, rays))
    dt = time.perf_counter() - t0
    return dt, film, float(rays)


def config1(small):
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core.camera import make_camera
    from cpu_ray_tracer_tpu.render import whitted
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    scene, info = compile_scene(_xml("cube_scene.xml"), layout="mono")
    cam = make_camera(*(160, 120) if small else (640, 480))
    dt, times, out = _timed(lambda: whitted.render_jit(scene, cam)["image"])
    energy = float(jnp.sum(out))
    _emit(1, scene=info.name, tris=info.triangle_count, seconds=dt, run_seconds=times,
          energy=energy, mrays_s=cam.width * cam.height / dt / 1e6)


def config2(small):
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core.camera import make_camera
    from cpu_ray_tracer_tpu.io.scene_xml import SceneSpec, MaterialSpec, ObjectSpec
    import numpy as np

    from cpu_ray_tracer_tpu.render import whitted
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    spec = SceneSpec(
        name="teapot reflective",
        light_pos=np.array([0, 2.5, 1.5], np.float32),
        plane_texture_location="../assets/textures/log_fence.png",
        skydome_location="../assets/industrial_sunset_puresky_4k.hdr",
        objects=[
            ObjectSpec("../assets/teapot.obj", 0, np.array([0, -1.0, 2.2], np.float32),
                       np.zeros(3, np.float32), np.array([1.2, 1.2, 1.2], np.float32))
        ],
        materials=[MaterialSpec(0.8, 0.0, np.zeros(3, np.float32), "")],
        xml_dir=OUR,
    )
    scene, info = compile_scene(spec=spec, layout="mono")
    cam = make_camera(*(320, 180) if small else (1280, 720))
    dt, times, out = _timed(lambda: whitted.render_jit(scene, cam)["image"])
    energy = float(jnp.sum(out))
    _emit(2, scene=info.name, tris=info.triangle_count, seconds=dt, run_seconds=times,
          energy=energy, mrays_s=cam.width * cam.height / dt / 1e6)


def config3(small):
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core.camera import make_camera
    from cpu_ray_tracer_tpu.io.scene_xml import SceneSpec, MaterialSpec, ObjectSpec
    import numpy as np

    from cpu_ray_tracer_tpu.render import pathtracer
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    spec = SceneSpec(
        name="bunny pt",
        light_pos=np.array([0, 2.0, 1.5], np.float32),
        plane_texture_location="../assets/textures/log_fence.png",
        skydome_location="../assets/industrial_sunset_puresky_4k.hdr",
        objects=[
            ObjectSpec("../assets/bunny.obj", 0, np.array([-0.5, -1.0, 2.0], np.float32),
                       np.array([0, 180, 0], np.float32), np.array([0.6, 0.6, 0.6], np.float32)),
            ObjectSpec("../assets/bunny.obj", 1, np.array([0.7, -1.0, 2.4], np.float32),
                       np.array([0, 160, 0], np.float32), np.array([0.6, 0.6, 0.6], np.float32)),
        ],
        materials=[
            MaterialSpec(0.0, 0.0, np.zeros(3, np.float32), ""),
            MaterialSpec(0.9, 0.0, np.zeros(3, np.float32), ""),
        ],
        xml_dir=OUR,
    )
    scene, info = compile_scene(spec=spec, layout="tlas")
    cam = make_camera(*(320, 180) if small else (1280, 720))
    spp = 4 if small else 16
    dt, film, rays = _timed_passes(pathtracer, scene, cam, spp)
    _emit(3, scene=info.name, tris=info.triangle_count, spp=spp, seconds=dt,
          energy=float(jnp.sum(film) / spp), mrays_s=rays / dt / 1e6)


def config4(small):
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core.camera import make_camera
    from cpu_ray_tracer_tpu.render import pathtracer
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    # the reference's own wok scene lives in inside_scene.xml
    xml = _upstream_xml("inside_scene.xml")
    scene, info = compile_scene(xml, layout="tlas")
    cam = make_camera(*(320, 180) if small else (1024, 640), pos=(0, 1.0, -3.0), target=(0, 0.5, 2.0))
    spp = 4 if small else 64
    dt, film, rays = _timed_passes(pathtracer, scene, cam, spp)
    _emit(4, scene=info.name, tris=info.triangle_count, spp=spp, seconds=dt,
          energy=float(jnp.sum(film) / spp), mrays_s=rays / dt / 1e6)


def config5(small):
    import jax
    import jax.numpy as jnp
    import optax

    from cpu_ray_tracer_tpu.core.camera import make_camera
    from cpu_ray_tracer_tpu.diff import grad as grad_mod
    from cpu_ray_tracer_tpu.diff.optimize import make_sharded_train_step
    from cpu_ray_tracer_tpu.parallel.mesh import make_mesh, replicate_scene
    from cpu_ray_tracer_tpu.render import pathtracer
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    xml = _upstream_xml("different_size_scene.xml")
    scene, info = compile_scene(xml, layout="tlas", bilinear=True)
    n_dev = len(jax.devices())
    width = 64 * n_dev if small else 128 * n_dev
    cam = make_camera(width, 48 if small else 96)
    mesh = make_mesh()
    scene = replicate_scene(scene, mesh)

    # Common-random-numbers objective: K target images
    # are rendered at the TRUE parameters with seeds 0..K-1; training step i
    # re-renders with seed i%K and compares against target i%K — identical
    # RNG streams make each per-seed objective deterministic with a zero at
    # the true parameters, so the loss trace shows real convergence instead
    # of fresh-MC-noise draws.  Targets use differentiable=True so the
    # candidate and target go through the SAME numeric path.
    n_crn = 2 if small else 4
    targets = jnp.stack([
        pathtracer.render_pass_jit(
            scene, cam, jnp.uint32(k), depth_limit=2, differentiable=True
        )[0]
        for k in range(n_crn)
    ])
    # BASELINE config 5 says "optimize materials/textures": texels included
    params = grad_mod.extract_params(scene, keys=("albedo", "light_color", "texels"))
    params = {k: v * 0.5 for k, v in params.items()}  # perturb
    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_sharded_train_step(scene, cam, targets, opt, mesh, depth_limit=2)(params)
    t0 = time.perf_counter()
    losses = []
    for i in range(6 if small else 60):
        params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    # per-seed objectives differ in magnitude, so the honest endpoints are
    # full-CRN-cycle means (one visit of every seed) at the start and end
    head = sum(losses[:n_crn]) / n_crn
    tail = sum(losses[-n_crn:]) / n_crn
    _emit(5, scene=info.name, devices=n_dev, steps=len(losses), seconds=dt,
          loss_first=head, loss_last=tail,
          loss_first_step=losses[0], loss_last_step=losses[-1],
          crn_targets=n_crn, optimized=sorted(params.keys()),
          converging=tail < 0.5 * head,
          losses=[round(x, 5) for x in losses])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    from cpu_ray_tracer_tpu.utils.runtime import card_description, enable_compile_cache, require_gpu

    DEVICE.update(require_gpu())
    print(json.dumps({"card": card_description()}), flush=True)
    enable_compile_cache()
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    for c in [int(x) for x in args.configs.split(",")]:
        fns[c](args.small)


if __name__ == "__main__":
    main()
