"""Path-traced pass throughput: rays/s on one GPU, 1280x720 on the
bunny+teapot TLAS scene, depth 5.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": "...", "value": N, "unit": "rays/s", "device": {...}, "detail": {...}}

Rays counted = every path segment actually traced (primary + bounces; the
path tracer casts no shadow rays), i.e. rays cast per second rather than the
reference's pixels/ms (which counts primary rays only —
1. Basics/renderer.cpp:54-55).  The run fails without a GPU: a CPU number
is never reported under this metric.

Environment knobs: BENCH_SPP (64), BENCH_WIDTH (1280), BENCH_HEIGHT (720),
BENCH_SPB samples per megapass (1).
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

WIDTH, HEIGHT = 1280, 720
SPP = 64


def main():
    import jax
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.render import pathtracer
    from cpu_ray_tracer_tpu.scene.build import compile_scene
    from cpu_ray_tracer_tpu.utils.metrics import runtime_flags
    from cpu_ray_tracer_tpu.utils.runtime import card_description, enable_compile_cache, require_gpu

    device = require_gpu()
    print(f"card: {card_description()}")
    enable_compile_cache()

    spp = int(os.environ.get("BENCH_SPP", SPP))
    width = int(os.environ.get("BENCH_WIDTH", WIDTH))
    height = int(os.environ.get("BENCH_HEIGHT", HEIGHT))
    spb = int(os.environ.get("BENCH_SPB", "1"))  # samples per megapass
    if spp % spb:
        raise SystemExit("BENCH_SPP must be divisible by BENCH_SPB")

    t0 = time.perf_counter()
    scene, info = compile_scene(
        os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml"), layout="tlas"
    )
    scene_s = time.perf_counter() - t0
    camera = cam_mod.make_camera(width, height, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))

    # One jitted program per progressive pass; only scalar reductions cross
    # to the host.  The scene is a jit ARGUMENT, not a closure: closed-over
    # scenes become inlined constants and bloat the program.
    @jax.jit
    def one_pass(scene, film, nrays, spp_idx):
        img, stats = pathtracer.render_pass(scene, camera, spp_idx, samples_per_pass=spb)
        return film + img, nrays + stats["rays_traced"].astype(jnp.float32)

    film = jnp.zeros((camera.height, camera.width, 3), jnp.float32)
    # compile + first run (salt 0 — the timed passes use salts 1..spp, so the
    # sample-stream set is identical for every BENCH_SPB factorization)
    t0 = time.perf_counter()
    jax.block_until_ready(one_pass(scene, film, jnp.float32(0.0), jnp.uint32(0)))
    compile_s = time.perf_counter() - t0

    nrays = jnp.float32(0.0)
    t0 = time.perf_counter()
    for p in range(spp // spb):
        film, nrays = one_pass(scene, film, nrays, jnp.uint32(p * spb + 1))
    energy = jnp.sum(film)
    energy.block_until_ready()
    dt = time.perf_counter() - t0

    total_rays = float(nrays)
    result = {
        "metric": "path_trace_rays_per_s",
        "value": total_rays / dt,
        "unit": "rays/s",
        "device": device,
        "detail": {
            "resolution": [width, height],
            "spp": spp,
            "samples_per_pass": spb,
            "seconds": dt,
            "setup_seconds": {"scene": scene_s, "compile_and_first_pass": compile_s},
            "total_rays": total_rays,
            "triangles": info.triangle_count,
            "energy": float(energy) / spp,
            **runtime_flags(),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
