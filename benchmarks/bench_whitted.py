"""Whitted frame time on one GPU at the reference's own 1024x640
(2. WhittedStyle/renderer.cpp:169-171 methodology: ms/frame and
MRays/s = W*H/ms, primary rays only).

Scene: the bunny+teapot bench scene, or the upstream inside_scene when
CRT_UPSTREAM_ASSETS points at the reference's assets/ tree.  Compilation
(and any child-buffer growth of render_adaptive) is set-up; the frame time
is the median of REPS timed frames, each ending in block_until_ready, and
every frame time is printed so the spread is visible.  Fails without a GPU.

Usage: python benchmarks/bench_whitted.py
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

W, H = 1024, 640
REPS = 10


def main():
    import jax
    import numpy as np

    from cpu_ray_tracer_tpu import constants
    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.io.scene_xml import UPSTREAM_ASSETS
    from cpu_ray_tracer_tpu.render import whitted
    from cpu_ray_tracer_tpu.scene.build import compile_scene
    from cpu_ray_tracer_tpu.utils.metrics import runtime_flags
    from cpu_ray_tracer_tpu.utils.runtime import card_description, enable_compile_cache, require_gpu

    device = require_gpu()
    print(f"card: {card_description()}")
    enable_compile_cache()

    inside = os.path.join(UPSTREAM_ASSETS, "scenes", "inside_scene.xml") if UPSTREAM_ASSETS else ""
    if inside and os.path.isfile(inside):
        scene, info = compile_scene(inside, layout="tlas")
        cam = cam_mod.make_camera(W, H)
    else:
        scene, info = compile_scene(
            os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml"), layout="tlas"
        )
        cam = cam_mod.make_camera(W, H, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))

    # adaptive first frame: compiles and records the final cap_factor and
    # dropped count (a dropped child silently darkens mirror/glass pixels)
    t0 = time.perf_counter()
    first = whitted.render_adaptive(scene, cam)
    jax.block_until_ready(first["image"])
    setup_s = time.perf_counter() - t0
    cap = first["cap_factor"]

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = whitted.render_jit(
            scene, cam, depth_limit=constants.DEPTH_LIMIT, cap_factor=cap, differentiable=False
        )
        jax.block_until_ready(out["image"])
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    result = {
        "metric": "whitted_ms_per_frame",
        "value": ms,
        "unit": "ms",
        "device": device,
        "resolution": [W, H],
        "mrays_per_s_primary": (W * H / 1e6) / (ms / 1e3),
        "frame_ms": [t * 1e3 for t in times],
        "setup_seconds": setup_s,
        "scene": info.name,
        "triangles": info.triangle_count,
        "cap_factor": cap,
        "dropped": int(out["dropped"]),
        **runtime_flags(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
