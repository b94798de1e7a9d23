"""Regenerate the committed golden images under tests/goldens/.

- whitted_cube_48x32.npy     : scalar-oracle (tests/oracle.py) Whitted render
  of assets/scenes/cube_scene.xml, the stand-in cube from
  tools/make_substitute_assets.py.
- pt_cube_seed11_32x24.npy   : fixed-seed path-tracer pass (salt 11) on the
  same scene, rendered on the CPU backend (regression pin for the estimator).
- inside_whitted_160x100.npy, inside_pt_64x40_pass0.npy : the same two
  renders of the upstream inside_scene.xml (reference default scene,
  2. WhittedStyle/renderer.h:57) at a realistic scale.  Only written when
  CRT_UPSTREAM_ASSETS points at the reference's assets/ tree.

Regenerate only when an intentional behaviour change lands, and say which
goldens changed and why.

Run from repo root: JAX_PLATFORMS=cpu python tools/gen_goldens.py
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cpu_ray_tracer_tpu.core import camera as cam_mod  # noqa: E402
from cpu_ray_tracer_tpu.io.scene_xml import UPSTREAM_ASSETS  # noqa: E402
from cpu_ray_tracer_tpu.render import pathtracer  # noqa: E402
from cpu_ray_tracer_tpu.scene.build import compile_scene  # noqa: E402
from tests.oracle import WhittedOracle  # noqa: E402

CUBE_XML = os.path.join(REPO, "assets", "scenes", "cube_scene.xml")
OUT_DIR = os.path.join(REPO, "tests", "goldens")


def write_pair(xml, name, whitted_wh, whitted_name, pt_wh, pt_salt, pt_name):
    scene, info = compile_scene(xml, layout="tlas")
    print(f"{name}: {info.triangle_count} tris, {info.object_count} objects", flush=True)
    t0 = time.time()
    img = WhittedOracle(scene).render(cam_mod.make_camera(*whitted_wh))
    path = os.path.join(OUT_DIR, whitted_name)
    np.save(path, img)
    print(f"  {path}: oracle Whitted in {time.time()-t0:.1f}s, mean={img.mean():.4f}", flush=True)
    t0 = time.time()
    img_pt, _ = pathtracer.render_pass(scene, cam_mod.make_camera(*pt_wh), jnp.uint32(pt_salt))
    path = os.path.join(OUT_DIR, pt_name)
    np.save(path, np.asarray(img_pt))
    print(f"  {path}: PT pass in {time.time()-t0:.1f}s, mean={np.asarray(img_pt).mean():.4f}", flush=True)


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    write_pair(
        CUBE_XML, "cube", (48, 32), "whitted_cube_48x32.npy",
        (32, 24), 11, "pt_cube_seed11_32x24.npy",
    )
    inside = os.path.join(UPSTREAM_ASSETS, "scenes", "inside_scene.xml") if UPSTREAM_ASSETS else ""
    if inside and os.path.isfile(inside):
        write_pair(
            inside, "inside", (160, 100), "inside_whitted_160x100.npy",
            (64, 40), 0, "inside_pt_64x40_pass0.npy",
        )
    else:
        print("inside_scene goldens skipped: CRT_UPSTREAM_ASSETS does not hold scenes/inside_scene.xml")


if __name__ == "__main__":
    main()
