"""Whitted child-buffer overflow must be impossible to miss (VERDICT r4
weak #4 / ask #5): a child dropped at the capacity silently darkens
mirror/glass pixels, so the DEFAULT fixed-cap path must render every
shipped scene drop-free, and the renderer must report the count.

The reference has no cap at all — its recursion allocates stack frames
(2. WhittedStyle/renderer.cpp:54-72); our wavefront bounds the tree with
static buffers, so the bound needs a guarantee.
"""

import os

import pytest

from cpu_ray_tracer_tpu.core import camera as cam_mod
from cpu_ray_tracer_tpu.render import whitted
from cpu_ray_tracer_tpu.scene.build import compile_scene

from tests.conftest import OUR_ASSETS, upstream_asset

SCENES = [
    "base_scene.xml",
    "different_size_scene.xml",
    "inside_scene.xml",
    "uniform_distributed_scene.xml",
    "bunny_teapot.xml",
]
BENCH_XML = os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml")


def scene_path(xml):
    """The repo's own scene, or the upstream one (skips when absent)."""
    ours = os.path.join(OUR_ASSETS, "scenes", xml)
    return ours if os.path.isfile(ours) else upstream_asset(f"scenes/{xml}")


@pytest.mark.parametrize("xml", SCENES)
def test_default_cap_renders_drop_free(xml):
    """The four upstream scenes and the bench scene at the DEFAULT
    cap_factor: dropped == 0.

    384x240 keeps the level caps above the 8192 floor for the first two
    levels, so the cap FRACTION under test matches full resolution (both
    the child count and the capacity scale with the pixel count)."""
    scene, _ = compile_scene(scene_path(xml), layout="tlas")
    cam = cam_mod.make_camera(384, 240)
    out = whitted.render_jit(scene, cam)
    assert int(out["dropped"]) == 0, (
        f"{xml}: {int(out['dropped'])} children dropped at the default "
        "cap_factor — image is silently darkened"
    )


def test_dropped_is_reported_and_adaptive_recovers():
    """A deliberately starved cap must (a) report a nonzero dropped count
    from the fixed path and (b) be healed by render_adaptive's grow loop
    (dropped == 0 at the returned cap_factor)."""
    scene, _ = compile_scene(BENCH_XML, layout="tlas")
    cam = cam_mod.make_camera(128, 80)
    # the bench scene's mirror (0.9) and glass (0.9) teapots emit children
    # on primary hits.  A cap this small cannot hold them.
    starved = whitted.render_jit(scene, cam, cap_factor=0.01)
    assert int(starved["dropped"]) > 0
    healed = whitted.render_adaptive(scene, cam, cap_factor=0.01)
    assert int(healed["dropped"]) == 0
    assert healed["cap_factor"] > 0.01
