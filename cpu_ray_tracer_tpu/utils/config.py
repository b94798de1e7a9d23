"""Single render configuration dataclass + CLI override parsing.

Everything the reference spreads across compile-time #defines
(USE_BVH/TLAS_USE_*/BVH_SAH/BVH_BINS/SCRWIDTH/EPSILON, README.md:42-54),
the scene XML path (hardcoded in renderer headers) and ImGui runtime toggles
becomes one dataclass, overridable from the command line (SURVEY.md §5
config system).
"""

from __future__ import annotations

import argparse
import dataclasses

from cpu_ray_tracer_tpu import constants


@dataclasses.dataclass
class RenderConfig:
    # scene
    scene_xml: str = ""
    layout: str = "tlas"  # "tlas" (TLASFileScene) | "mono" (FileScene)
    accel: str = "bvh"  # "bvh" | "grid" | "kdtree"
    # "baked" = world-baked fused forest (fastest traversal);
    # "shared" = object-space shared-BLAS instancing (O(1) transforms,
    # N instances share one BLAS — blas_bvh.cpp:376-389 semantics)
    instancing: str = "baked"
    parity: bool = False  # replicate all reference quirks bit-for-bit
    shadow_quirk: bool = True
    bilinear: bool = False
    force_split_cap: int | None = 4  # None = reference SAH stopping exactly
    # camera / film
    width: int = constants.SCRWIDTH
    height: int = constants.SCRHEIGHT
    cam_pos: tuple = (0.0, 0.0, -2.0)
    cam_target: tuple = (0.0, 0.0, -1.0)
    # integrator
    integrator: str = "pathtracer"  # "whitted" | "pathtracer" | "basics"
    aov: str = "albedo"  # for basics
    depth_limit: int = constants.DEPTH_LIMIT
    spp: int = 16
    passes_per_step: int = 1  # spp per progressive step (ImGui slider 1..4)
    # 0.25 measured best first-try on the shipped reflective scenes (zero
    # drops; grow-or-fail covers heavier trees) — see render/whitted.py
    whitted_cap_factor: float = 0.25
    # grow-or-fail: re-render with doubled child capacity until nothing is
    # dropped (never silently biases); off = single render + loud WARNING
    whitted_grow_cap: bool = True
    # output / observability
    out: str = "out.png"
    checkpoint: str = ""  # path for progressive film checkpoints
    checkpoint_every: int = 0  # passes between checkpoints (0 = off)
    metrics_jsonl: str = ""  # per-step metrics log
    # distribution
    n_devices: int = 0  # 0 = all visible devices
    sharded: bool = False

    def build_scene(self):
        from cpu_ray_tracer_tpu.scene.build import compile_scene

        return compile_scene(
            self.scene_xml,
            layout=self.layout,
            accel=self.accel,
            parity=self.parity,
            bilinear=self.bilinear,
            force_split_cap=self.force_split_cap,
            shadow_quirk=self.shadow_quirk,
            instancing=self.instancing,
        )

    def build_camera(self):
        from cpu_ray_tracer_tpu.core.camera import make_camera

        return make_camera(self.width, self.height, self.cam_pos, self.cam_target)


def _add_args(parser: argparse.ArgumentParser):
    for f in dataclasses.fields(RenderConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=f.default)
        elif f.name in ("cam_pos", "cam_target"):
            parser.add_argument(name, type=lambda s: tuple(float(x) for x in s.split(",")),
                                default=f.default)
        elif f.name == "force_split_cap":
            parser.add_argument(name, type=lambda s: None if s == "none" else int(s),
                                default=f.default)
        else:
            parser.add_argument(name, type=type(f.default) if f.default is not None else str,
                                default=f.default)


def parse_args(argv=None) -> RenderConfig:
    parser = argparse.ArgumentParser(description="Differentiable ray tracer in JAX")
    _add_args(parser)
    ns = parser.parse_args(argv)
    return RenderConfig(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(RenderConfig)})
