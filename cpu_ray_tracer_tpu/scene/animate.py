"""Animated / mutable scenes: the SetTransform + SetTime + Refit capability
(BLASBVH::SetTransform blas_bvh.cpp:363-374, BVH::Refit bvh.cpp:26-43,
BaseScene::SetTime).

On the device the scene is immutable data, so "mutating" a transform
means re-baking on host and shipping fresh arrays.  With the native C++
builder a full rebuild of a 10k-triangle scene takes ~10ms — on these scene
sizes rebuild IS the refit story; `refit` (topology-preserving bounds sweep)
exists for much larger scenes where a SAH rebuild would dominate.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracer_tpu.io.scene_xml import SceneSpec, load_scene_xml
from cpu_ray_tracer_tpu.scene.build import compile_scene


class AnimatedScene:
    """Holds the host-side scene spec; `set_transform` / `set_time` mutate it
    and `build()` emits a fresh DeviceScene (jit caches stay valid — shapes
    are unchanged as long as the object set is)."""

    def __init__(self, xml_path: str | None = None, spec: SceneSpec | None = None, **compile_opts):
        self.spec = spec if spec is not None else load_scene_xml(xml_path)
        self.compile_opts = compile_opts
        self.anim_time = 0.0

    def set_transform(self, obj_index: int, position=None, rotation_deg=None, scale=None):
        o = self.spec.objects[obj_index]
        if position is not None:
            o.position = np.asarray(position, np.float32)
        if rotation_deg is not None:
            o.rotation = np.asarray(rotation_deg, np.float32)
        if scale is not None:
            o.scale = np.asarray(scale, np.float32)

    def set_light_position(self, position):
        self.spec.light_pos = np.asarray(position, np.float32)

    def set_time(self, t: float):
        """FileScene::SetTime parity: stores animTime (the reference's XML
        scenes animate nothing by default — the quad-light swing is commented
        out, tlas_file_scene.cpp:18)."""
        self.anim_time = t

    def build(self):
        return compile_scene(spec=self.spec, **self.compile_opts)

    def update(self, scene):
        """Cheap per-frame update.  For instancing="shared" scenes this is
        the O(1) SetTransform the reference gets from BLASBVH (new matrices
        + world AABBs only — no BVH rebuild, no geometry re-bake); other
        layouts fall back to a full host rebuild."""
        if getattr(scene, "shared", None) is not None:
            return update_shared_transforms(scene, self.spec)
        return self.build()[0]


def update_shared_transforms(scene, spec: SceneSpec):
    """Recompute instance matrices + world AABBs from the (mutated) spec and
    swap the SharedInstances tables in place of the old ones.  Host cost is
    a handful of 4x4 inverses; device cost is uploading [I, 4, 4] tables.
    jit caches stay valid: shapes and static fields are unchanged."""
    from cpu_ray_tracer_tpu.accel.types import to_device_f32
    from cpu_ray_tracer_tpu.scene.build import _transform_aabb, instance_matrices

    sh = scene.shared
    n_inst = len(spec.objects)
    minv = np.zeros((n_inst, 4, 4), np.float32)
    nrm = np.zeros((n_inst, 3, 3), np.float32)
    amin = np.zeros((n_inst, 3), np.float32)
    amax = np.zeros((n_inst, 3), np.float32)
    for i, obj in enumerate(spec.objects):
        m, mi, nr = instance_matrices(obj)
        minv[i] = mi
        nrm[i] = nr
        bmin, bmax = sh.mesh_bounds[sh.inst_mesh[i]]
        amin[i], amax[i] = _transform_aabb(np.asarray(bmin), np.asarray(bmax), m)
    # world_min/world_max are STATIC fields (they key jit caches): leave
    # them at build-time values — they only seed the Morton sort
    # quantization, where slightly stale bounds cost sort quality, not
    # correctness
    sh = sh.replace(
        inst_minv=to_device_f32(minv),
        inst_nrm=to_device_f32(nrm),
        inst_aabb_min=to_device_f32(amin),
        inst_aabb_max=to_device_f32(amax),
    )
    return scene.replace(shared=sh)
