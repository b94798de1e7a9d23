"""Device scene: everything a render kernel needs, as one pytree.

The reference's `BaseScene` virtual interface (infra/scene/base_scene.h:16-32)
becomes a dataclass + pure functions in scene/query.py.  Every scene variant
(FileScene-monolithic, TLASFileScene-instanced, PrimitiveScene) compiles to
this same structure, so integrators are scene-agnostic — the duck-typing
parity of the reference's interchangeable accelerators, done with data
instead of virtual dispatch.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from cpu_ray_tracer_tpu.utils import struct

from cpu_ray_tracer_tpu.accel.types import BVHArrays, BuildStats, TrianglePool
from cpu_ray_tracer_tpu.core.materials import MaterialTable
from cpu_ray_tracer_tpu.core.textures import TextureAtlas


@struct.dataclass
class SharedInstances:
    """Object-space shared-BLAS instancing tables (layout="tlas",
    instancing="shared").

    The reference's BLASBVH transforms each ray into object space per
    instance inside the traversal (blas_bvh.cpp:376-389), letting N
    instances share one BLAS and making SetTransform O(1).  Here: one
    object-space BVH per UNIQUE MESH, and traversal runs one masked pass per
    instance — the whole ray batch is transformed by the instance's inverse
    matrix (a vectorized 3x4 multiply), rays whose world AABB interval
    cannot beat the running best t are masked off, and the per-ray best hit
    chains through the passes exactly like the reference's shared
    `hitInfo.t`.  Direction vectors are NOT renormalized in object space,
    so t is the same scalar in both spaces (any invertible TRS).  The
    instance table + AABB early-out takes the role of the reference's
    agglomerative TLAS tree (tlas_bvh.cpp:17-70).

    Known, bounded semantic difference vs the baked forest (diagnosed r3,
    tests/test_instancing.py::test_bench_scale_multi_mesh verifies the
    mechanism per disagreeing ray): Möller–Trumbore runs in UNSCALED object
    space here, where a grazing sliver's determinant is ~s^3 larger than in
    world space, so a world-|det| just under TRI_EPS (1e-4, the reference's
    cutoff, infra/bvh.cpp:203-222) can be legitimately ACCEPTED.  The
    reference's BLASBVH bakes the scale matrix into its object-space verts
    (blas_bvh.cpp:61-76) and keeps world-frame conditioning; measured
    disagreement is ~1e-3 of rays on an adversarial multi-scale scene, and
    every such hit is real geometry.
    """

    inst_minv: jnp.ndarray  # [I, 4, 4] world -> object (full TRS inverse)
    inst_nrm: jnp.ndarray  # [I, 3, 3] inverse-transpose linear (obj normal -> world)
    inst_aabb_min: jnp.ndarray  # [I, 3] world AABB per instance
    inst_aabb_max: jnp.ndarray  # [I, 3]
    inst_obj: jnp.ndarray  # [I] i32 object id (2 + i)
    inst_mat: jnp.ndarray  # [I] i32 material slot
    # static: instance -> mesh slot, and scene world bounds for the
    # Morton compaction key (render/pathtracer._compaction_perm)
    inst_mesh: tuple = struct.field(pytree_node=False, default=())
    world_min: tuple = struct.field(pytree_node=False, default=(0.0, 0.0, 0.0))
    world_max: tuple = struct.field(pytree_node=False, default=(1.0, 1.0, 1.0))
    # per-mesh object-space root AABBs ((min3, max3) tuples) — all that's
    # needed to recompute instance world AABBs on a transform change
    mesh_bounds: tuple = struct.field(pytree_node=False, default=())
    bvhs: tuple = None  # per-mesh BVHArrays


@struct.dataclass
class DeviceScene:
    tris: TrianglePool
    bvh: BVHArrays
    materials: MaterialTable
    atlas: TextureAtlas
    # quad light (objIdx 0): Quad(0, 1) at light_t (tlas_file_scene.cpp:15-19)
    light_t: jnp.ndarray  # [4, 4]
    light_inv_t: jnp.ndarray  # [4, 4]
    light_size: jnp.ndarray  # [] half-extent (0.5 for Quad(0, 1))
    light_color: jnp.ndarray  # [3] (24, 24, 22)
    # floor plane (objIdx 1): Plane(1, +Y, d=1) (tlas_file_scene.cpp:16)
    floor_inv_to: jnp.ndarray  # [] 1 / textureOffset = 100 / texture_width
    # static config
    accel_kind: str = struct.field(pytree_node=False, default="bvh")
    skydome_tex: int = struct.field(pytree_node=False, default=-1)
    has_floor: bool = struct.field(pytree_node=False, default=True)
    has_light: bool = struct.field(pytree_node=False, default=True)
    bilinear: bool = struct.field(pytree_node=False, default=False)
    # IsOccluded quirk (file_scene.cpp:177-187): shadow rays ignore their max
    # distance for triangle geometry.  Kept on for image parity.
    shadow_quirk: bool = struct.field(pytree_node=False, default=True)
    # alternate accelerators (USE_Grid / USE_KDTree) — populated when
    # accel_kind selects them; the BVH arrays are always present (tiny) so
    # pytree structure stays stable
    grid: object = None  # GridArrays
    kd: object = None  # KDTreeArrays
    # object-space shared-BLAS instancing tables (instancing="shared");
    # when present, traversal runs the masked per-instance pass loop and
    # `tris` holds the OBJECT-SPACE unique-mesh pool
    shared: SharedInstances | None = None
    # BVH walk implementation (scene/query.traverse_bvh): "auto" runs the
    # CUDA kernel when the program is lowered for a GPU and the XLA walk
    # everywhere else; "xla" pins the XLA walk on every platform, which is
    # what the kernel is compared against on the card.
    traversal: str = struct.field(pytree_node=False, default="auto")


@dataclasses.dataclass
class SceneInfo:
    """Host-side scene metadata (counts, build stats) — the data behind the
    reference's ImGui panel (GetTriangleCount / GetBuildTime /
    GetMaxTreeDepth)."""

    name: str
    triangle_count: int
    object_count: int
    build_stats: BuildStats
    blas_stats: list = dataclasses.field(default_factory=list)

    @property
    def build_time_us(self) -> int:
        return self.build_stats.build_time_us + sum(s.build_time_us for s in self.blas_stats)

    @property
    def max_tree_depth(self) -> int:
        depths = [self.build_stats.max_depth] + [s.max_depth for s in self.blas_stats]
        return max(depths)
