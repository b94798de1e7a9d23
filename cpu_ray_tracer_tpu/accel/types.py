"""Flat SoA device representations of all acceleration structures.

The reference's pointer-based node graphs (infra/bvh.h, grid.h, kdtree.h)
become index-based flat arrays.  Traversal state per ray is a single int32
cursor (plus a tiny stack for the KD tree), which is what makes lockstep
batched traversal possible.

Key design choice — *threaded* (skip-link) BVHs: every node stores, for each
of the 8 ray-direction octants, the index of the next node to visit when its
AABB is hit (`hit_link`, = its near child for interior nodes) and when it is
missed or completed (`miss_link`, = skip over the subtree).  Ordered
near-child-first traversal then needs NO per-ray stack at all; per step a ray
gathers one node record and moves its cursor.  The 8 octant link tables
reproduce the reference's distance-ordered descent (infra/bvh.cpp:245-249)
statically.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.utils import struct


@struct.dataclass
class TrianglePool:
    """All triangles of a scene (or of all BLAS instances, concatenated),
    world space, SoA.  e1/e2 are precomputed Möller–Trumbore edges."""

    v0: jnp.ndarray  # [N, 3]
    e1: jnp.ndarray  # [N, 3] = v1 - v0
    e2: jnp.ndarray  # [N, 3] = v2 - v0
    n0: jnp.ndarray  # [N, 3] vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # [N, 2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    obj_id: jnp.ndarray  # [N] int32 object id (>= 2 for mesh instances)
    mat_id: jnp.ndarray  # [N] int32 into the scene MaterialTable
    # fused shading record [N, 16]: n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2)
    # obj(1) — ONE gather serves the whole hit-interpolation path in place
    # of six separate [tid] gathers
    shade: jnp.ndarray = None

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@struct.dataclass
class BVHArrays:
    """Threaded flat BVH.  `tri_count == 0` marks interior nodes, matching
    the reference's BVHNode (infra/blas_bvh.h:13-20); `left_first` is the
    first slot into `tri_indices` for leaves (child links live in the
    threaded link tables instead)."""

    node_min: jnp.ndarray  # [M, 3]
    node_max: jnp.ndarray  # [M, 3]
    left_first: jnp.ndarray  # [M] int32
    tri_count: jnp.ndarray  # [M] int32
    hit_link: jnp.ndarray  # [8, M] int32; -1 terminates
    miss_link: jnp.ndarray  # [8, M] int32
    tri_indices: jnp.ndarray  # [N] int32 permutation into the triangle pool
    max_leaf: int = struct.field(pytree_node=False, default=2)
    max_depth: int = struct.field(pytree_node=False, default=0)
    root: int = struct.field(pytree_node=False, default=0)

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


@struct.dataclass
class GridArrays:
    """Uniform grid with CSR cell lists (infra/grid.cpp:4-54 semantics)."""

    bounds_min: jnp.ndarray  # [3]
    bounds_max: jnp.ndarray  # [3]
    resolution: tuple = struct.field(pytree_node=False)  # (rx, ry, rz) static
    cell_start: jnp.ndarray  # [C + 1] int32 CSR offsets
    cell_tris: jnp.ndarray  # [K] int32 triangle ids (multi-inserted)
    max_cell_len: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class KDTreeArrays:
    """Flat KD tree (midpoint split, straddle duplication —
    infra/kdtree.cpp:45-108 semantics).  Interior: split_axis in {0,1,2},
    children at left/right.  Leaf: split_axis == -1, tris in CSR range
    [first, first + count) of `tri_ids`."""

    split_axis: jnp.ndarray  # [M] int32, -1 = leaf
    split_dist: jnp.ndarray  # [M] float32
    left: jnp.ndarray  # [M] int32
    right: jnp.ndarray  # [M] int32
    first: jnp.ndarray  # [M] int32
    count: jnp.ndarray  # [M] int32
    tri_ids: jnp.ndarray  # [K] int32 (duplicated for straddlers)
    bounds_min: jnp.ndarray  # [3] root bounds
    bounds_max: jnp.ndarray  # [3]
    max_depth: int = struct.field(pytree_node=False, default=20)
    max_leaf: int = struct.field(pytree_node=False, default=2)


@dataclasses.dataclass
class BuildStats:
    """Host-side build instrumentation, mirroring the reference's buildTime
    μs + maxDepth (infra/bvh.cpp:6,22-23,111)."""

    build_time_us: int = 0
    max_depth: int = 0
    num_nodes: int = 0
    num_leaves: int = 0
    max_leaf: int = 0


def to_device_f32(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.ascontiguousarray(x, np.float32))


def to_device_i32(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.ascontiguousarray(x, np.int32))
