"""SoA ray batches and hit records.

The reference's per-ray struct (template/ray.h:6-41) becomes a pytree of
flat arrays over a ray batch: the batch dimension is the device's unit of
parallelism (what OpenMP scanlines / 16x16 tile jobs were on the CPU).
"""

from __future__ import annotations

import jax.numpy as jnp

from cpu_ray_tracer_tpu.utils import struct

from cpu_ray_tracer_tpu import constants


@struct.dataclass
class Rays:
    """A batch of N rays in SoA layout.

    o, d: [N, 3] origin / unit direction.
    t: [N] current nearest-hit distance (init RAY_FAR).
    bary: [N, 2] barycentric (u, v) of the nearest triangle hit.
    obj_idx: [N] int32 object id (-1 = miss; 0 = quad light, 1 = floor plane,
        >= 2 = mesh instances) — same id convention as the reference
        (tlas_file_scene.cpp:13-16).
    tri_idx: [N] int32 triangle index within the global/per-BLAS pool.
    inside: [N] bool, ray currently travels inside a medium.
    traversed / tested: [N] int32 instrumentation counters
        (template/ray.h:38-39).
    """

    o: jnp.ndarray
    d: jnp.ndarray
    t: jnp.ndarray
    bary: jnp.ndarray
    obj_idx: jnp.ndarray
    tri_idx: jnp.ndarray
    inside: jnp.ndarray
    traversed: jnp.ndarray
    tested: jnp.ndarray

    @property
    def rd(self) -> jnp.ndarray:
        """Reciprocal direction (template/ray.h:19), computed on demand —
        a recompute is cheaper than carrying 12 more bytes per ray
        through HBM."""
        return 1.0 / self.d

    @property
    def n(self) -> int:
        return self.o.shape[0]

    def hit_points(self) -> jnp.ndarray:
        """I = O + t*D (template/ray.h IntersectionPoint)."""
        return self.o + self.t[..., None] * self.d


def make_rays(o: jnp.ndarray, d: jnp.ndarray, t=None, inside=None) -> Rays:
    n = o.shape[0]
    if t is None:
        t = jnp.full((n,), constants.RAY_FAR, jnp.float32)
    elif jnp.ndim(t) == 0:
        t = jnp.full((n,), t, jnp.float32)
    if inside is None:
        inside = jnp.zeros((n,), jnp.bool_)
    return Rays(
        o=o.astype(jnp.float32),
        d=d.astype(jnp.float32),
        t=t,
        bary=jnp.zeros((n, 2), jnp.float32),
        obj_idx=jnp.full((n,), -1, jnp.int32),
        tri_idx=jnp.full((n,), -1, jnp.int32),
        inside=inside,
        traversed=jnp.zeros((n,), jnp.int32),
        tested=jnp.zeros((n,), jnp.int32),
    )


@struct.dataclass
class HitRecords:
    """Shading inputs per ray, the SoA form of HitInfo
    (infra/hit_info.h:3-11): geometric normal (back-face flipped), uv,
    material id.  mat_id indexes the scene's MaterialTable; the table's
    slots 0/1 are the light/floor primitive materials."""

    normal: jnp.ndarray  # [N, 3]
    uv: jnp.ndarray  # [N, 2]
    mat_id: jnp.ndarray  # [N] int32
