"""Batched geometric intersection primitives (pure jnp, elementwise).

These are the batched analogs of the reference's scalar/SSE tests:
Möller–Trumbore (infra/bvh.cpp:203-222), the slab AABB test
(infra/bvh.cpp:181-190), and the closed-form quad/plane intersectors
(template/primitives.h:100-179, :321-375).  Everything is branchless — masks
instead of early returns — and differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.core import vecmath as vm


def moller_trumbore(o, d, v0, e1, e2, t_max):
    """Batched Möller–Trumbore.

    o, d: [..., 3] ray origin/direction; v0, e1, e2: [..., 3] triangle data
    (broadcast-compatible); t_max: [...] current nearest t.

    Returns (t, u, v, hit_mask).  Semantics of infra/bvh.cpp:203-222:
    determinant within ±1e-4 rejected, u/v in [0,1], u+v <= 1, t > 1e-4 and
    t < t_max.
    """
    h = jnp.cross(d, e2)
    a = vm.dot(e1, h)
    f = 1.0 / jnp.where(jnp.abs(a) < np.float32(1e-30), np.float32(1e-30), a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = jnp.cross(s, e1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(e2, q)
    hit = (
        (jnp.abs(a) >= constants.TRI_EPS)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > constants.TRI_EPS)
        & (t < t_max)
    )
    return t, u, v, hit


def slab_aabb(o, rd, t_max, bmin, bmax):
    """Batched slab test returning (tmin, hit).  Parity with the reference's
    BVH_FASTER_RAY variant (infra/bvh.cpp:181-190): hit iff
    tmax' >= tmin' and tmin' < ray.t and tmax' > 0."""
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tsmall = jnp.minimum(t1, t2)
    tbig = jnp.maximum(t1, t2)
    tmin = jnp.max(tsmall, axis=-1)
    tmax_ = jnp.min(tbig, axis=-1)
    hit = (tmax_ >= tmin) & (tmin < t_max) & (tmax_ > 0.0)
    return tmin, hit


def plane(o, d, n, dist, t_max):
    """Infinite plane `dot(P, n) + dist = 0` (template/primitives.h:107-111).

    Returns (t, hit) with hit iff 0 < t < t_max.
    """
    denom = vm.dot(d, n)
    denom = jnp.where(jnp.abs(denom) < np.float32(1e-20), np.float32(1e-20), denom)
    t = -(vm.dot(o, n) + dist) / denom
    hit = (t < t_max) & (t > 0.0)
    return t, hit


def plane_uv(p, inv_texture_offset):
    """Floor-plane UV for +Y planes (template/primitives.h:117-133):
    u = frac(x * invto), v = frac(z * invto)."""
    u = p[..., 0] * inv_texture_offset
    v = p[..., 2] * inv_texture_offset
    return jnp.stack([u - jnp.floor(u), v - jnp.floor(v)], axis=-1)


def quad(o, d, inv_t, size, t_max):
    """Oriented quad in its local XZ plane at y=0, half-extent `size`
    (template/primitives.h:321-345).  `inv_t` is the quad's inverse
    transform [4, 4] (row-major).  Returns (t, hit)."""
    oy = o[..., 0] * inv_t[1, 0] + o[..., 1] * inv_t[1, 1] + o[..., 2] * inv_t[1, 2] + inv_t[1, 3]
    dy = d[..., 0] * inv_t[1, 0] + d[..., 1] * inv_t[1, 1] + d[..., 2] * inv_t[1, 2]
    dy = jnp.where(jnp.abs(dy) < np.float32(1e-20), np.float32(1e-20), dy)
    t = oy / -dy
    ox = o[..., 0] * inv_t[0, 0] + o[..., 1] * inv_t[0, 1] + o[..., 2] * inv_t[0, 2] + inv_t[0, 3]
    oz = o[..., 0] * inv_t[2, 0] + o[..., 1] * inv_t[2, 1] + o[..., 2] * inv_t[2, 2] + inv_t[2, 3]
    dx = d[..., 0] * inv_t[0, 0] + d[..., 1] * inv_t[0, 1] + d[..., 2] * inv_t[0, 2]
    dz = d[..., 0] * inv_t[2, 0] + d[..., 1] * inv_t[2, 1] + d[..., 2] * inv_t[2, 2]
    ix = ox + t * dx
    iz = oz + t * dz
    hit = (
        (t < t_max)
        & (t > 0.0)
        & (ix > -size)
        & (ix < size)
        & (iz > -size)
        & (iz < size)
    )
    return t, hit


def brute_force_nearest(o, d, t0, v0, e1, e2):
    """Testing oracle: intersect every ray against every triangle.

    o/d [R, 3]; v0/e1/e2 [N, 3].  Returns (t [R], u, v, tri_idx [R] int32,
    tri_idx == -1 on miss).  O(R*N) — tiny scenes/tests only.
    """
    t, u, v, hit = moller_trumbore(
        o[:, None, :], d[:, None, :], v0[None], e1[None], e2[None], t0[:, None]
    )
    t = jnp.where(hit, t, constants.RAY_FAR)
    best = jnp.argmin(t, axis=1)
    r = jnp.arange(o.shape[0])
    best_t = t[r, best]
    found = best_t < t0
    return (
        jnp.where(found, best_t, t0),
        jnp.where(found, u[r, best], 0.0),
        jnp.where(found, v[r, best], 0.0),
        jnp.where(found, best.astype(jnp.int32), -1),
    )
