"""Batched analytic-primitive intersectors: Sphere, OBB Cube, Torus.

Vectorized ports of template/primitives.h — the reference's SSE fast paths
(SPEEDTRIX) become plain (8,128)-lane jnp math.  The quad and infinite plane
live in ops/intersect.py (they're used by every scene); these three are used
by the PrimitiveScene (the legacy hardcoded Cornell-style scene).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.core import vecmath as vm


def sphere(o, d, pos, r2, t_max):
    """Sphere with inside-hit support (primitives.h:37-59).

    Returns (t, hit).  Both the near root (-b - sqrt(d)) and, for origins
    inside (c <= 0), the far root (sqrt(d) - b) are considered.
    """
    oc = o - pos
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - r2
    disc = b * b - c
    valid = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = -b - sq
    t_far = sq - b
    near_ok = valid & (t_near > 0.0) & (t_near < t_max)
    # far root only when inside (c <= 0), reference ordering
    far_ok = valid & (~near_ok) & (c <= 0.0) & (t_far > 0.0) & (t_far < t_max)
    t = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, t_max))
    return t, near_ok | far_ok


def sphere_normal(p, pos, inv_r):
    return (p - pos) * inv_r


def cube(o, d, inv_m, bmin, bmax, t_max):
    """Oriented box: ray to object space, slab test; near hit preferred,
    far hit when inside (primitives.h:199-253).  Returns (t, hit)."""
    oo = vm.transform_position(o, inv_m)
    od = vm.transform_vector(d, inv_m)
    rd = 1.0 / od
    t1 = (bmin - oo) * rd
    t2 = (bmax - oo) * rd
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax_ = jnp.min(jnp.maximum(t1, t2), axis=-1)
    ok = tmin < tmax_
    near_ok = ok & (tmin > 0.0) & (tmin < t_max)
    far_ok = ok & (~(tmin > 0.0)) & (tmax_ > 0.0) & (tmax_ < t_max)
    t = jnp.where(near_ok, tmin, jnp.where(far_ok, tmax_, t_max))
    return t, near_ok | far_ok


def cube_normal(p, m, inv_m, bmin, bmax):
    """Axis of the closest face in object space, rotated to world
    (primitives.h:286-303)."""
    op = vm.transform_position(p, inv_m)
    dist = jnp.stack(
        [
            jnp.abs(op[..., 0] - bmin[0]),
            jnp.abs(op[..., 0] - bmax[0]),
            jnp.abs(op[..., 1] - bmin[1]),
            jnp.abs(op[..., 1] - bmax[1]),
            jnp.abs(op[..., 2] - bmin[2]),
            jnp.abs(op[..., 2] - bmax[2]),
        ],
        axis=-1,
    )
    face = jnp.argmin(dist, axis=-1)
    normals = jnp.asarray(
        [
            [-1, 0, 0], [1, 0, 0],
            [0, -1, 0], [0, 1, 0],
            [0, 0, -1], [0, 0, 1],
        ],
        jnp.float32,
    )
    n_obj = normals[face]
    return vm.transform_vector(n_obj, m)


def torus(o, d, inv_t, rc2, rt2, r2, t_max, newton_iters: int = 2):
    """Torus about the object-space z axis (Quilez quartic,
    primitives.h:389-470).  The reference solves in double; the device
    path stays in f32, so the f32 closed-form roots are polished with a couple of Newton
    steps on the quartic.  Returns (t, hit)."""
    oo = vm.transform_position(o, inv_t)
    od = vm.transform_vector(d, inv_t)
    m = vm.dot(oo, oo)
    k3 = vm.dot(oo, od)
    k32 = k3 * k3
    # bounding sphere
    bound = k32 - m + r2 >= 0.0

    k = (m - rt2 - rc2) * 0.5
    k2 = k32 + rc2 * od[..., 2] * od[..., 2] + k
    k1 = k * k3 + rc2 * oo[..., 2] * od[..., 2]
    k0 = k * k + rc2 * oo[..., 2] * oo[..., 2] - rc2 * rt2

    # double-root guard branch (po flip) — branchless via where
    flip = jnp.abs(k3 * (k32 - k2) + k1) < 1e-4
    k0_safe = jnp.where(jnp.abs(k0) < 1e-20, 1e-20, k0)
    k1f = jnp.where(flip, k3, k1)
    k3f = jnp.where(flip, k1, k3)
    inv_k0 = 1.0 / k0_safe
    k1n = jnp.where(flip, k1f * inv_k0, k1f)
    k2n = jnp.where(flip, k2 * inv_k0, k2)
    k3n = jnp.where(flip, k3f * inv_k0, k3f)
    k32n = k3n * k3n
    po = jnp.where(flip, -1.0, 1.0)

    c2 = (2.0 * k2n - 3.0 * k32n) * np.float32(0.33333333333)
    c1 = (k3n * (k32n - k2n) + k1n) * 2.0
    # in the flipped branch the reference replaces k0 with 1/k0 before
    # forming c0 (primitives.h:407-410)
    k0n = jnp.where(flip, inv_k0, k0)
    c0 = (k3n * (k3n * (-3.0 * k32n + 4.0 * k2n) - 8.0 * k1n) + 4.0 * k0n) * np.float32(
        0.33333333333
    )

    q = c2 * c2 + c0
    r_ = 3.0 * c0 * c2 - c2 * c2 * c2 - c1 * c1
    h = r_ * r_ - q * q * q
    sq_q = jnp.sqrt(jnp.maximum(q, 1e-30))
    z_trig = 2.0 * sq_q * jnp.cos(
        jnp.arccos(jnp.clip(r_ / jnp.maximum(sq_q * q, 1e-30), -1.0, 1.0))
        * np.float32(0.33333333333)
    )
    s_cbrt = jnp.cbrt(jnp.sqrt(jnp.maximum(h, 0.0)) + jnp.abs(r_))
    z_card = jnp.sign(r_) * jnp.abs(s_cbrt + q / jnp.where(jnp.abs(s_cbrt) < 1e-30, 1e-30, s_cbrt))
    z = jnp.where(h < 0.0, z_trig, z_card)
    z = c2 - z

    d1 = z - 3.0 * c2
    d2 = z * z - 3.0 * c0
    small_d1 = jnp.abs(d1) < 1e-8
    d2_a = jnp.sqrt(jnp.maximum(d2, 0.0))
    d1_b = jnp.sqrt(jnp.maximum(d1 * 0.5, 1e-30))
    d2_b = c1 / d1_b
    ok_branch = jnp.where(small_d1, d2 >= 0.0, d1 >= 0.0)
    d1v = jnp.where(small_d1, 0.0, d1_b)
    d2v = jnp.where(small_d1, d2_a, d2_b)

    big = jnp.float32(1e20)

    def roots(sign):
        hh = d1v * d1v - z + sign * d2v
        valid = hh > 0.0
        sh = jnp.sqrt(jnp.maximum(hh, 0.0))
        base = jnp.where(sign > 0, -d1v, d1v)
        t1 = base - sh - k3n
        t2 = base + sh - k3n
        t1 = jnp.where(po < 0, 2.0 / jnp.where(jnp.abs(t1) < 1e-20, 1e-20, t1), t1)
        t2 = jnp.where(po < 0, 2.0 / jnp.where(jnp.abs(t2) < 1e-20, 1e-20, t2), t2)
        t1 = jnp.where(valid & (t1 > 0.0), t1, big)
        t2 = jnp.where(valid & (t2 > 0.0), t2, big)
        return jnp.minimum(t1, t2)

    t = jnp.minimum(roots(+1.0), roots(-1.0))

    # Newton polish on the original quartic
    # f(t) = (|O+tD|^2 + k*2)^2 ... use implicit torus F(p) directly:
    def torus_f(tv):
        p = oo + tv[..., None] * od
        s = vm.dot(p, p) + rc2 - rt2
        return s * s - 4.0 * rc2 * (p[..., 0] ** 2 + p[..., 1] ** 2)

    def torus_fp(tv):
        p = oo + tv[..., None] * od
        s = vm.dot(p, p) + rc2 - rt2
        ds = 2.0 * vm.dot(p, od)
        return 2.0 * s * ds - 8.0 * rc2 * (
            p[..., 0] * od[..., 0] + p[..., 1] * od[..., 1]
        )

    for _ in range(newton_iters):
        fp = torus_fp(t)
        t = t - torus_f(t) / jnp.where(jnp.abs(fp) < 1e-12, 1e-12, fp)

    hit = bound & ok_branch & (t > 0.0) & (t < t_max) & (t < 1e19)
    return jnp.where(hit, t, t_max), hit


def torus_normal(p, t_mat, inv_t, rc2, rt2):
    """N = normalize(L * (dot(L,L) - rt2 - rc2*(1,1,-1))) in object space
    (primitives.h:528-533)."""
    l = vm.transform_position(p, inv_t)
    s = vm.dot(l, l)[..., None]
    factor = s - rt2 - rc2 * jnp.asarray([1.0, 1.0, -1.0], jnp.float32)
    n = vm.normalize(l * factor)
    return vm.transform_vector(n, t_mat)
