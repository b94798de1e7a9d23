"""Lockstep stackless BVH traversal over ray batches (pure JAX).

This is the device replacement for the reference's per-ray stack walk
(infra/bvh.cpp:224-258): every ray carries a single int32 cursor into the
threaded node arrays; one `lax.while_loop` iteration gathers one node record
per ray, slab-tests it, Möller–Trumbore-tests leaf triangles (static unroll
to `max_leaf`), and advances the cursor through the octant-ordered hit/miss
skip links.  Rays that finish park at cursor -1; the loop ends when all rays
are parked.

Why stackless: per-ray stacks + data-dependent trip counts do not batch; a
single cursor keeps all per-step work as flat gathers + vector math, which
XLA compiles for any backend.  The 8 link
tables keep near-first ordered descent so early-out by distance still works
(each slab test uses the ray's current best t).

The CUDA walk (native/bvh_walk.h, ops/bvh_kernel.py) answers the same
contract one ray per thread on the GPU; this version is the reference it is
tested against and the walk every other platform runs (scene/query.walk_bvh
chooses).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.accel.types import BVHArrays, TrianglePool
from cpu_ray_tracer_tpu.ops import intersect


def ray_octants(d: jnp.ndarray) -> jnp.ndarray:
    """Octant id per ray from direction signs: bit a set iff d[a] < 0.
    Chooses which of the 8 precomputed link orderings a ray follows."""
    return (
        (d[..., 0] < 0).astype(jnp.int32)
        + 2 * (d[..., 1] < 0).astype(jnp.int32)
        + 4 * (d[..., 2] < 0).astype(jnp.int32)
    )


def traverse(
    bvh: BVHArrays,
    tris: TrianglePool,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t0: jnp.ndarray,
    any_hit: bool = False,
    max_steps: int | None = None,
):
    """Nearest-hit (or any-hit) traversal.

    o, d: [R, 3]; t0: [R] initial nearest distance (e.g. RAY_FAR, or the
    shadow-ray max distance).

    Returns dict with t, bary [R, 2], tri_idx (into the pool, -1 = miss),
    obj_id, mat_id, traversed, tested — the same per-ray outputs the
    reference accumulates on its Ray (template/ray.h:33-39).
    """
    r = o.shape[0]
    m = bvh.num_nodes
    rd = 1.0 / d
    oct_ = ray_octants(d)
    hit_flat = bvh.hit_link.reshape(-1)
    miss_flat = bvh.miss_link.reshape(-1)
    link_base = oct_ * m

    if max_steps is None:
        # Safety bound: a threaded DFS visits each node at most once.
        max_steps = int(2 * m + 4)

    state = dict(
        cur=jnp.full((r,), bvh.root, jnp.int32),
        t=t0.astype(jnp.float32),
        u=jnp.zeros((r,), jnp.float32),
        v=jnp.zeros((r,), jnp.float32),
        tri=jnp.full((r,), -1, jnp.int32),
        traversed=jnp.zeros((r,), jnp.int32),
        tested=jnp.zeros((r,), jnp.int32),
        steps=jnp.zeros((), jnp.int32),
    )

    def cond(s):
        return jnp.any(s["cur"] >= 0) & (s["steps"] < max_steps)

    def body(s):
        cur = s["cur"]
        active = cur >= 0
        node = jnp.maximum(cur, 0)  # safe gather index for parked rays
        bmin = bvh.node_min[node]
        bmax = bvh.node_max[node]
        _, box_hit = intersect.slab_aabb(o, rd, s["t"], bmin, bmax)
        box_hit = box_hit & active
        tcount = bvh.tri_count[node]
        first = bvh.left_first[node]
        is_leaf = tcount > 0
        do_leaf = box_hit & is_leaf

        t = s["t"]
        u = s["u"]
        v = s["v"]
        tri = s["tri"]
        tested = s["tested"]
        # static unroll over the (small, build-capped) max leaf size
        for k in range(bvh.max_leaf):
            k_ok = do_leaf & (k < tcount)
            slot = first + jnp.minimum(k, tcount - 1)
            tid = bvh.tri_indices[jnp.maximum(slot, 0)]
            tk, uk, vk, hk = intersect.moller_trumbore(
                o, d, tris.v0[tid], tris.e1[tid], tris.e2[tid], t
            )
            hk = hk & k_ok
            t = jnp.where(hk, tk, t)
            u = jnp.where(hk, uk, u)
            v = jnp.where(hk, vk, v)
            tri = jnp.where(hk, tid, tri)
            tested = tested + k_ok.astype(jnp.int32)

        descend = box_hit & (~is_leaf)
        nxt = jnp.where(
            descend,
            hit_flat[link_base + node],
            miss_flat[link_base + node],
        )
        if any_hit:
            # park as soon as any triangle hit is recorded
            nxt = jnp.where(tri >= 0, -1, nxt)
        cur = jnp.where(active, nxt, cur)
        return dict(
            cur=cur,
            t=t,
            u=u,
            v=v,
            tri=tri,
            traversed=s["traversed"] + active.astype(jnp.int32),
            tested=tested,
            steps=s["steps"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state)
    tri = s["tri"]
    found = tri >= 0
    tri_safe = jnp.maximum(tri, 0)
    return dict(
        t=s["t"],
        bary=jnp.stack([s["u"], s["v"]], axis=-1),
        tri_idx=tri,
        obj_id=jnp.where(found, tris.obj_id[tri_safe], -1),
        mat_id=jnp.where(found, tris.mat_id[tri_safe], -1),
        traversed=s["traversed"],
        tested=s["tested"],
    )


def interpolate_hit(tris: TrianglePool, tri_idx: jnp.ndarray, bary: jnp.ndarray):
    """Barycentric-interpolated shading normal and uv for hit triangles.

    Parity: BVH::GetNormal/GetUV (infra/bvh.cpp:292-306) — N normalized
    after interpolation; callers flip backfaces.

    Uses the fused [N, 16] shading record when present: ONE gather instead
    of six.
    """
    tid = jnp.maximum(tri_idx, 0)
    w = (1.0 - bary[..., 0] - bary[..., 1])[..., None]
    bu = bary[..., 0:1]
    bv = bary[..., 1:2]
    if tris.shade is not None:
        rec = tris.shade[tid]  # [R, 16]
        n = w * rec[..., 0:3] + bu * rec[..., 3:6] + bv * rec[..., 6:9]
        uv = w * rec[..., 9:11] + bu * rec[..., 11:13] + bv * rec[..., 13:15]
    else:
        n = w * tris.n0[tid] + bu * tris.n1[tid] + bv * tris.n2[tid]
        uv = w * tris.uv0[tid] + bu * tris.uv1[tid] + bv * tris.uv2[tid]
    sq = jnp.sum(n * n, axis=-1, keepdims=True)
    n = n * jax.lax.rsqrt(jnp.maximum(sq, np.float32(1e-20)))
    return n, uv
