"""TLAS-over-{grid, kdtree} traversal: chain per-instance structures.

The reference's TLASGrid / TLASKDTree (infra/tlas_grid.cpp:17-111,
infra/tlas_kdtree.cpp:17-111) are byte-identical clones of TLASBVH: an
agglomerative two-node-TLAS whose leaves call the per-object BLAS's
Intersect.  With at most a handful of instances per scene (inside_scene: 9)
the TLAS's only job is to skip BLASes whose world AABB the ray misses —
which each BLAS traversal already does in its own entry slab test.  The
batched equivalent is therefore a STATIC unrolled chain over the
per-instance structures, threading the running `t` through so later
instances start with the earlier instances' closest hit (the same
front-to-back pruning the reference gets from ordered TLAS descent, minus
the ordering).  No gathers, no ragged shapes, no mode switches inside jit.
"""

from __future__ import annotations

import jax.numpy as jnp


def traverse_forest(traverse_fn, structs, tris, o, d, t0, any_hit: bool = False):
    """Chain `traverse_fn(struct, tris, o, d, t, any_hit)` over `structs`
    (a tuple of per-instance GridArrays / KDTreeArrays whose triangle ids are
    already offset into the global pool).  Returns the same dict contract as
    the single-structure traversals."""
    t = t0
    out = None
    for s in structs:
        res = traverse_fn(s, tris, o, d, t, any_hit=any_hit)
        if out is None:
            out = dict(res)
        else:
            better = res["tri_idx"] >= 0  # only recorded when closer than t
            for k in ("bary", "tri_idx", "obj_id", "mat_id"):
                w = better[..., None] if res[k].ndim > better.ndim else better
                out[k] = jnp.where(w, res[k], out[k])
            out["t"] = jnp.where(better, res["t"], out["t"])
            out["traversed"] = out["traversed"] + res["traversed"]
            out["tested"] = out["tested"] + res["tested"]
        t = out["t"]
        if any_hit:
            # once occluded, later chains see t already small; cheap anyway
            pass
    return out
