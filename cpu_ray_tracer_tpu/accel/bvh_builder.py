"""Host-side (numpy) binned-SAH BVH builder + threaded-link computation.

Build semantics match the reference (infra/bvh.cpp:63-178) so tree topology
is comparable:

* node bounds grown from triangle vertices (UpdateNodeBounds);
* centroid = (v0 + v1 + v2) * 0.3333 — the reference's inexact third
  (infra/model.cpp:78) is kept on purpose;
* split plane from an 8-bin SAH sweep over the centroid extent per axis
  (FindBestSplitPlane), cost = triCount * half-area;
* recursion stops at <= 2 triangles or when the best split does not beat the
  parent cost (CalculateNodeCost);
* in-place partition of the triangle index array by centroid < splitPos.

Additions over the reference, both for batched traversal:

* `force_split_cap`: in fast mode, a no-gain SAH stop with more than
  `force_split_cap` triangles falls back to a median split, bounding
  `max_leaf` (the traversal kernel's static unroll length).  Parity mode
  (`force_split_cap=None`) reproduces the reference exactly.
* `thread_links`: per ray-direction octant hit/miss skip links that make
  device traversal stackless (see accel/types.py docstring).
"""

from __future__ import annotations

import os
import time

import numpy as np

from cpu_ray_tracer_tpu.accel.types import BuildStats


def tri_centroids(tri_v: np.ndarray) -> np.ndarray:
    """[N, 3, 3] vertices -> [N, 3] centroids, reference-scaled by 0.3333."""
    return tri_v.sum(axis=1) * np.float32(0.3333)


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> float:
    e = np.maximum(bmax - bmin, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


class _HostBVH:
    """Builder output on host; converted to device arrays by the scene
    compiler."""

    def __init__(self, n_tris: int):
        cap = max(2 * n_tris - 1, 1)
        self.node_min = np.full((cap, 3), 1e30, np.float32)
        self.node_max = np.full((cap, 3), -1e30, np.float32)
        self.left_first = np.zeros(cap, np.int32)
        self.tri_count = np.zeros(cap, np.int32)
        self.left = np.full(cap, -1, np.int32)
        self.right = np.full(cap, -1, np.int32)
        self.axis = np.zeros(cap, np.int32)
        self.nodes_used = 1
        self.max_depth = 0

    def trim(self):
        m = self.nodes_used
        for name in ("node_min", "node_max", "left_first", "tri_count", "left", "right", "axis"):
            setattr(self, name, getattr(self, name)[:m])
        return self


def build_bvh(
    tri_v: np.ndarray,
    sah: bool = True,
    bins: int = 8,
    force_split_cap: int | None = 4,
    leaf_target: int | None = None,
):
    """Build a BVH over triangles `tri_v` [N, 3, 3].

    `leaf_target`: stop subdividing once a node holds <= this many triangles
    (reference behavior = 2).  Fatter leaves trade node steps for
    triangle tests.

    Returns (host_bvh, tri_indices [N] int32, BuildStats).

    Uses the native C++ builder (accel/native.py) when available — same
    semantics, ~20x faster; set CRT_NATIVE=0 to force the numpy path.
    """
    from cpu_ray_tracer_tpu.accel import native

    if sah and os.environ.get("CRT_SBVH", "0") == "1":
        # SBVH spatial splits (crt_build_sbvh): straddling triangle
        # references duplicate into both children with clipped boxes,
        # shrinking sibling overlap; leaf lists may repeat a triangle id
        # (the running-min intersection test is idempotent).  Falls through
        # to the plain SAH build when the native library is absent or the
        # reference cap trips.
        nat = native.build_sbvh_native(
            tri_v, bins=bins, leaf_target=leaf_target or 8
        )
        if nat is not None:
            return nat
    nat = native.build_bvh_native(
        tri_v, sah=sah, bins=bins, force_split_cap=force_split_cap, leaf_target=leaf_target
    )
    if nat is not None:
        return nat
    leaf_stop = 2 if leaf_target is None else leaf_target
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    cent = tri_centroids(tri_v)
    tmin = tri_v.min(axis=1)  # [N, 3] per-tri AABB (vertex min)
    tmax = tri_v.max(axis=1)

    idx = np.arange(n, dtype=np.int32)
    bvh = _HostBVH(n)
    root = 0
    bvh.left_first[root] = 0
    bvh.tri_count[root] = n

    stack = [(root, 0)]
    while stack:
        node, depth = stack.pop()
        first = int(bvh.left_first[node])
        count = int(bvh.tri_count[node])
        sl = idx[first : first + count]
        # UpdateNodeBounds: grow from vertices
        bvh.node_min[node] = tmin[sl].min(axis=0)
        bvh.node_max[node] = tmax[sl].max(axis=0)
        bvh.max_depth = max(bvh.max_depth, depth)
        if count <= leaf_stop:
            continue

        axis = -1
        split_pos = 0.0
        do_median = False
        if sah:
            best_cost = 1e30
            c = cent[sl]
            for a in range(3):
                cmin = float(c[:, a].min())
                cmax = float(c[:, a].max())
                if cmin == cmax:
                    continue
                scale = bins / (cmax - cmin)
                bidx = np.minimum((bins - 1), ((c[:, a] - cmin) * scale).astype(np.int64))
                # per-bin counts and grown bounds (from tri vertices)
                counts = np.bincount(bidx, minlength=bins)
                bin_min = np.full((bins, 3), 1e30, np.float32)
                bin_max = np.full((bins, 3), -1e30, np.float32)
                np.minimum.at(bin_min, bidx, tmin[sl])
                np.maximum.at(bin_max, bidx, tmax[sl])
                # prefix/suffix sweeps over the 7 planes
                lmin = np.minimum.accumulate(bin_min, axis=0)
                lmax = np.maximum.accumulate(bin_max, axis=0)
                rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
                lcount = np.cumsum(counts)
                rcount = np.cumsum(counts[::-1])[::-1]
                for i in range(bins - 1):
                    le = np.maximum(lmax[i] - lmin[i], 0.0)
                    re = np.maximum(rmax[i + 1] - rmin[i + 1], 0.0)
                    larea = le[0] * le[1] + le[1] * le[2] + le[2] * le[0] if lcount[i] else 0.0
                    rarea = re[0] * re[1] + re[1] * re[2] + re[2] * re[0] if rcount[i + 1] else 0.0
                    cost = lcount[i] * larea + rcount[i + 1] * rarea
                    if cost < best_cost:
                        best_cost = cost
                        axis = a
                        split_pos = cmin + (cmax - cmin) / bins * (i + 1)
            no_split_cost = count * _half_area(bvh.node_min[node], bvh.node_max[node])
            if axis < 0 or best_cost >= no_split_cost:
                if force_split_cap is not None and count > force_split_cap:
                    do_median = True
                else:
                    continue  # leaf (reference SAH no-gain stop)
        else:
            ext = bvh.node_max[node] - bvh.node_min[node]
            axis = int(np.argmax(ext))
            split_pos = float(bvh.node_min[node][axis] + ext[axis] * 0.5)

        if do_median:
            ext = bvh.node_max[node] - bvh.node_min[node]
            axis = int(np.argmax(ext))
            order = np.argsort(cent[sl, axis], kind="stable")
            idx[first : first + count] = sl[order]
            left_count = count // 2
        else:
            mask = cent[sl, axis] < split_pos
            left_count = int(mask.sum())
            if left_count == 0 or left_count == count:
                if force_split_cap is not None and count > force_split_cap:
                    order = np.argsort(cent[sl, axis], kind="stable")
                    idx[first : first + count] = sl[order]
                    left_count = count // 2
                else:
                    continue  # leaf (degenerate partition)
            else:
                idx[first : first + count] = np.concatenate([sl[mask], sl[~mask]])

        li = bvh.nodes_used
        ri = bvh.nodes_used + 1
        bvh.nodes_used += 2
        bvh.left_first[li] = first
        bvh.tri_count[li] = left_count
        bvh.left_first[ri] = first + left_count
        bvh.tri_count[ri] = count - left_count
        bvh.left[node] = li
        bvh.right[node] = ri
        bvh.axis[node] = axis
        bvh.left_first[node] = li
        bvh.tri_count[node] = 0
        stack.append((ri, depth + 1))
        stack.append((li, depth + 1))

    bvh.trim()
    leaves = bvh.tri_count > 0
    stats = BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=int(bvh.max_depth),
        num_nodes=int(bvh.nodes_used),
        num_leaves=int(leaves.sum()),
        max_leaf=int(bvh.tri_count.max()) if bvh.nodes_used else 0,
    )
    return bvh, idx, stats


def refit_bvh(host, tri_indices: np.ndarray, tri_v: np.ndarray) -> None:
    """Bottom-up bounds refit after vertex motion, topology unchanged
    (BVH::Refit, infra/bvh.cpp:26-43), fully vectorized: leaves via one
    segmented min/max over the leaf-partitioned tri order, interiors via
    <= tree-height numpy sweeps.  Threaded links stay valid (they encode
    topology, not bounds).  In-place on `host`."""
    tmin = tri_v.min(axis=1)
    tmax = tri_v.max(axis=1)
    m = host.nodes_used
    if m == 0:
        return
    tc = host.tri_count[:m]
    leaf = tc > 0

    # Leaves, all at once: leaf slices partition tri_indices, so a segmented
    # min/max (reduceat over slice starts in address order) covers them in
    # one vectorized pass.
    smin = tmin[tri_indices]
    smax = tmax[tri_indices]
    leaf_ids = np.nonzero(leaf)[0]
    order = np.argsort(host.left_first[leaf_ids], kind="stable")
    leaf_ids = leaf_ids[order]
    starts = host.left_first[leaf_ids]
    host.node_min[leaf_ids] = np.minimum.reduceat(smin, starts, axis=0)
    host.node_max[leaf_ids] = np.maximum.reduceat(smax, starts, axis=0)

    # Interiors level by level (children always carry larger indices, so
    # readiness propagates bottom-up in <= tree-height vectorized sweeps).
    li = host.left[:m]
    ri = host.right[:m]
    done = leaf.copy()
    while not done.all():
        ready = (~done) & done[li] & done[ri]
        ids = np.nonzero(ready)[0]
        if ids.size == 0:
            raise RuntimeError("refit_bvh: malformed topology (no ready nodes)")
        host.node_min[ids] = np.minimum(host.node_min[li[ids]], host.node_min[ri[ids]])
        host.node_max[ids] = np.maximum(host.node_max[li[ids]], host.node_max[ri[ids]])
        done[ids] = True


def thread_links(
    left: np.ndarray,
    right: np.ndarray,
    tri_count: np.ndarray,
    axis: np.ndarray,
    roots: list[int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Compute per-octant hit/miss skip links over one (or a forest of)
    threaded BVH(s).

    For octant `o` (bit a set = ray direction negative along axis a) the DFS
    visits each interior node's near child first: the left (lower-coordinate)
    child when the direction is positive along the node's split axis.  This
    statically reproduces the reference's distance-ordered descent
    (infra/bvh.cpp:245-249).

    When `roots` lists multiple roots (a forest), the forests are chained in
    order: finishing one tree continues at the next root.
    """
    from cpu_ray_tracer_tpu.accel import native

    nat = native.thread_links_native(left, right, tri_count, axis, roots=roots)
    if nat is not None:
        return nat
    m = left.shape[0]
    if roots is None:
        roots = [0]
    hit = np.full((8, m), -1, np.int32)
    miss = np.full((8, m), -1, np.int32)
    is_leaf = tri_count > 0
    for o in range(8):
        neg = ((o >> 0) & 1, (o >> 1) & 1, (o >> 2) & 1)
        ho = hit[o]
        mo = miss[o]
        # chain the forest: root i exits into root i+1
        stack: list[tuple[int, int]] = []
        for i in range(len(roots) - 1, -1, -1):
            nxt = roots[i + 1] if i + 1 < len(roots) else -1
            stack.append((roots[i], nxt))
        # NOTE: stack holds (node, exit_link); LIFO order irrelevant to result
        while stack:
            node, ex = stack.pop()
            mo[node] = ex
            if is_leaf[node]:
                ho[node] = ex
                continue
            a = int(axis[node])
            if neg[a]:
                near, far = int(right[node]), int(left[node])
            else:
                near, far = int(left[node]), int(right[node])
            ho[node] = near
            stack.append((near, far))
            stack.append((far, ex))
    return hit, miss
