"""ctypes bindings to the native (C++) host library.

The reference does its whole scene-compile path (SAH BVH build, grid
insertion) in C++; this module is our native equivalent.  The library is
built from native/crt_native.cpp (`make -C native`) and loaded lazily; when
absent or disabled (CRT_NATIVE=0) the numpy builders are used — both paths
share semantics and are cross-checked by tests.

The same library holds the host build of the per-ray BVH walk that the CUDA
kernel runs (native/bvh_walk.h, `walk_host`), which the CPU tests compare
with ops/traverse_bvh.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO, "native", "libcrt_native.so")
_lib = None
_tried = False

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _build_library() -> bool:
    try:
        subprocess.run(
            ["make", "-C", os.path.join(_REPO, "native")],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.isfile(_LIB_PATH)
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("CRT_NATIVE", "1") == "0":
        return None
    if not os.path.isfile(_LIB_PATH) and not _build_library():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.crt_build_bvh.restype = ctypes.c_int
    lib.crt_build_bvh.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
        np.ctypeslib.ndpointer(np.int32, shape=(1,)),
    ]
    lib.crt_build_sbvh.restype = ctypes.c_int
    lib.crt_build_sbvh.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p,
        _i32p, _i32p, np.ctypeslib.ndpointer(np.int32, shape=(2,)),
    ]
    lib.crt_thread_links.restype = None
    lib.crt_thread_links.argtypes = [
        _i32p, _i32p, _i32p, _i32p, ctypes.c_int, _i32p, ctypes.c_int, _i32p, _i32p,
    ]
    lib.crt_traverse.restype = None
    lib.crt_traverse.argtypes = (
        [_f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32]
        + [_f32p, _f32p, _f32p, _i32p, _i32p]
        + [_f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int32]
        + [_f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p]
    )
    lib.crt_grid_insert.restype = ctypes.c_longlong
    lib.crt_grid_insert.argtypes = [
        _f32p, ctypes.c_int, _f32p, _f32p, _i32p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def build_bvh_native(
    tri_v: np.ndarray,
    sah: bool = True,
    bins: int = 8,
    force_split_cap: int | None = 4,
    leaf_target: int | None = None,
):
    """Native twin of accel.bvh_builder.build_bvh; returns the same
    (_HostBVH-like, tri_indices, BuildStats) triple or None if the library
    is unavailable."""
    import time

    from cpu_ray_tracer_tpu.accel.types import BuildStats

    lib = get_lib()
    if lib is None:
        return None
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    cap = max(2 * n - 1, 1)
    tv = np.ascontiguousarray(tri_v.reshape(n, 9), np.float32)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left_first = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    axis = np.zeros(cap, np.int32)
    idx = np.zeros(max(n, 1), np.int32)
    max_depth = np.zeros(1, np.int32)
    used = lib.crt_build_bvh(
        tv, n, int(sah), bins,
        0 if force_split_cap is None else force_split_cap,
        0 if leaf_target is None else leaf_target,
        node_min, node_max, left_first, tri_count, left, right, axis, idx,
        max_depth,
    )

    class _H:
        pass

    h = _H()
    h.nodes_used = used
    h.node_min = node_min[:used]
    h.node_max = node_max[:used]
    h.left_first = left_first[:used]
    h.tri_count = tri_count[:used]
    h.left = left[:used]
    h.right = right[:used]
    h.axis = axis[:used]
    h.max_depth = int(max_depth[0])
    leaves = h.tri_count > 0
    stats = BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=h.max_depth,
        num_nodes=used,
        num_leaves=int(leaves.sum()),
        max_leaf=int(h.tri_count.max()) if used else 0,
    )
    return h, idx[:n], stats


def build_sbvh_native(
    tri_v: np.ndarray,
    bins: int = 8,
    leaf_target: int = 8,
    alpha: float = 1e-5,
    ref_factor: float = 2.0,
):
    """SBVH (spatial-split) build — crt_build_sbvh in native/crt_native.cpp.

    Returns the same (host, tri_indices, BuildStats) triple as
    build_bvh_native, where tri_indices is the concatenated leaf REFERENCE
    list (length >= N: straddling triangles are duplicated with clipped
    boxes).  None when the library is unavailable or the reference/node
    caps are exceeded (caller falls back to the plain SAH build)."""
    import time

    from cpu_ray_tracer_tpu.accel.types import BuildStats

    lib = get_lib()
    if lib is None:
        return None
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    ref_cap = max(int(n * ref_factor) + 64, 128)
    node_cap = max(4 * ref_cap, 64)
    tv = np.ascontiguousarray(tri_v.reshape(n, 9), np.float32)
    node_min = np.zeros((node_cap, 3), np.float32)
    node_max = np.zeros((node_cap, 3), np.float32)
    left_first = np.zeros(node_cap, np.int32)
    tri_count = np.zeros(node_cap, np.int32)
    left = np.zeros(node_cap, np.int32)
    right = np.zeros(node_cap, np.int32)
    axis = np.zeros(node_cap, np.int32)
    idx = np.zeros(ref_cap, np.int32)
    meta = np.zeros(2, np.int32)
    used = lib.crt_build_sbvh(
        tv, n, bins, leaf_target, ctypes.c_float(alpha), node_cap, ref_cap,
        node_min, node_max, left_first, tri_count, left, right, axis, idx,
        meta,
    )
    if used < 0:
        return None

    class _H:
        pass

    h = _H()
    h.nodes_used = used
    h.node_min = node_min[:used]
    h.node_max = node_max[:used]
    h.left_first = left_first[:used]
    h.tri_count = tri_count[:used]
    h.left = left[:used]
    h.right = right[:used]
    h.axis = axis[:used]
    h.max_depth = int(meta[0])
    n_refs = int(meta[1])
    leaves = h.tri_count > 0
    stats = BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=h.max_depth,
        num_nodes=used,
        num_leaves=int(leaves.sum()),
        max_leaf=int(h.tri_count.max()) if used else 0,
    )
    return h, idx[:n_refs], stats


def thread_links_native(left, right, tri_count, axis, roots=None):
    lib = get_lib()
    if lib is None:
        return None
    m = left.shape[0]
    if roots is None:
        roots = [0]
    roots_arr = np.asarray(roots, np.int32)
    hit = np.full((8, m), -1, np.int32)
    miss = np.full((8, m), -1, np.int32)
    lib.crt_thread_links(
        np.ascontiguousarray(left, np.int32),
        np.ascontiguousarray(right, np.int32),
        np.ascontiguousarray(tri_count, np.int32),
        np.ascontiguousarray(axis, np.int32),
        m, roots_arr, len(roots), hit, miss,
    )
    return hit, miss


def walk_host(bvh, tris, o, d, t0, any_hit: bool = False) -> dict:
    """Run native/bvh_walk.h's per-ray walk on the host over numpy copies
    of a BVHArrays / TrianglePool and rays o, d [R, 3], t0 [R].  Returns the
    traversal contract of ops/traverse_bvh.traverse as numpy arrays.
    Raises RuntimeError when the library cannot be built."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable: `make -C native` failed")

    def f32(x):
        return np.ascontiguousarray(np.asarray(x), np.float32)

    def i32(x):
        return np.ascontiguousarray(np.asarray(x), np.int32)

    o, d, t0 = f32(o), f32(d), f32(t0)
    r = t0.shape[0]
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"rays must be [R, 3] beside t0 [R]; got {o.shape}, {d.shape}, {t0.shape}")
    m = int(np.asarray(bvh.tri_count).shape[0])
    tables = (
        f32(bvh.node_min), f32(bvh.node_max), i32(bvh.left_first), i32(bvh.tri_count),
        i32(bvh.hit_link), i32(bvh.miss_link), i32(bvh.tri_indices),
    )
    pool = (f32(tris.v0), f32(tris.e1), f32(tris.e2), i32(tris.obj_id), i32(tris.mat_id))
    out = dict(
        t=np.empty(r, np.float32),
        bary=np.empty((r, 2), np.float32),
        tri_idx=np.empty(r, np.int32),
        obj_id=np.empty(r, np.int32),
        mat_id=np.empty(r, np.int32),
        traversed=np.empty(r, np.int32),
        tested=np.empty(r, np.int32),
    )
    lib.crt_traverse(
        *tables, m, int(bvh.root), *pool, o, d, t0, r, int(any_hit),
        out["t"], out["bary"], out["tri_idx"], out["obj_id"], out["mat_id"],
        out["traversed"], out["tested"],
    )
    return out
