"""The CUDA BVH walk (native/bvh_walk_cuda.cu) as a JAX operation.

One thread walks one ray through the threaded BVH (native/bvh_walk.h) and
answers the same query contract as the XLA walk in ops/traverse_bvh.py:
t, bary, tri_idx, obj_id, mat_id, traversed, tested, closest-hit or
any-hit, and t0 = -1 for a ray that must report no hit.  It has no
interpret mode; scene/query.walk_bvh runs it only where the program is
lowered for a GPU, and the XLA walk everywhere else.

The shared library is built from the committed sources with nvcc at first
use on a machine whose JAX has a GPU backend (`make -C native cuda`, about
half a minute, reported by `build_info()` as set-up time) and registered as
the FFI target "crt_bvh_walk".  A build failure raises: the GPU path never
falls back to the XLA walk on its own.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.accel.types import BVHArrays, TrianglePool

TARGET = "crt_bvh_walk"
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
LIB_PATH = os.path.join(_NATIVE_DIR, "libcrt_bvh_cuda.so")

# The registration with XLA is process-wide, so its record is too.
_build: dict = {}


def _has_gpu() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def ensure_registered() -> dict:
    """Build (if needed) and register the CUDA library once per process.
    Returns build_info().  Raises RuntimeError when nvcc fails."""
    if _build:
        return build_info()
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["make", "-C", _NATIVE_DIR, "cuda", f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0 or not os.path.isfile(LIB_PATH):
        raise RuntimeError(
            "building the CUDA BVH walk failed (make -C native cuda):\n"
            + proc.stdout[-4000:] + proc.stderr[-4000:]
        )
    lib = ctypes.CDLL(LIB_PATH)
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.CrtBvhWalk), platform="CUDA")
    _build.update(
        seconds=time.perf_counter() - t0,
        library=LIB_PATH,
        compiled="nvcc" in proc.stdout,
        _lib=lib,
    )
    return build_info()


def build_info() -> dict:
    """{seconds, library, compiled} of this process's build and
    registration (compiled=False: make found the library up to date);
    empty before the first GPU trace."""
    return {k: v for k, v in _build.items() if not k.startswith("_")}


def traverse(
    bvh: BVHArrays,
    tris: TrianglePool,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t0: jnp.ndarray,
    any_hit: bool = False,
) -> dict:
    """Nearest-hit (or any-hit) walk of R rays on the GPU.  o, d [R, 3]
    float32, t0 [R]; returns the dict contract of ops/traverse_bvh.traverse.
    Tracing it on a machine with a GPU builds and registers the library."""
    if _has_gpu():
        ensure_registered()
    r = o.shape[0]
    out_types = (
        jax.ShapeDtypeStruct((r,), jnp.float32),  # t
        jax.ShapeDtypeStruct((r, 2), jnp.float32),  # bary
        *(jax.ShapeDtypeStruct((r,), jnp.int32) for _ in range(5)),
    )
    call = jax.ffi.ffi_call(TARGET, out_types, vmap_method="sequential")
    t, bary, tri, obj, mat, trav, tested = call(
        o.astype(jnp.float32), d.astype(jnp.float32), t0.astype(jnp.float32),
        bvh.node_min, bvh.node_max, bvh.left_first, bvh.tri_count,
        bvh.hit_link, bvh.miss_link, bvh.tri_indices,
        tris.v0, tris.e1, tris.e2, tris.obj_id, tris.mat_id,
        root=np.int32(bvh.root), any_hit=np.int32(any_hit),
    )
    return dict(
        t=t, bary=bary, tri_idx=tri, obj_id=obj, mat_id=mat,
        traversed=trav, tested=tested,
    )
