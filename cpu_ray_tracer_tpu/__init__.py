"""cpu_ray_tracer_tpu — a differentiable ray-tracing framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of the C++
CPU reference (willake/cpu-ray-tracer): Whitted-style ray tracing, Monte-Carlo
path tracing, interchangeable BVH(SAH)/uniform-grid/KD-tree acceleration
structures plus a two-level TLAS over per-model BLAS instances, .obj loading,
XML scene files, reflect/refract/absorption materials, texture mapping, and an
equirectangular skydome.

Design stance (see SURVEY.md §7): everything the reference does with
pointer-chasing recursion and per-ray scalar code is done here with flat SoA
arrays, batched kernels and bounded `lax` control flow.  Host Python plays the
role of the reference's `template/` runtime (I/O, scene compile,
orchestration); the CUDA BVH walk (native/) plays the role of its SSE
intrinsics;
`shard_map` over a device mesh plays the role of its OpenMP/JobManager; XLA
collectives play the role of its (nonexistent) communication backend.
"""

__version__ = "0.1.0"

from cpu_ray_tracer_tpu import constants  # noqa: F401
