"""Structured per-step metrics — the replacement for the reference's console
printf + ImGui panel (SURVEY.md §5 observability): rays/s, frame ms,
traversal statistics (total/average/peak), path-tracer energy; JSONL sink.
"""

from __future__ import annotations

import json
import time


class FrameMetrics:
    """EMA-smoothed frame timing like the reference
    (2. WhittedStyle/renderer.cpp:169-171: avg=(1-a)avg+a*ms, a*=0.5)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.avg_ms = 10.0
        self.alpha = 1.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        self.avg_ms = (1 - self.alpha) * self.avg_ms + self.alpha * dt_ms
        if self.alpha > 0.05:
            self.alpha *= 0.5
        fps = 1000.0 / self.avg_ms
        mrays = (self.width * self.height) / self.avg_ms / 1000.0  # primary only
        return dict(ms=dt_ms, avg_ms=self.avg_ms, fps=fps, primary_mrays_s=mrays)


def traversal_summary(traversed, tested) -> dict:
    """total/average/peak traversal + test counts per frame
    (2. WhittedStyle/renderer.cpp:148-152, 164-178); averages are over rays
    that traversed at least one node, matching m_rayHitCount."""
    import numpy as np

    tr = np.asarray(traversed).reshape(-1)
    te = np.asarray(tested).reshape(-1)
    hits = (tr > 0).sum()
    return dict(
        total_traversal=int(tr.sum()),
        average_traversal=float(tr.sum() / max(hits, 1)),
        peak_traversal=int(tr.max()) if tr.size else 0,
        total_tests=int(te.sum()),
        average_tests=float(te.sum() / max(hits, 1)),
        peak_tests=int(te.max()) if te.size else 0,
    )


class JsonlLogger:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, record: dict):
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


def runtime_flags() -> dict:
    """Effective runtime configuration for self-describing bench artifacts.

    Benchmark JSON must record what actually ran: the native C++ builder
    loads lazily with a silent numpy fallback (accel/native.py), SBVH is
    env-gated, the CUDA BVH walk is built at first use, and the path tracer
    reads a few CRT_* tuning flags — a recorded number is meaningless
    without them.
    """
    import os

    from cpu_ray_tracer_tpu.accel import native
    from cpu_ray_tracer_tpu.ops import bvh_kernel

    return {
        "native": native.get_lib() is not None,
        "cuda_bvh_walk": bvh_kernel.build_info(),
        "sbvh": os.environ.get("CRT_SBVH", "0") == "1",
        "crt_env": {k: v for k, v in os.environ.items() if k.startswith("CRT_")},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
