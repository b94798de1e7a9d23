"""chip_smoke.py: its refusal to run without a GPU, its comparison rules,
and its phases at a tiny size on the CPU (where "auto" and "xla" both run
the XLA walk, so the phases' control flow and checks are what is tested).
The `gpu` tests run the same phases on a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from cpu_ray_tracer_tpu.accel.compile import make_triangle_pool

from tests.conftest import REPO


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            continue
    return False


def test_refuses_without_gpu():
    out = _run(REPO)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def _walk(tri, t):
    return {"tri_idx": np.asarray(tri, np.int32), "t": np.asarray(t, np.float32)}


@pytest.fixture(scope="module")
def one_tri():
    tri_v = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    return make_triangle_pool(tri_v)


@pytest.mark.parametrize(
    "ref_t, got_t, got_tri, any_hit, ok",
    [
        (2.0, 2.0 * (1 + 5e-6), 0, False, True),  # last-bit difference
        (2.0, 2.0 * (1 + 1e-3), 0, False, False),  # a real t error
        (2.0, 2.0, 1, False, True),  # same t, other triangle: a near-tie
        (2.0, 3.0, 1, False, False),  # other triangle, other t: wrong hit
        (2.0, 7.0, 1, True, True),  # any-hit: which blocker is not compared
        (2.0, 2.0 * (1 + 1e-3), 0, True, False),  # any-hit, same blocker, wrong t
    ],
)
def test_compare_walks_rules(one_tri, ref_t, got_t, got_tri, any_hit, ok):
    n = 20000  # one disagreeing ray in 20000 stays above MIN_AGREE
    o = np.tile([[0.25, 0.25, 2.0]], (n, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1)).astype(np.float32)
    ref = _walk(np.zeros(n), np.full(n, ref_t))
    got = _walk(np.zeros(n), np.full(n, ref_t))
    got["tri_idx"][0], got["t"][0] = got_tri, got_t
    if ok:
        chip_smoke.compare_walks("case", ref, got, any_hit, o, d, one_tri)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.compare_walks("case", ref, got, any_hit, o, d, one_tri)


@pytest.fixture(scope="module")
def small():
    return chip_smoke.phase_setup(40, 24)


def test_phase_walks(small):
    chip_smoke.phase_walks(*small, reps=1)


def test_phase_pathtrace(small):
    chip_smoke.phase_pathtrace(*small, passes=2)


def test_phase_whitted():
    scene, _ = chip_smoke.bench_scene()
    chip_smoke.phase_whitted(scene, 40, 24)


def test_phase_train():
    chip_smoke.phase_train(24, 16)


def test_phase_four_cards():
    chip_smoke.phase_four_cards(32, 16)


@pytest.mark.gpu
def test_phases_on_card(gpu):
    """chip_smoke.py phases 4-6 at small sizes."""
    scene, camera = chip_smoke.phase_setup(320, 180)
    chip_smoke.phase_pathtrace(scene, camera, passes=2)
    chip_smoke.phase_whitted(scene, 256, 160)
    chip_smoke.phase_train(64, 36)
