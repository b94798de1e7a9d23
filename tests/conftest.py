"""Test config: an 8-virtual-device CPU backend, so the multi-device
sharding paths run without accelerators (SURVEY.md §4).  The suite runs
with JAX_PLATFORMS=cpu; tests that need the GPU carry the `gpu` marker and
skip here (chip_smoke.py runs the same checks on the card)."""

import os

# Must run before any backend is initialized.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# Tiny-matrix transform math in tests must not be demoted on any backend.
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cpu_ray_tracer_tpu.io.scene_xml import UPSTREAM_ASSETS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUR_ASSETS = os.path.join(REPO, "assets")


def upstream_asset(rel: str) -> str:
    """Path of a file from the upstream reference's assets/ tree, which this
    repository does not ship.  Call it inside a fixture or a test: it skips
    the test, naming the file, unless CRT_UPSTREAM_ASSETS points at a tree
    that holds it."""
    path = os.path.join(UPSTREAM_ASSETS, rel) if UPSTREAM_ASSETS else ""
    if not path or not os.path.isfile(path):
        pytest.skip(
            f"upstream asset {rel} is not in this repository "
            "(set CRT_UPSTREAM_ASSETS to the reference's assets/ directory)"
        )
    return path


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
