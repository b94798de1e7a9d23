"""The substitute assets are generated from fixed seeds
(tools/make_substitute_assets.py): the committed files are its output, and
the meshes keep the counts the scenes and tests rely on."""

import importlib.util
import os

import numpy as np
import pytest

from cpu_ray_tracer_tpu.io import image
from cpu_ray_tracer_tpu.io.obj import load_obj
from cpu_ray_tracer_tpu.scene.build import compile_scene

from tests.conftest import OUR_ASSETS, REPO


@pytest.fixture(scope="module")
def gen():
    spec = importlib.util.spec_from_file_location(
        "make_substitute_assets", os.path.join(REPO, "tools", "make_substitute_assets.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def generated(gen):
    return gen.generate()


def test_generator_is_deterministic(gen, generated):
    again = gen.generate()
    assert set(again) == set(generated)
    for k, v in generated.items():
        if isinstance(v, str):
            assert again[k] == v, k
        else:
            np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_committed_assets_are_the_generator_output(generated):
    for rel, content in generated.items():
        path = os.path.join(OUR_ASSETS, rel)
        if isinstance(content, str):
            with open(path) as f:
                assert f.read() == content, rel
        else:
            np.testing.assert_array_equal(image.read_png(path), content, err_msg=rel)


@pytest.mark.parametrize(
    "name, tris, has_uv",
    [("cube", 12, True), ("bunny", 4968, False), ("teapot", 2992, True)],
)
def test_mesh_counts(name, tris, has_uv):
    mesh = load_obj(os.path.join(OUR_ASSETS, f"{name}.obj"))
    assert mesh.num_tris == tris
    assert bool(np.any(mesh.uvs)) == has_uv
    np.testing.assert_allclose(np.linalg.norm(mesh.normals, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["bunny", "teapot"])
def test_blobs_are_closed_and_outward(name):
    mesh = load_obj(os.path.join(OUR_ASSETS, f"{name}.obj"))
    v, _, _ = mesh.triangles()
    # closed: every undirected edge (by position) is shared by two faces
    pos = np.round(v.reshape(-1, 3), 5)
    _, vid = np.unique(pos, axis=0, return_inverse=True)
    vid = vid.reshape(-1, 3)
    edges = np.sort(np.concatenate([vid[:, [0, 1]], vid[:, [1, 2]], vid[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    # outward: the enclosed volume (divergence theorem) is positive
    vol = np.einsum("ij,ij->i", v[:, 0], np.cross(v[:, 1], v[:, 2])).sum() / 6.0
    assert vol > 0
    assert v[..., 1].min() == pytest.approx(0.0, abs=1e-6)  # rests on y = 0


def test_bench_scene_triangle_count():
    _, info = compile_scene(os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml"), layout="tlas")
    assert info.triangle_count == 10952
    assert info.object_count == 3
