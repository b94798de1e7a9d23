"""SBVH spatial-split builder (native crt_build_sbvh, VERDICT r3 ask #2)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracer_tpu.accel import bvh_builder, native
from cpu_ray_tracer_tpu.accel.types import to_device_f32, to_device_i32
from cpu_ray_tracer_tpu.accel.compile import make_triangle_pool
from cpu_ray_tracer_tpu.accel.types import BVHArrays
from cpu_ray_tracer_tpu.ops import intersect, traverse_bvh


class TestSBVH:
    """Straddling triangle references duplicate into both children with
    clipped boxes.  Hits must match the brute-force oracle exactly, and the
    structural invariants (bounds contain children, every triangle
    referenced) must hold."""

    def test_sbvh_invariants_and_hits(self, rng, monkeypatch):
        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        # mixed soup: diagonal slivers + local tris.  NOTE: duplication is
        # NOT asserted here — on many synthetic layouts the SAH cost
        # correctly prefers object splits (chopping every straddler costs
        # more than one overlapping leaf); profitable spatial splits are
        # asserted on a real tessellated mesh in test_sbvh_duplicates_on_mesh
        slivers = []
        for i in range(64):
            y0 = -3.0 + 3.0 * i / 63.0
            z = float(np.sin(i)) * 0.5
            slivers.append(
                [[-4.0, y0, z], [4.0, y0 + 3.0, z + 0.02], [4.0, y0 + 3.02, z]]
            )
        base = rng.uniform(-3, 3, size=(236, 1, 3))
        small = base + rng.normal(0, 0.1, size=(236, 3, 3))
        tri_np = np.concatenate(
            [np.asarray(slivers, np.float32), small.astype(np.float32)], axis=0
        )
        monkeypatch.setenv("CRT_SBVH", "1")
        host, idx, stats = bvh_builder.build_bvh(tri_np, leaf_target=8)
        assert set(idx.tolist()) == set(range(300))
        for ni in range(host.nodes_used):
            for ch in (host.left[ni], host.right[ni]):
                if ch >= 0:
                    assert (host.node_min[ch] >= host.node_min[ni] - 1e-4).all()
                    assert (host.node_max[ch] <= host.node_max[ni] + 1e-4).all()

        # device traversal vs brute-force oracle (a duplicated reference is
        # tested in several leaves; the running-min makes that idempotent)
        pool = make_triangle_pool(tri_np)
        hit, miss = bvh_builder.thread_links(
            host.left, host.right, host.tri_count, host.axis
        )
        bvh = BVHArrays(
            node_min=to_device_f32(host.node_min),
            node_max=to_device_f32(host.node_max),
            left_first=to_device_i32(host.left_first),
            tri_count=to_device_i32(host.tri_count),
            hit_link=to_device_i32(hit),
            miss_link=to_device_i32(miss),
            tri_indices=to_device_i32(idx),
            max_leaf=stats.max_leaf,
            max_depth=stats.max_depth,
        )
        o = jnp.asarray(rng.uniform(-4, 4, size=(256, 3)).astype(np.float32))
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
        t0 = jnp.full((256,), 1e34, jnp.float32)
        res = traverse_bvh.traverse(bvh, pool, o, d, t0)
        bt, _, _, btri = intersect.brute_force_nearest(
            o, d, t0, pool.v0, pool.e1, pool.e2
        )
        np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(bt), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(res["tri_idx"]), np.asarray(btri))

    def test_sbvh_duplicates_on_mesh(self):
        """On a real scanned mesh spatial splits do fire: the Stanford
        bunny builds with ~6% duplicated references, every triangle still
        referenced.  The repository's stand-in bunny is a smooth blob whose
        SAH cost never favours a spatial split, so this needs the upstream
        file."""
        from cpu_ray_tracer_tpu.io.obj import load_obj

        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        from conftest import upstream_asset

        path = upstream_asset("bunny.obj")
        tv = load_obj(path).triangles()[0].astype(np.float32)
        out = native.build_sbvh_native(tv, leaf_target=24)
        assert out is not None
        h, idx, st = out
        assert idx.shape[0] > tv.shape[0]  # real duplication
        assert set(idx.tolist()) == set(range(tv.shape[0]))

    def test_sbvh_render_matches_sah(self, monkeypatch):
        """Same image through SBVH and plain SAH on the cube scene."""
        import os

        from cpu_ray_tracer_tpu.core import camera as cam_mod
        from cpu_ray_tracer_tpu.render import whitted
        from cpu_ray_tracer_tpu.scene.build import compile_scene

        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        from conftest import OUR_ASSETS

        xml = os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml")
        monkeypatch.setenv("CRT_SBVH", "1")
        s_sbvh, _ = compile_scene(xml, layout="tlas")
        monkeypatch.setenv("CRT_SBVH", "0")
        s_sah, _ = compile_scene(xml, layout="tlas")
        cam = cam_mod.make_camera(32, 20)
        a = np.asarray(whitted.render(s_sbvh, cam)["image"])
        b = np.asarray(whitted.render(s_sah, cam)["image"])
        np.testing.assert_allclose(a, b, atol=2e-5)
