"""BVH builder invariants + threaded traversal vs brute-force oracle."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracer_tpu.accel import bvh_builder
from cpu_ray_tracer_tpu.accel.compile import compile_bvh, make_triangle_pool
from cpu_ray_tracer_tpu.io import obj as obj_mod
from cpu_ray_tracer_tpu.ops import intersect, traverse_bvh

from tests.conftest import OUR_ASSETS


def random_tris(rng, n, spread=4.0):
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)


def check_invariants(host, idx, n_tris):
    # triangle indices are a permutation
    assert sorted(idx.tolist()) == list(range(n_tris))
    is_leaf = host.tri_count > 0
    covered = np.zeros(n_tris, bool)
    for node in range(host.nodes_used):
        lo = host.node_min[node]
        hi = host.node_max[node]
        assert np.all(lo <= hi + 1e-6)
        if is_leaf[node]:
            f, c = host.left_first[node], host.tri_count[node]
            assert not covered[idx[f : f + c]].any()  # disjoint partition
            covered[idx[f : f + c]] = True
        else:
            li, ri = host.left[node], host.right[node]
            for ch in (li, ri):
                # child bounds contained in parent bounds
                assert np.all(host.node_min[ch] >= lo - 1e-4)
                assert np.all(host.node_max[ch] <= hi + 1e-4)
    assert covered.all()


class TestBuilder:
    def test_invariants_random(self, rng):
        tri_v = random_tris(rng, 300)
        host, idx, stats = bvh_builder.build_bvh(tri_v)
        check_invariants(host, idx, 300)
        assert stats.max_leaf <= 4  # force_split_cap default
        assert stats.num_nodes <= 2 * 300 - 1

    def test_invariants_parity_mode(self, rng):
        tri_v = random_tris(rng, 200)
        host, idx, stats = bvh_builder.build_bvh(tri_v, force_split_cap=None)
        check_invariants(host, idx, 200)

    def test_invariants_midpoint(self, rng):
        tri_v = random_tris(rng, 150)
        host, idx, stats = bvh_builder.build_bvh(tri_v, sah=False)
        check_invariants(host, idx, 150)

    def test_single_triangle(self):
        tri_v = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
        host, idx, stats = bvh_builder.build_bvh(tri_v)
        assert host.nodes_used == 1
        assert stats.max_leaf == 1

    def test_bunny_build(self):
        mesh = obj_mod.load_obj(os.path.join(OUR_ASSETS, "bunny.obj"))
        v, _, _ = mesh.triangles()
        host, idx, stats = bvh_builder.build_bvh(v)
        check_invariants(host, idx, mesh.num_tris)
        assert stats.max_depth > 5  # nontrivial tree


class TestLinks:
    def test_links_cover_all_nodes(self, rng):
        tri_v = random_tris(rng, 100)
        host, idx, _ = bvh_builder.build_bvh(tri_v)
        hit, miss = bvh_builder.thread_links(host.left, host.right, host.tri_count, host.axis)
        m = host.nodes_used
        for o in range(8):
            # walking hit links from root in "always hit" mode visits every
            # node exactly once (threaded DFS property)
            seen = set()
            cur = 0
            while cur != -1:
                assert cur not in seen
                seen.add(cur)
                if host.tri_count[cur] > 0:
                    cur = int(miss[o, cur])
                else:
                    cur = int(hit[o, cur])
            assert len(seen) == m
            # "always miss" from root terminates immediately
            assert miss[o, 0] == -1

    def test_octant_ordering(self):
        # Two tris left (x<0) and right (x>0); for +x rays left child comes
        # first, for -x rays right child comes first.
        tri_v = np.array(
            [
                [[-2, 0, 0], [-1, 0, 0], [-1.5, 1, 0]],
                [[-2, 0, 1], [-1, 0, 1], [-1.5, 1, 1]],
                [[1, 0, 0], [2, 0, 0], [1.5, 1, 0]],
                [[1, 0, 1], [2, 0, 1], [1.5, 1, 1]],
            ],
            np.float32,
        )
        host, idx, _ = bvh_builder.build_bvh(tri_v, sah=False)
        if host.nodes_used == 1:
            pytest.skip("degenerate single-node tree")
        hit, miss = bvh_builder.thread_links(host.left, host.right, host.tri_count, host.axis)
        first_pos = hit[0, 0]  # octant 0: +x,+y,+z
        first_neg = hit[1, 0]  # octant 1: -x
        # children hold disjoint x ranges; near-first order must differ
        assert first_pos != first_neg


class TestTraversal:
    def _pool_and_bvh(self, rng, n=256, **kw):
        tri_v = random_tris(rng, n)
        pool = make_triangle_pool(tri_v, mat_id=np.arange(n, dtype=np.int32) % 5)
        bvh, stats = compile_bvh(tri_v, **kw)
        return tri_v, pool, bvh

    def test_matches_brute_force(self, rng):
        tri_v, pool, bvh = self._pool_and_bvh(rng, 256)
        r = 512
        o = rng.uniform(-6, 6, size=(r, 3)).astype(np.float32)
        d = rng.normal(size=(r, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t0 = jnp.full((r,), 1e34, jnp.float32)
        res = traverse_bvh.traverse(bvh, pool, jnp.asarray(o), jnp.asarray(d), t0)
        bt, bu, bv, btri = intersect.brute_force_nearest(
            jnp.asarray(o), jnp.asarray(d), t0, pool.v0, pool.e1, pool.e2
        )
        np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(bt), rtol=1e-5)
        # same triangle chosen (modulo exact ties, which are measure-zero here)
        np.testing.assert_array_equal(np.asarray(res["tri_idx"]), np.asarray(btri))
        hit_rate = float((np.asarray(res["tri_idx"]) >= 0).mean())
        assert hit_rate > 0.05  # sanity: some rays do hit

    def test_parity_mode_matches_too(self, rng):
        tri_v, pool, bvh = self._pool_and_bvh(rng, 128, force_split_cap=None)
        r = 256
        o = rng.uniform(-6, 6, size=(r, 3)).astype(np.float32)
        d = rng.normal(size=(r, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t0 = jnp.full((r,), 1e34, jnp.float32)
        res = traverse_bvh.traverse(bvh, pool, jnp.asarray(o), jnp.asarray(d), t0)
        bt, _, _, btri = intersect.brute_force_nearest(
            jnp.asarray(o), jnp.asarray(d), t0, pool.v0, pool.e1, pool.e2
        )
        np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(bt), rtol=1e-5)

    def test_any_hit_occlusion(self, rng):
        tri_v, pool, bvh = self._pool_and_bvh(rng, 256)
        r = 256
        o = rng.uniform(-6, 6, size=(r, 3)).astype(np.float32)
        d = rng.normal(size=(r, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t0 = jnp.full((r,), 1e34, jnp.float32)
        near = traverse_bvh.traverse(bvh, pool, jnp.asarray(o), jnp.asarray(d), t0)
        anyh = traverse_bvh.traverse(bvh, pool, jnp.asarray(o), jnp.asarray(d), t0, any_hit=True)
        np.testing.assert_array_equal(
            np.asarray(near["tri_idx"]) >= 0, np.asarray(anyh["tri_idx"]) >= 0
        )
        # any-hit must do no more traversal steps than nearest-hit
        assert int(anyh["traversed"].sum()) <= int(near["traversed"].sum())

    def test_shadow_t_max_respected(self, rng):
        # Triangle at z=2; shadow ray with max dist 1.5 must not see it.
        tri_v = np.array([[[-5, -5, 2], [5, -5, 2], [0, 5, 2]]], np.float32)
        pool = make_triangle_pool(tri_v)
        bvh, _ = compile_bvh(tri_v)
        o = jnp.zeros((1, 3))
        d = jnp.array([[0.0, 0.0, 1.0]])
        res_far = traverse_bvh.traverse(bvh, pool, o, d, jnp.array([1e34], jnp.float32))
        res_near = traverse_bvh.traverse(bvh, pool, o, d, jnp.array([1.5], jnp.float32))
        assert int(res_far["tri_idx"][0]) == 0
        assert int(res_near["tri_idx"][0]) == -1

    def test_interpolate_hit(self, rng):
        tri_v = np.array([[[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32)
        uv = np.array([[[0, 0], [1, 0], [0, 1]]], np.float32)
        pool = make_triangle_pool(tri_v, tri_uv=uv)
        n, uv_out = traverse_bvh.interpolate_hit(
            pool, jnp.array([0]), jnp.array([[0.25, 0.5]])
        )
        np.testing.assert_allclose(np.asarray(uv_out)[0], [0.25, 0.5], atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(n)[0]), 1.0, atol=1e-5)

    def test_traversal_counters_populated(self, rng):
        tri_v, pool, bvh = self._pool_and_bvh(rng, 64)
        o = np.zeros((4, 3), np.float32)
        d = np.tile(np.array([[1.0, 0, 0]], np.float32), (4, 1))
        res = traverse_bvh.traverse(
            bvh, pool, jnp.asarray(o), jnp.asarray(d), jnp.full((4,), 1e34, jnp.float32)
        )
        assert int(res["traversed"].max()) >= 1
