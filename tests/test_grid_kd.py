"""Grid and KD-tree builders + traversal vs brute-force oracle."""

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.accel import grid_builder, kdtree_builder
from cpu_ray_tracer_tpu.accel.compile import make_triangle_pool
from cpu_ray_tracer_tpu.ops import intersect, traverse_grid, traverse_kd


def random_tris(rng, n, spread=4.0):
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)


def random_rays(rng, r, spread=6.0):
    o = rng.uniform(-spread, spread, size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


class TestGridBuild:
    def test_resolution_rule(self, rng):
        tri_v = random_tris(rng, 500)
        host, stats = grid_builder.build_grid(tri_v)
        rx, ry, rz = host["resolution"]
        assert 1 <= rx <= 128 and 1 <= ry <= 128 and 1 <= rz <= 128
        # CSR structure is consistent
        assert host["cell_start"][0] == 0
        assert host["cell_start"][-1] == len(host["cell_tris"])
        assert stats.max_leaf > 0

    def test_every_tri_in_some_cell(self, rng):
        tri_v = random_tris(rng, 100)
        host, _ = grid_builder.build_grid(tri_v)
        assert set(host["cell_tris"].tolist()) == set(range(100))


class TestGridTraversal:
    def test_matches_brute_force(self, rng):
        tri_v = random_tris(rng, 200)
        pool = make_triangle_pool(tri_v)
        host, _ = grid_builder.build_grid(tri_v)
        grid = grid_builder.to_device(host)
        o, d = random_rays(rng, 256)
        t0 = jnp.full((256,), 1e34, jnp.float32)
        res = traverse_grid.traverse(grid, pool, o, d, t0)
        bt, _, _, btri = intersect.brute_force_nearest(o, d, t0, pool.v0, pool.e1, pool.e2)
        np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(bt), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(res["tri_idx"]), np.asarray(btri))

    def test_ray_from_inside_grid(self, rng):
        tri_v = random_tris(rng, 100, spread=2.0)
        pool = make_triangle_pool(tri_v)
        grid = grid_builder.to_device(grid_builder.build_grid(tri_v)[0])
        o = jnp.zeros((8, 3))
        d = jnp.asarray(np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        t0 = jnp.full((8,), 1e34, jnp.float32)
        res = traverse_grid.traverse(grid, pool, o, d, t0)
        bt, _, _, btri = intersect.brute_force_nearest(o, d, t0, pool.v0, pool.e1, pool.e2)
        np.testing.assert_array_equal(np.asarray(res["tri_idx"]), np.asarray(btri))


class TestKDTree:
    def test_build_invariants(self, rng):
        tri_v = random_tris(rng, 300)
        host, stats = kdtree_builder.build_kdtree(tri_v)
        leaves = host["split_axis"] == -1
        # every tri appears in at least one leaf (duplication allowed)
        covered = set(host["tri_ids"].tolist())
        assert covered == set(range(300))
        assert stats.max_depth <= 20
        # interior nodes have both children
        interior = ~leaves
        assert (host["left"][interior] >= 0).all()
        assert (host["right"][interior] >= 0).all()

    def test_matches_brute_force(self, rng):
        tri_v = random_tris(rng, 200)
        pool = make_triangle_pool(tri_v)
        kd = kdtree_builder.to_device(kdtree_builder.build_kdtree(tri_v)[0])
        o, d = random_rays(rng, 256)
        t0 = jnp.full((256,), 1e34, jnp.float32)
        res = traverse_kd.traverse(kd, pool, o, d, t0)
        bt, _, _, btri = intersect.brute_force_nearest(o, d, t0, pool.v0, pool.e1, pool.e2)
        np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(bt), rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(res["tri_idx"]), np.asarray(btri))

    def test_sah_variant_matches(self, rng):
        tri_v = random_tris(rng, 150)
        pool = make_triangle_pool(tri_v)
        kd = kdtree_builder.to_device(kdtree_builder.build_kdtree(tri_v, sah=True)[0])
        o, d = random_rays(rng, 128)
        t0 = jnp.full((128,), 1e34, jnp.float32)
        res = traverse_kd.traverse(kd, pool, o, d, t0)
        bt, _, _, btri = intersect.brute_force_nearest(o, d, t0, pool.v0, pool.e1, pool.e2)
        np.testing.assert_array_equal(np.asarray(res["tri_idx"]), np.asarray(btri))

    def test_any_hit(self, rng):
        tri_v = random_tris(rng, 100)
        pool = make_triangle_pool(tri_v)
        kd = kdtree_builder.to_device(kdtree_builder.build_kdtree(tri_v)[0])
        o, d = random_rays(rng, 128)
        t0 = jnp.full((128,), 1e34, jnp.float32)
        near = traverse_kd.traverse(kd, pool, o, d, t0)
        anyh = traverse_kd.traverse(kd, pool, o, d, t0, any_hit=True)
        np.testing.assert_array_equal(
            np.asarray(near["tri_idx"]) >= 0, np.asarray(anyh["tri_idx"]) >= 0
        )

