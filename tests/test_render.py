"""End-to-end golden tests: Whitted wavefront vs the scalar reference-
semantics oracle; path-tracer estimator sanity; AOV renderers."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracer_tpu.core import camera as cam_mod
from cpu_ray_tracer_tpu.render import basics, pathtracer, whitted
from cpu_ray_tracer_tpu.scene.build import compile_scene

from tests.conftest import OUR_ASSETS, upstream_asset
from tests.oracle import WhittedOracle

CUBE_XML = os.path.join(OUR_ASSETS, "scenes", "cube_scene.xml")
BENCH_XML = os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml")


@pytest.fixture(scope="module")
def cube_scene():
    return compile_scene(CUBE_XML, layout="tlas")


@pytest.fixture(scope="module")
def cube_scene_mono():
    return compile_scene(CUBE_XML, layout="mono")


@pytest.fixture(scope="module")
def small_cam():
    # camera looking at the cube at z=2.5 from the reference default pose
    return cam_mod.make_camera(32, 20)


class TestWhittedGolden:
    def test_matches_scalar_oracle_tlas(self, cube_scene, small_cam):
        scene, info = cube_scene
        out = whitted.render(scene, small_cam)
        img = np.asarray(out["image"])
        ref = WhittedOracle(scene).render(small_cam)
        assert img.shape == ref.shape
        np.testing.assert_allclose(img, ref, atol=2e-3, rtol=1e-3)

    def test_matches_scalar_oracle_mono(self, cube_scene_mono, small_cam):
        scene, info = cube_scene_mono
        out = whitted.render(scene, small_cam)
        np.testing.assert_allclose(
            np.asarray(out["image"]),
            WhittedOracle(scene).render(small_cam),
            atol=2e-3,
            rtol=1e-3,
        )

    def test_image_nonempty_and_finite(self, cube_scene, small_cam):
        scene, _ = cube_scene
        img = np.asarray(whitted.render(scene, small_cam)["image"])
        assert np.isfinite(img).all()
        assert img.max() > 0.01  # sky at least
        assert int(np.asarray(whitted.render(scene, small_cam)["dropped"])) == 0

    def test_adaptive_cap_grows_until_no_drop(self):
        # grow-or-fail policy: start with a deliberately tiny child buffer on
        # a mirror/dielectric scene; render_adaptive must double the cap until
        # nothing is dropped (or raise), never return a biased image
        scene, info = compile_scene(BENCH_XML, layout="tlas")
        cam = cam_mod.make_camera(24, 16)
        grows = []
        out = whitted.render_adaptive(
            scene, cam, cap_factor=0.01,
            on_grow=lambda n, cf: grows.append((n, cf)),
        )
        assert int(np.asarray(out["dropped"])) == 0
        assert grows, "expected at least one cap growth at cap_factor=0.01"
        assert out["cap_factor"] == grows[-1][1]
        # and the grown render matches a comfortably-sized direct render
        # (render_jit on both sides: jit FMA contraction can flip borderline
        # edge hits vs the eager path, which is fp sensitivity, not bias)
        ref = whitted.render_jit(scene, cam, cap_factor=4.0)
        np.testing.assert_allclose(
            np.asarray(out["image"]), np.asarray(ref["image"]), atol=1e-5
        )

    def test_mirror_and_dielectric_branches(self, small_cam):
        # bench scene has mirror + dielectric materials; must stay finite
        scene, info = compile_scene(BENCH_XML, layout="tlas")
        cam = cam_mod.make_camera(24, 16)
        out = whitted.render(scene, cam)
        img = np.asarray(out["image"])
        assert np.isfinite(img).all()
        assert img.max() > 0.01


class TestSceneInfo:
    def test_counts(self, cube_scene):
        scene, info = cube_scene
        assert info.triangle_count == 12
        assert info.object_count == 1
        assert info.build_time_us > 0

    def test_inside_scene_compiles(self):
        scene, info = compile_scene(upstream_asset("scenes/inside_scene.xml"), layout="tlas")
        assert info.object_count == 9
        # wok (3536 tris after quad fan-triangulation) + watch-tower (2036)
        # + 7 log_fence instances (836 each)
        assert info.triangle_count == 3536 + 2036 + 7 * 836
        assert scene.bvh.num_nodes > 100


class TestUpstreamGoldens:
    """Mid-res regression pins on the upstream default scene (inside_scene,
    2. WhittedStyle/renderer.h:57) — catches estimator/traversal drift at a
    realistic scale, not just the 12-tri cube.  Goldens generated by
    tools/gen_goldens.py (oracle Whitted + fixed-seed PT pass on CPU)."""

    GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
    @pytest.fixture(scope="class")
    def inside_scene(self):
        return compile_scene(upstream_asset("scenes/inside_scene.xml"), layout="tlas")

    def test_whitted_matches_oracle_golden_160x100(self, inside_scene):
        scene, info = inside_scene
        golden = np.load(os.path.join(self.GOLDEN_DIR, "inside_whitted_160x100.npy"))
        cam = cam_mod.make_camera(160, 100)
        img = np.asarray(whitted.render(scene, cam)["image"])
        assert img.shape == golden.shape
        d = np.abs(img - golden).max(axis=-1)
        # borderline edge/shadow pixels legitimately flip between the scalar
        # oracle and the wavefront (fp-order sensitivity at discontinuities);
        # the regression pin is "almost all pixels agree tightly"
        assert (d > 2e-3).mean() < 0.005, f"{(d > 2e-3).mean():.4%} pixels off"
        assert np.abs(img - golden).mean() < 2e-3

    def test_pt_fixed_seed_golden_64x40(self, inside_scene):
        scene, info = inside_scene
        golden = np.load(os.path.join(self.GOLDEN_DIR, "inside_pt_64x40_pass0.npy"))
        cam = cam_mod.make_camera(64, 40)
        img, _ = pathtracer.render_pass(scene, cam, jnp.uint32(0))
        # same platform (CPU conftest) + fixed seed: bit-exact
        np.testing.assert_array_equal(np.asarray(img), golden)


class TestAOVs:
    @pytest.mark.parametrize("aov", ["albedo", "normal", "depth", "traversal", "obj_id"])
    def test_aov_shapes(self, cube_scene, small_cam, aov):
        scene, _ = cube_scene
        img = np.asarray(basics.render(scene, small_cam, aov=aov))
        assert img.shape == (20, 32, 3)
        assert np.isfinite(img).all()


class TestPathTracer:
    def test_energy_consistency_across_spp(self, cube_scene):
        # estimator consistency: mean image over k passes converges; the
        # per-pass energies agree within MC noise (reference's 'energy'
        # metric, 3. PathTracer/renderer.cpp:155-157)
        scene, _ = cube_scene
        cam = cam_mod.make_camera(16, 10)
        imgs = []
        for p in range(4):
            img, stats = pathtracer.render_pass(scene, cam, jnp.uint32(p))
            imgs.append(np.asarray(img))
        energies = [i.sum() for i in imgs]
        m = np.mean(energies)
        assert m > 0
        for e in energies:
            assert abs(e - m) / m < 0.5  # loose MC bound

    def test_deterministic_given_seed(self, cube_scene):
        scene, _ = cube_scene
        cam = cam_mod.make_camera(8, 8)
        a, _ = pathtracer.render_pass(scene, cam, jnp.uint32(3))
        b, _ = pathtracer.render_pass(scene, cam, jnp.uint32(3))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_megapass_matches_single_sample_passes(self, cube_scene):
        # a k-sample megapass (samples_per_pass=k) draws the same per-sample
        # RNG streams as k consecutive 1-sample passes, so the summed images
        # must be bit-identical — only batching differs, not the estimator
        scene, _ = cube_scene
        cam = cam_mod.make_camera(16, 10)
        a1, _ = pathtracer.render_pass(scene, cam, jnp.uint32(1))
        a2, _ = pathtracer.render_pass(scene, cam, jnp.uint32(2))
        m, _ = pathtracer.render_pass(scene, cam, jnp.uint32(1), samples_per_pass=2)
        np.testing.assert_allclose(np.asarray(a1 + a2), np.asarray(m), atol=1e-5)

    def test_pt_matches_whitted_on_pure_diffuse_direct(self, cube_scene):
        # With a diffuse-only scene, PT's *expected* first-bounce radiance
        # differs from Whitted's (ambient vs sampled sky), so just check
        # finiteness and positivity here.
        scene, _ = cube_scene
        cam = cam_mod.make_camera(16, 10)
        img, stats = pathtracer.render_pass(scene, cam, jnp.uint32(0))
        img = np.asarray(img)
        assert np.isfinite(img).all()
        assert img.max() > 0.01
        assert int(np.asarray(stats["rays_traced"])) >= 16 * 10


class TestAccelInterchange:
    """The reference's headline property: accelerators are interchangeable
    and produce the same image (SURVEY.md §4 item 3)."""

    def test_grid_and_kdtree_match_bvh_whitted(self, small_cam):
        import numpy as np

        imgs = {}
        for accel in ("bvh", "grid", "kdtree"):
            scene, _ = compile_scene(CUBE_XML, layout="mono", accel=accel)
            imgs[accel] = np.asarray(whitted.render(scene, small_cam)["image"])
        np.testing.assert_allclose(imgs["grid"], imgs["bvh"], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(imgs["kdtree"], imgs["bvh"], atol=2e-3, rtol=1e-3)

    def test_tlas_grid_and_kdtree_match_bvh(self, small_cam):
        """TLASGrid / TLASKDTree equivalents (per-instance BLAS structures
        chained under the tlas layout, ops/forest.py) — multi-instance scene
        so the forest actually has >1 member."""
        imgs = {}
        for accel in ("bvh", "grid", "kdtree"):
            scene, info = compile_scene(BENCH_XML, layout="tlas", accel=accel)
            assert info.object_count == 3
            imgs[accel] = np.asarray(whitted.render(scene, small_cam)["image"])
        np.testing.assert_allclose(imgs["grid"], imgs["bvh"], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(imgs["kdtree"], imgs["bvh"], atol=2e-3, rtol=1e-3)
