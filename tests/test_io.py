"""I/O layer tests: OBJ loading (dedup/triangulation), XML parsing, asset
resolution and texture decode."""

import os

import numpy as np
import pytest

from cpu_ray_tracer_tpu.io import image as image_mod
from cpu_ray_tracer_tpu.io import obj as obj_mod
from cpu_ray_tracer_tpu.io import scene_xml as sx

from tests.conftest import OUR_ASSETS, upstream_asset


class TestObj:
    def test_cube_triangulation(self):
        mesh = obj_mod.load_obj(os.path.join(OUR_ASSETS, "cube.obj"))
        # 6 quad faces fan-triangulate into 12 tris.
        assert mesh.num_tris == 12
        # cube has 8 positions but per-corner normals/uvs split them; dedup
        # must produce more than 8 but no more than 36 unique vertices.
        assert 8 < mesh.positions.shape[0] <= 36
        assert mesh.positions.min() == -1.0 and mesh.positions.max() == 1.0
        # all normals unit length
        np.testing.assert_allclose(
            np.linalg.norm(mesh.normals, axis=-1), 1.0, atol=1e-5
        )

    def test_bunny_no_uv(self):
        mesh = obj_mod.load_obj(os.path.join(OUR_ASSETS, "bunny.obj"))
        assert mesh.num_tris == 4968  # grep -c "^f " bunny.obj
        assert np.all(mesh.uvs == 0.0)  # bunny has no vt records
        assert np.linalg.norm(mesh.normals, axis=-1).min() > 0.9

    def test_dedup_reuses_vertices(self):
        mesh = obj_mod.load_obj(os.path.join(OUR_ASSETS, "teapot.obj"))
        # Far fewer unique vertices than 3*ntris if dedup works.
        assert mesh.positions.shape[0] < mesh.num_tris * 3 * 0.6

    def test_triangle_arrays(self):
        mesh = obj_mod.load_obj(os.path.join(OUR_ASSETS, "cube.obj"))
        v, n, uv = mesh.triangles()
        assert v.shape == (12, 3, 3)
        assert n.shape == (12, 3, 3)
        assert uv.shape == (12, 3, 2)


class TestSceneXml:
    def test_parse_reference_inside_scene(self):
        spec = sx.load_scene_xml(upstream_asset("scenes/inside_scene.xml"))
        assert spec.name == "tower scene"
        np.testing.assert_allclose(spec.light_pos, [0.0, 1.0, 2.0])
        assert len(spec.objects) == 9
        assert len(spec.materials) == 3
        assert spec.objects[0].model_location.endswith("wok.obj")
        np.testing.assert_allclose(spec.objects[1].rotation, [0.0, 90.0, 0.0])
        np.testing.assert_allclose(spec.objects[0].scale, [0.5, 0.5, 0.5])
        assert spec.materials[0].texture_location.endswith("Defuse_wok.png")

    def test_parse_our_scene(self):
        spec = sx.load_scene_xml(os.path.join(OUR_ASSETS, "scenes", "bunny_teapot.xml"))
        assert len(spec.objects) == 3
        assert spec.materials[1].reflectivity == 0.9
        assert spec.materials[2].refractivity == 0.9

    def test_resolve_reference_asset(self):
        wok = upstream_asset("wok.obj")
        xml_dir = os.path.join(os.path.dirname(wok), "scenes")
        p = sx.resolve_asset("../assets/wok.obj", xml_dir)
        assert p == wok

    def test_resolve_substitute_for_missing_hdr(self):
        xml_dir = os.path.join(OUR_ASSETS, "scenes")
        p = sx.resolve_asset("../assets/industrial_sunset_puresky_4k.hdr", xml_dir)
        assert p.endswith("industrial_sunset_puresky_4k.png")
        assert os.path.isfile(p)

    def test_resolve_substitute_log_fence(self):
        xml_dir = os.path.join(OUR_ASSETS, "scenes")
        p = sx.resolve_asset("../assets/textures/log_fence.png", xml_dir)
        assert os.path.isfile(p)

    def test_missing_asset_raises(self):
        with pytest.raises(FileNotFoundError):
            sx.resolve_asset("../assets/nope_does_not_exist.obj", OUR_ASSETS)


class TestImages:
    def test_load_png(self):
        img = image_mod.load_texture_image(
            os.path.join(OUR_ASSETS, "textures", "log_fence.png")
        )
        assert img.ndim == 3 and img.shape[2] == 3
        assert img.dtype == np.float32
        assert 0.0 <= img.min() and img.max() <= 1.0

    def test_load_jpg_and_tga(self, tmp_path):
        # JPEG and TGA are not decoded (no image library on the main path):
        # they must fail loudly, naming the file, not load as garbage
        for name, head in (("t.jpg", b"\xff\xd8\xff\xe0"), ("t.tga", b"\x00\x00\x02")):
            path = tmp_path / name
            path.write_bytes(head + bytes(64))
            with pytest.raises(ValueError, match=name):
                image_mod.load_texture_image(str(path))

    def test_hdr_roundtrip(self, tmp_path):
        # Write a tiny flat (non-RLE) HDR and read it back.
        h, w = 2, 4
        rgbe = np.zeros((h, w, 4), np.uint8)
        rgbe[..., 0] = 128  # r mantissa
        rgbe[..., 3] = 129  # exponent -> *2^(129-136)*128 = 1.0
        with open(tmp_path / "t.hdr", "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
            f.write(f"-Y {h} +X {w}\n".encode())
            f.write(rgbe.tobytes())
        img = image_mod.load_texture_image(str(tmp_path / "t.hdr"), keep_float=True)
        np.testing.assert_allclose(img[..., 0], 1.0, rtol=1e-6)
        np.testing.assert_allclose(img[..., 1:], 0.0)

    def test_urn_substitute_loads(self):
        mesh = obj_mod.load_obj(os.path.join(OUR_ASSETS, "urna.obj"))
        assert mesh.num_tris > 100
