"""The zlib + numpy PNG reader and writer (io/image.py), against PIL's
decoder where PIL is installed."""

import os
import struct
import zlib

import numpy as np
import pytest

from cpu_ray_tracer_tpu.core import film
from cpu_ray_tracer_tpu.io import image

from tests.conftest import OUR_ASSETS

COMMITTED = [
    "industrial_sunset_puresky_4k.png",
    "textures/log_fence.png",
    "textures/T_Trim_01_BaseColor.png",
    "textures/urna.png",
]


@pytest.mark.parametrize("shape", [(7, 5, 3), (4, 9)])
def test_write_read_roundtrip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    image.write_png(path, img)
    got = image.read_png(path)
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_film_write_png_is_readable(tmp_path):
    img = np.zeros((3, 4, 3), np.uint8)
    img[1, 2] = (255, 128, 7)
    path = str(tmp_path / "f.png")
    film.write_png(path, img)
    np.testing.assert_array_equal(image.read_png(path), img)


@pytest.mark.parametrize("rel", COMMITTED)
def test_committed_textures_match_pil(rel):
    pil = pytest.importorskip("PIL.Image")
    path = os.path.join(OUR_ASSETS, rel)
    want = np.asarray(pil.open(path).convert("RGB"))
    got = image.load_texture_image(path)
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_pil_written_pngs_decode_like_pil(tmp_path, mode):
    """Files written by another encoder: every scanline filter it picks
    (Average and Paeth included), palettes, alpha and 16-bit samples."""
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (13, 11, 3), dtype=np.uint8)
    base[:, :5] = base[:1, :5]  # smooth columns so the encoder varies filters
    img = pil.fromarray(base, "RGB")
    if mode == "I;16":
        img = pil.fromarray((base[..., 0].astype("<u2") * 257))
    elif mode != "RGB":
        img = img.convert(mode)
    path = str(tmp_path / f"{mode.replace(';', '')}.png")
    img.save(path)
    decoded = pil.open(path)
    want_mode = "RGB" if mode in ("RGB", "RGBA", "P") else "L"
    want = np.asarray(decoded.convert("RGB"))
    if mode == "I;16":
        want = np.repeat((np.asarray(decoded).astype(np.uint32) >> 8).astype(np.uint8)[..., None], 3, -1)
    elif want_mode == "L":
        want = np.repeat(np.asarray(decoded.convert("L"))[..., None], 3, -1)
    got = image.load_texture_image(path)
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), want)


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


@pytest.mark.parametrize("flaw", ["not_png", "bad_crc", "interlaced", "depth4", "truncated"])
def test_unreadable_pngs_fail_loudly(tmp_path, flaw):
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1 if flaw == "interlaced" else 0)
    if flaw == "depth4":
        ihdr = struct.pack(">IIBBBBB", 2, 2, 4, 0, 0, 0, 0)
    raw = zlib.compress(bytes(2 * (1 + 6)))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", raw) + _chunk(b"IEND", b"")
    if flaw == "not_png":
        data = b"GIF89a" + data[8:]
    elif flaw == "bad_crc":
        data = data[:-1] + bytes([data[-1] ^ 1])
    elif flaw == "truncated":
        data = data[: len(data) - 12]
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="bad.png"):
        image.load_texture_image(str(path))
