"""Texture image loading and PNG output (host side, numpy + zlib).

Reproduces the reference's stb_image path (template/texture.h:15-39): decode
to 8-bit, expand greyscale to RGB, drop alpha, and store as float32 in
[0, 1].  Note the reference pushes even its "HDR" skydome through this 8-bit
LDR path — we keep that quantization so renders match (SURVEY.md §7 quirk
list), unless `keep_float=True` (the differentiable pipeline's high-precision
mode).

Formats read: PNG (8- and 16-bit, non-interlaced, every colour type) and
Radiance .hdr.  Anything else raises ValueError naming the file: JPEG and
TGA textures must be converted to PNG first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples/pixel


def load_texture_image(path: str, keep_float: bool = False) -> np.ndarray:
    """Returns float32 [H, W, 3] in [0, 1]."""
    if path.lower().endswith(".hdr"):
        rgb = _load_radiance_hdr(path)
        if not keep_float:
            # stb would LDR-clamp: quantize to 8 bits like the reference.
            rgb = np.round(np.clip(rgb, 0.0, 1.0) * 255.0) / 255.0
        return rgb.astype(np.float32)
    arr = read_png(path)
    if arr.shape[2] <= 2:  # greyscale (+ alpha) expand (texture.h:25-33)
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    return arr[..., :3].astype(np.float32) / 255.0


def _png_chunks(data: bytes, path: str):
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (only PNG and .hdr images are read)")
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(tag + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters.  None / Sub / Up are vectorized;
    Average and Paeth depend on the byte to their left and run per byte in
    Python (slow, but only for files this repository did not write)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to uint8 [H, W, C] (C = 1 grey, 2 grey+alpha, 3 RGB,
    4 RGBA; palette images come back as RGB).  16-bit samples keep their
    high byte, as stb_image does.  Interlaced files and bit depths below 8
    raise ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for tag, body in _png_chunks(data, path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace or ctype not in _PNG_CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace})"
        )
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: PNG data size does not match its header")
    px = _unfilter(raw.reshape(h, w * bpp + 1), bpp)
    if depth == 16:
        px = px.reshape(h, w * ch, 2)[..., 0]  # big-endian high byte
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        px = palette[px[..., 0]]
    return np.ascontiguousarray(px)


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Encode uint8 [H, W, 3] (or [H, W] grey) as an 8-bit PNG.  Each
    scanline gets whichever of the None / Sub / Up filters leaves the
    smallest residual, so read_png decodes it on its vectorized path."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in (1, 3):
        raise ValueError(f"write_png takes grey or RGB images, got {ch} channels")
    rows = img.reshape(h, w * ch)
    left = np.zeros_like(rows)
    left[:, ch:] = rows[:, :-ch]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    cands = np.stack([rows, rows - left, rows - up])  # uint8 wraps = mod 256
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)
    best = np.argmin(cost, axis=0)
    filtered = cands[best, np.arange(h)]
    raw = np.concatenate([best.astype(np.uint8)[:, None], filtered], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ctype = 2 if ch == 3 else 0
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)))
        f.write(chunk(b"IEND", b""))


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance .hdr (RGBE) reader, RLE and flat scanlines."""
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported HDR orientation {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            head = f.read(4)
            if len(head) < 4:
                raise ValueError("truncated HDR")
            if head[0] == 2 and head[1] == 2 and (head[2] << 8 | head[3]) == w:
                # new-style RLE: each channel run-length encoded
                for c in range(4):
                    x = 0
                    while x < w:
                        n = f.read(1)[0]
                        if n > 128:
                            data[y, x : x + n - 128, c] = f.read(1)[0]
                            x += n - 128
                        else:
                            buf = np.frombuffer(f.read(n), np.uint8)
                            data[y, x : x + n, c] = buf
                            x += n
            else:
                row = head + f.read(4 * w - 4)
                data[y] = np.frombuffer(row, np.uint8).reshape(w, 4)
        rgbe = data.astype(np.float32)
        exp = np.ldexp(1.0, data[..., 3].astype(np.int32) - 136)  # 128+8
        rgb = rgbe[..., :3] * exp[..., None]
        rgb[data[..., 3] == 0] = 0.0
        return rgb
