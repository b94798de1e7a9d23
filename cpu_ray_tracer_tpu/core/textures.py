"""Texture storage and sampling.

All of a scene's textures (material diffuse maps, the floor texture, the
skydome) are packed into ONE flat float32 texel buffer `[K, 3]` with a small
per-texture table of (offset, width, height).  Sampling is a gather — the
batched replacement for the reference's per-texture pointer fetch
(template/texture.h:61-96).

Two tap modes:
* nearest — bit-parity with the reference's `Sample` (clamp u, flip+clamp v,
  truncate to texel).
* bilinear — 4-tap filtered, differentiable w.r.t. texel values AND uv;
  default in the differentiable pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.utils import struct

from cpu_ray_tracer_tpu.core import vecmath as vm


# Texel gathers in the differentiable pipeline go through
# vecmath.gather_rows3: a rank-1 flat backward (the autodiff transpose of
# a row gather is a multi-lane scatter-add at random indices), with a FLAT
# [K*3] cotangent so differentiated scan bodies stack unpadded instances
# instead of padded [K, 3] ones.


@struct.dataclass
class TextureAtlas:
    texels: jnp.ndarray  # [K, 3] float32, all textures concatenated row-major
    offset: jnp.ndarray  # [T] int32 start index into texels
    width: jnp.ndarray  # [T] int32
    height: jnp.ndarray  # [T] int32
    # [K] uint32 0x00RRGGBB — the reference's own pixel format
    # (texture.h:35).  Nearest-neighbor taps gather ONE scalar per ray and
    # bit-unpack it: 3x less gather traffic than the [K, 3] rows.
    packed: jnp.ndarray = None

    @property
    def count(self) -> int:
        return self.offset.shape[0]


def build_atlas(images: list[np.ndarray]) -> TextureAtlas:
    """Pack a list of HxWx3 float32 images into an atlas.  An empty list
    produces a 1-texel dummy so shapes stay static."""
    if not images:
        images = [np.zeros((1, 1, 3), np.float32)]
    offsets, widths, heights, bufs = [], [], [], []
    off = 0
    for img in images:
        h, w = img.shape[:2]
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        bufs.append(np.asarray(img, np.float32).reshape(h * w, 3))
        off += h * w
    texels = np.concatenate(bufs, axis=0)
    u8 = np.clip(np.round(texels * 255.0), 0, 255).astype(np.uint32)
    packed = (u8[:, 0] << 16) | (u8[:, 1] << 8) | u8[:, 2]
    return TextureAtlas(
        texels=jnp.asarray(texels),
        offset=jnp.asarray(offsets, jnp.int32),
        width=jnp.asarray(widths, jnp.int32),
        height=jnp.asarray(heights, jnp.int32),
        packed=jnp.asarray(packed),
    )


def nearest_texel(atlas: TextureAtlas, off, w, h, u, v) -> jnp.ndarray:
    """Nearest-texel fetch given per-ray (or scalar) offset/width/height —
    the one remaining gather once the texture-table lookups are fused
    upstream (query.material_fields one-hot matmul, or trace-time scalars
    for the skydome).  Reference truncation semantics (texture.h:61-96)."""
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    x = jnp.clip((uu * w.astype(jnp.float32)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((vv * h.astype(jnp.float32)).astype(jnp.int32), 0, h - 1)
    idx = off + x + y * w
    if atlas.packed is not None:
        p = atlas.packed[idx]
        scale = np.float32(1.0 / 255.0)
        return jnp.stack(
            [
                ((p >> 16) & 0xFF).astype(jnp.float32) * scale,
                ((p >> 8) & 0xFF).astype(jnp.float32) * scale,
                (p & 0xFF).astype(jnp.float32) * scale,
            ],
            axis=-1,
        )
    return atlas.texels[idx]


def sample_nearest(atlas: TextureAtlas, tex_id: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Nearest-texel sample, reference semantics (texture.h:61-96):
    u clamped to [0,1], v flipped then clamped, truncation to int,
    clamp to edge.  tex_id < 0 returns black (the reference returns
    float3(0) for an unloaded texture).

    Shapes: tex_id/u/v [N] -> [N, 3].
    """
    tid = jnp.maximum(tex_id, 0)
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]
    texel = nearest_texel(atlas, off, w, h, u, v)
    return jnp.where((tex_id >= 0)[..., None], texel, 0.0)


def sample_bilinear(atlas: TextureAtlas, tex_id: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """4-tap bilinear sample with clamp-to-edge; differentiable w.r.t.
    texels (linear gather weights) and uv.  Texel centers at (i+0.5)/w,
    matching the nearest mode's truncation grid in expectation."""
    tid = jnp.maximum(tex_id, 0)
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    fx = uu * wf - 0.5
    fy = vv * hf - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    t00 = vm.gather_rows3(atlas.texels, off + x0i + y0i * w)
    t10 = vm.gather_rows3(atlas.texels, off + x1i + y0i * w)
    t01 = vm.gather_rows3(atlas.texels, off + x0i + y1i * w)
    t11 = vm.gather_rows3(atlas.texels, off + x1i + y1i * w)
    tx = tx[..., None]
    ty = ty[..., None]
    top = t00 * (1 - tx) + t10 * tx
    bot = t01 * (1 - tx) + t11 * tx
    texel = top * (1 - ty) + bot * ty
    return jnp.where((tex_id >= 0)[..., None], texel, 0.0)


def sample(atlas: TextureAtlas, tex_id, u, v, bilinear: bool = False) -> jnp.ndarray:
    if bilinear:
        return sample_bilinear(atlas, tex_id, u, v)
    return sample_nearest(atlas, tex_id, u, v)


def sample_equirect(atlas: TextureAtlas, tex_id: int, d: jnp.ndarray, bilinear: bool = False) -> jnp.ndarray:
    """Equirectangular skydome lookup from unit directions `[N, 3]`.

    Parity: tlas_file_scene.cpp:176-188 — phi = atan2(-z, x) + PI,
    theta = acos(-y), u = phi/2pi, v = theta/pi.
    """
    phi = jnp.arctan2(-d[..., 2], d[..., 0]) + np.float32(np.pi)
    theta = jnp.arccos(jnp.clip(-d[..., 1], -1.0, 1.0))
    u = phi * np.float32(0.5 / np.pi)
    v = theta * np.float32(1.0 / np.pi)
    if not bilinear:
        # tex_id is static: scalar offset/width/height (no per-ray table
        # gathers) — the skydome tap is one packed-texel gather per ray
        return nearest_texel(
            atlas, atlas.offset[tex_id], atlas.width[tex_id],
            atlas.height[tex_id], u, v,
        )
    tid = jnp.full(u.shape, tex_id, jnp.int32)
    return sample(atlas, tid, u, v, bilinear)
