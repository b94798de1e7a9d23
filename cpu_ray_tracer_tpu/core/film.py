"""Film: float32 radiance accumulation + display conversion.

Replaces the reference's `Surface` ARGB framebuffer + `float4* accumulator`
(template/surface.h, 3. PathTracer/renderer.cpp:8-17) with a float32 [H, W, 3]
accumulator pytree carrying the sample count, so progressive rendering and
checkpoint/resume are trivial.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.io import image
from cpu_ray_tracer_tpu.utils import struct


@struct.dataclass
class Film:
    accum: jnp.ndarray  # [H, W, 3] float32 radiance sum
    spp: jnp.ndarray  # [] int32 samples accumulated so far

    @property
    def shape(self):
        return self.accum.shape

    def mean(self) -> jnp.ndarray:
        return self.accum / jnp.maximum(self.spp, 1).astype(jnp.float32)


def make_film(height: int, width: int) -> Film:
    return Film(accum=jnp.zeros((height, width, 3), jnp.float32), spp=jnp.zeros((), jnp.int32))


def add_samples(film: Film, radiance: jnp.ndarray, n_samples: int) -> Film:
    return Film(accum=film.accum + radiance, spp=film.spp + n_samples)


def to_rgb8(img: jnp.ndarray) -> jnp.ndarray:
    """RGBF32_to_RGB8 parity (template/precomp.h:325-341): clamp each channel
    to [0, 1] then truncate to 0..255 via *255 + 0.5 rounding-free cast.

    The reference computes `min(value, 1) * 255` then casts; negative inputs
    can't occur there (radiance is non-negative), we clamp both ends.
    """
    x = jnp.clip(img, 0.0, 1.0) * 255.0
    return x.astype(jnp.uint8)


def energy(img: jnp.ndarray) -> jnp.ndarray:
    """Path-tracer 'energy' metric: sum of all pixel RGB values of the
    averaged film (3. PathTracer/renderer.cpp:155-157)."""
    return jnp.sum(img)


def write_png(path: str, img_u8: np.ndarray) -> None:
    image.write_png(path, np.asarray(img_u8))
