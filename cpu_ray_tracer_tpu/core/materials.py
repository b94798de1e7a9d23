"""SoA material table.

The reference's heap-allocated `Material` objects (template/material.h:6-46)
become one table of flat arrays indexed by mat_id.  Table layout convention
(shared by every scene type):

    slot 0            — the quad light's primitive material (isLight)
    slot 1            — the textured floor plane's primitive material
    slots 2..2+M-1    — the scene XML's M materials, in file order
    last slot         — error material (pink), used for bad lookups
                        (file_scene.cpp:6)

Every float field is differentiable; `albedo/reflectivity/refractivity/
absorption` are exactly the parameters the differentiable pass optimizes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.utils import struct

from cpu_ray_tracer_tpu.core import textures as tex_mod
from cpu_ray_tracer_tpu.core.textures import TextureAtlas


@struct.dataclass
class MaterialTable:
    albedo: jnp.ndarray  # [M, 3] constant albedo (material.h default 1.0)
    reflectivity: jnp.ndarray  # [M]
    refractivity: jnp.ndarray  # [M]
    absorption: jnp.ndarray  # [M, 3]
    tex_id: jnp.ndarray  # [M] int32 into the scene TextureAtlas, -1 = none
    is_light: jnp.ndarray  # [M] bool

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


def make_table(rows: list[dict]) -> MaterialTable:
    m = len(rows)
    albedo = np.ones((m, 3), np.float32)
    refl = np.zeros((m,), np.float32)
    refr = np.zeros((m,), np.float32)
    absorb = np.zeros((m, 3), np.float32)
    tex_id = np.full((m,), -1, np.int32)
    is_light = np.zeros((m,), np.bool_)
    for i, r in enumerate(rows):
        albedo[i] = r.get("albedo", (1.0, 1.0, 1.0))
        refl[i] = r.get("reflectivity", 0.0)
        refr[i] = r.get("refractivity", 0.0)
        absorb[i] = r.get("absorption", (0.0, 0.0, 0.0))
        tex_id[i] = r.get("tex_id", -1)
        is_light[i] = r.get("is_light", False)
    return MaterialTable(
        albedo=jnp.asarray(albedo),
        reflectivity=jnp.asarray(refl),
        refractivity=jnp.asarray(refr),
        absorption=jnp.asarray(absorb),
        tex_id=jnp.asarray(tex_id),
        is_light=jnp.asarray(is_light),
    )


def get_albedo(
    table: MaterialTable,
    atlas: TextureAtlas,
    mat_id: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    bilinear: bool = False,
) -> jnp.ndarray:
    """Material::GetAlbedo (material.h:28-35): texture sample when the
    material has a diffuse texture, constant albedo otherwise."""
    tid = table.tex_id[mat_id]
    tex_rgb = tex_mod.sample(atlas, tid, u, v, bilinear)
    return jnp.where((tid >= 0)[..., None], tex_rgb, table.albedo[mat_id])
