"""PrimitiveScene — the legacy hardcoded analytic scene
(infra/scene/primitive_scene.cpp / template/scene.h): swinging quad light,
bouncing mirror sphere, giant rounded-corner sphere, spinning dielectric
cube, 6 walls (red/blue/checkerboard albedo overrides), dielectric torus.

Object ids follow the reference exactly:
  0 quad light, 1 sphere, 2 sphere2, 3 cube, 4..9 planes (L,R,floor,
  ceiling, front, back), 10 torus.  Material slot == object id; slot 11 is
  the error material.

Compiled per `anim_time` (SetTime semantics, primitive_scene.cpp:43-68) into
a PrimScene pytree; scene queries dispatch on it via scene/query.py.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.utils import struct

from cpu_ray_tracer_tpu.core import vecmath as vm
from cpu_ray_tracer_tpu.core.materials import MaterialTable, make_table
from cpu_ray_tracer_tpu.core.textures import TextureAtlas, build_atlas
from cpu_ray_tracer_tpu.io.image import load_texture_image
from cpu_ray_tracer_tpu.io.scene_xml import UPSTREAM_ASSETS


@struct.dataclass
class PrimScene:
    materials: MaterialTable
    atlas: TextureAtlas  # red/blue/logo wall textures
    light_t: jnp.ndarray
    light_inv_t: jnp.ndarray
    light_size: jnp.ndarray
    light_color: jnp.ndarray
    # sphere 1 (bouncing) + sphere 2 (rounded corners)
    sphere_pos: jnp.ndarray  # [2, 3]
    sphere_r2: jnp.ndarray  # [2]
    sphere_inv_r: jnp.ndarray  # [2]
    # cube
    cube_m: jnp.ndarray  # [4, 4]
    cube_inv_m: jnp.ndarray
    cube_bmin: jnp.ndarray  # [3]
    cube_bmax: jnp.ndarray
    # planes: N [6, 3], d [6]
    plane_n: jnp.ndarray
    plane_d: jnp.ndarray
    # torus
    torus_t: jnp.ndarray
    torus_inv_t: jnp.ndarray
    torus_rc2: jnp.ndarray
    torus_rt2: jnp.ndarray
    torus_r2: jnp.ndarray
    # static
    red_tex: int = struct.field(pytree_node=False, default=0)
    blue_tex: int = struct.field(pytree_node=False, default=1)
    logo_tex: int = struct.field(pytree_node=False, default=2)
    bilinear: bool = struct.field(pytree_node=False, default=False)


def compile_primitive_scene(anim_time: float = 0.0) -> PrimScene:
    pi = np.float32(np.pi)
    # light: swinging quad (SetTime)
    m1base = vm.mat_translate((0.0, 2.6, 2.0))
    m1 = (
        m1base
        @ vm.mat_rotate_z(np.sin(np.float32(anim_time) * 0.6) * 0.1)
        @ vm.mat_translate((0.0, -0.9, 0.0))
    )
    # cube: spin
    m2base = vm.mat_rotate_x(pi / 4) @ vm.mat_rotate_z(pi / 4)
    m2 = (
        vm.mat_translate((1.8, 0.0, 2.5))
        @ vm.mat_rotate_y(np.float32(anim_time) * 0.5)
        @ m2base
    )
    # sphere: bounce
    tm = 1.0 - (np.fmod(np.float32(anim_time), 2.0) - 1.0) ** 2
    sphere_pos = np.array([[-1.8, -0.4 + tm, 1.0], [0.0, 2.5, -3.07]], np.float32)
    sphere_r = np.array([0.6, 8.0], np.float32)

    torus_t = vm.mat_translate((-0.25, 0.0, 2.0)) @ vm.mat_rotate_x(pi / 4)
    rc, rt = np.float32(0.8), np.float32(0.25)

    # wall textures (the reference's Plane::GetAlbedo Surface loads)
    def tex(name):
        path = os.path.join(UPSTREAM_ASSETS, name)
        if UPSTREAM_ASSETS and os.path.isfile(path):
            return load_texture_image(path)
        return np.full((4, 4, 3), 0.93, np.float32)

    atlas = build_atlas([tex("red.png"), tex("blue.png"), tex("logo.png")])

    rows = [
        {"is_light": True},  # 0 light
        {"reflectivity": 1.0},  # 1 bouncing ball (mirror)
        {},  # 2 rounded corners
        {"refractivity": 1.0, "absorption": (0.5, 0.0, 0.5)},  # 3 cube
        {},  # 4 left wall (albedo override: red)
        {},  # 5 right wall (albedo override: blue)
        {"reflectivity": 0.3},  # 6 floor (albedo override: checkerboard)
        {},  # 7 ceiling
        {},  # 8 front wall
        {},  # 9 back wall
        {"refractivity": 1.0},  # 10 torus
        {"albedo": (1.0, 192 / 255.0, 203 / 255.0)},  # 11 error pink
    ]
    materials = make_table(rows)

    plane_n = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    plane_d = np.array([3.0, 2.99, 1.0, 2.0, 3.0, 3.99], np.float32)

    return PrimScene(
        materials=materials,
        atlas=atlas,
        light_t=jnp.asarray(m1),
        light_inv_t=jnp.asarray(vm.mat_inverted_no_scale(m1)),
        light_size=jnp.float32(0.5),
        light_color=jnp.asarray(np.array([24.0, 24.0, 22.0], np.float32)),
        sphere_pos=jnp.asarray(sphere_pos),
        sphere_r2=jnp.asarray(sphere_r * sphere_r),
        sphere_inv_r=jnp.asarray(1.0 / sphere_r),
        cube_m=jnp.asarray(m2),
        cube_inv_m=jnp.asarray(vm.mat_inverted_no_scale(m2)),
        cube_bmin=jnp.asarray(np.array([-0.575, -0.575, -0.575], np.float32)),
        cube_bmax=jnp.asarray(np.array([0.575, 0.575, 0.575], np.float32)),
        plane_n=jnp.asarray(plane_n),
        plane_d=jnp.asarray(plane_d),
        torus_t=jnp.asarray(torus_t),
        torus_inv_t=jnp.asarray(vm.mat_inverted(torus_t)),
        torus_rc2=jnp.float32(rc * rc),
        torus_rt2=jnp.float32(rt * rt),
        torus_r2=jnp.float32((rc + rt) ** 2),
    )


# ---------------------------------------------------------------------------
# Queries (BaseScene interface for the primitive scene)
# ---------------------------------------------------------------------------


def find_nearest(scene: PrimScene, o, d, t0=None, mask=None):
    from cpu_ray_tracer_tpu import constants
    from cpu_ray_tracer_tpu.ops import intersect, primitives as prim

    r = o.shape[0]
    t = jnp.full((r,), constants.RAY_FAR, jnp.float32) if t0 is None else jnp.broadcast_to(t0, (r,))
    obj = jnp.full((r,), -1, jnp.int32)

    lt, lhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, t)
    t = jnp.where(lhit, lt, t)
    obj = jnp.where(lhit, 0, obj)

    for i in range(2):
        st, shit = prim.sphere(o, d, scene.sphere_pos[i], scene.sphere_r2[i], t)
        t = jnp.where(shit, st, t)
        obj = jnp.where(shit, 1 + i, obj)

    ct, chit = prim.cube(o, d, scene.cube_inv_m, scene.cube_bmin, scene.cube_bmax, t)
    t = jnp.where(chit, ct, t)
    obj = jnp.where(chit, 3, obj)

    for i in range(6):
        pt, phit = intersect.plane(o, d, scene.plane_n[i], scene.plane_d[i], t)
        t = jnp.where(phit, pt, t)
        obj = jnp.where(phit, 4 + i, obj)

    tt, thit = prim.torus(
        o, d, scene.torus_inv_t, scene.torus_rc2, scene.torus_rt2, scene.torus_r2, t
    )
    t = jnp.where(thit, tt, t)
    obj = jnp.where(thit, 10, obj)

    return dict(
        t=t,
        obj_idx=obj,
        tri_idx=jnp.full((r,), -1, jnp.int32),
        bary=jnp.zeros((r, 2), jnp.float32),
        mat_id_tri=jnp.full((r,), -1, jnp.int32),
        traversed=jnp.zeros((r,), jnp.int32),
        tested=jnp.full((r,), 11, jnp.int32),
    )


def is_occluded(scene: PrimScene, o, d, dist, mask=None):
    """Reference semantics (primitive_scene.cpp IsOccluded): cube, sphere 1,
    quad, torus; planes and sphere2 skipped."""
    from cpu_ray_tracer_tpu.ops import intersect, primitives as prim

    _, chit = prim.cube(o, d, scene.cube_inv_m, scene.cube_bmin, scene.cube_bmax, dist)
    _, shit = prim.sphere(o, d, scene.sphere_pos[0], scene.sphere_r2[0], dist)
    _, qhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, dist)
    _, thit = prim.torus(
        o, d, scene.torus_inv_t, scene.torus_rc2, scene.torus_rt2, scene.torus_r2, dist
    )
    return chit | shit | qhit | thit


def get_hit_info(scene: PrimScene, hit: dict, point, d):
    from cpu_ray_tracer_tpu.core import vecmath as vmod
    from cpu_ray_tracer_tpu.ops import primitives as prim

    obj = hit["obj_idx"]
    n = jnp.zeros(point.shape, jnp.float32)
    light_n = -scene.light_t[:3, 1]
    n = jnp.where((obj == 0)[..., None], light_n, n)
    for i in range(2):
        sn = prim.sphere_normal(point, scene.sphere_pos[i], scene.sphere_inv_r[i])
        n = jnp.where((obj == 1 + i)[..., None], sn, n)
    cn = prim.cube_normal(point, scene.cube_m, scene.cube_inv_m, scene.cube_bmin, scene.cube_bmax)
    n = jnp.where((obj == 3)[..., None], cn, n)
    for i in range(6):
        n = jnp.where((obj == 4 + i)[..., None], scene.plane_n[i], n)
    tn = prim.torus_normal(point, scene.torus_t, scene.torus_inv_t, scene.torus_rc2, scene.torus_rt2)
    n = jnp.where((obj == 10)[..., None], tn, n)

    flip = vmod.dot(n, d) > 0
    n = jnp.where(flip[..., None], -n, n)
    mat_id = jnp.where(obj >= 0, obj, scene.materials.count - 1)
    uv = jnp.zeros(point.shape[:-1] + (2,), jnp.float32)
    return n, uv, mat_id


def get_albedo_override(scene: PrimScene, obj, point):
    """Plane albedo overrides (template/primitives.h:134-179): floor
    checkerboard, left wall red.png, right wall blue.png; others 0.93."""
    from cpu_ray_tracer_tpu.core import textures as tex_mod

    p = point
    # floor checkerboard (ix+iz parity), incl. the deliberate aliasing tiles
    ix = (p[..., 0] * 2 + 96.01).astype(jnp.int32)
    iz = (p[..., 2] * 2 + 96.01).astype(jnp.int32)
    alias1 = (ix == 98) & (iz == 98)
    alias2 = (ix == 94) & (iz == 98)
    ix = jnp.where(alias1, (p[..., 0] * 32.01).astype(jnp.int32), ix)
    iz = jnp.where(alias1, (p[..., 2] * 32.01).astype(jnp.int32), iz)
    ix = jnp.where(alias2, (p[..., 0] * 64.01).astype(jnp.int32), ix)
    iz = jnp.where(alias2, (p[..., 2] * 64.01).astype(jnp.int32), iz)
    checker = jnp.where(((ix + iz) & 1) == 1, 1.0, 0.3)[..., None].repeat(3, -1)

    def wall(tex_id, w, h):
        ix = ((p[..., 2] - 4.0) * (w / 7.0)).astype(jnp.int32) & (w - 1)
        iy = ((2.0 - p[..., 1]) * (h / 3.0)).astype(jnp.int32) & (h - 1)
        off = scene.atlas.offset[tex_id]
        return scene.atlas.texels[off + ix + iy * w]

    red = wall(scene.red_tex, 512, 512)
    blue = wall(scene.blue_tex, 512, 512)

    out = jnp.full(point.shape, 0.93, jnp.float32)
    out = jnp.where((obj == 6)[..., None], checker, out)
    out = jnp.where((obj == 4)[..., None], red, out)
    out = jnp.where((obj == 5)[..., None], blue, out)
    return out
