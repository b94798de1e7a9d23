"""Pure scene query functions over ray batches — the SoA replacements for
the reference's BaseScene virtuals (infra/scene/base_scene.h:16-32):
FindNearest, IsOccluded, GetHitInfo, GetSkyColor, GetLightPos, GetAlbedo.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.core import materials as mat_mod
from cpu_ray_tracer_tpu.core import textures as tex_mod
from cpu_ray_tracer_tpu.core import vecmath as vm
from cpu_ray_tracer_tpu.ops import bvh_kernel, forest, intersect, traverse_bvh, traverse_grid, traverse_kd
from cpu_ray_tracer_tpu.scene.types import DeviceScene
from cpu_ray_tracer_tpu.scene import primitive_scene as prim_scene

FLOOR_NORMAL = np.array([0.0, 1.0, 0.0], np.float32)
FLOOR_D = np.float32(1.0)


def walk_bvh(scene, bvh, tris, o, d, t0, any_hit: bool = False, mask=None):
    """Walk one threaded BVH: the single place that chooses the traversal
    implementation.  Where the program is lowered for a GPU it runs the
    CUDA kernel (ops/bvh_kernel.py), everywhere else the XLA walk
    (ops/traverse_bvh.py), which is also the reference the kernel is tested
    against; `scene.traversal == "xla"` pins the XLA walk on every platform.
    Rays outside `mask` get t0 = -1, so they report no hit.

    Both walks run detached: visibility is discrete, and gradients reach t
    and the barycentrics through find_nearest_diff's recomputation."""
    o, d, t0, bvh, tris = jax.lax.stop_gradient((o, d, t0, bvh, tris))
    if mask is not None:
        t0 = jnp.where(mask, t0, np.float32(-1.0))

    def xla(o, d, t0):
        return traverse_bvh.traverse(bvh, tris, o, d, t0, any_hit=any_hit)

    if getattr(scene, "traversal", "auto") == "xla":
        return xla(o, d, t0)

    def kernel(o, d, t0):
        return bvh_kernel.traverse(bvh, tris, o, d, t0, any_hit=any_hit)

    return jax.lax.platform_dependent(o, d, t0, cuda=kernel, default=xla)


def _traverse_instanced(scene: DeviceScene, o, d, t, any_hit: bool = False, mask=None):
    """Object-space shared-BLAS traversal (instancing="shared"): one masked
    pass per instance over its unique mesh's BLAS, rays transformed by the
    instance's inverse TRS, best hit chained through the passes — the
    reference's BLASBVH::Intersect semantics (blas_bvh.cpp:376-389)
    vectorized over the whole batch.  Direction vectors are NOT
    renormalized, so t is identical in object and world space."""
    sh = scene.shared
    r = o.shape[0]
    if mask is None:
        mask = jnp.ones((r,), jnp.bool_)
    hp = jax.lax.Precision.HIGHEST

    best_t = t
    tri = jnp.full((r,), -1, jnp.int32)
    obj = jnp.full((r,), -1, jnp.int32)
    mat = jnp.full((r,), -1, jnp.int32)
    bary = jnp.zeros((r, 2), jnp.float32)
    trav = jnp.zeros((r,), jnp.int32)
    test = jnp.zeros((r,), jnp.int32)
    occ = jnp.zeros((r,), jnp.bool_)
    rd = 1.0 / jnp.where(jnp.abs(d) < np.float32(1e-30), np.float32(1e-30), d)
    for i, ms in enumerate(sh.inst_mesh):
        mi = sh.inst_minv[i]
        o_i = jnp.matmul(o, mi[:3, :3].T, precision=hp) + mi[:3, 3]
        d_i = jnp.matmul(d, mi[:3, :3].T, precision=hp)
        # world-AABB early-out vs the running best t (the TLAS role)
        t1 = (sh.inst_aabb_min[i] - o) * rd
        t2 = (sh.inst_aabb_max[i] - o) * rd
        tn = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
        live = mask & (tf >= tn) & (tf > 0) & (tn < best_t)
        if any_hit:
            live = live & ~occ
        res = walk_bvh(scene, sh.bvhs[ms], scene.tris, o_i, d_i, best_t, any_hit=any_hit, mask=live)
        hit_i = res["tri_idx"] >= 0
        best_t = jnp.where(hit_i, res["t"], best_t)
        tri = jnp.where(hit_i, res["tri_idx"], tri)
        obj = jnp.where(hit_i, sh.inst_obj[i], obj)
        mat = jnp.where(hit_i, sh.inst_mat[i], mat)
        bary = jnp.where(hit_i[..., None], res["bary"], bary)
        trav = trav + res["traversed"]
        test = test + res["tested"]
        if any_hit:
            occ = occ | hit_i
    return dict(
        t=best_t, tri_idx=tri, obj_id=obj, mat_id=mat, bary=bary,
        traversed=trav, tested=test,
    )


def _traverse_accel(scene: DeviceScene, o, d, t, any_hit: bool = False, mask=None):
    """Dispatch on the scene's accelerator kind — the data-driven analog of
    the reference's USE_BVH/USE_Grid/USE_KDTree defines (file_scene.h:10-12);
    every accelerator answers the same query contract."""
    if scene.shared is not None:
        return _traverse_instanced(scene, o, d, t, any_hit=any_hit, mask=mask)
    if scene.accel_kind == "grid":
        if isinstance(scene.grid, (tuple, list)):  # tlas layout: BLAS forest
            return forest.traverse_forest(
                traverse_grid.traverse, scene.grid, scene.tris, o, d, t, any_hit=any_hit
            )
        return traverse_grid.traverse(scene.grid, scene.tris, o, d, t, any_hit=any_hit)
    if scene.accel_kind == "kdtree":
        if isinstance(scene.kd, (tuple, list)):
            return forest.traverse_forest(
                traverse_kd.traverse, scene.kd, scene.tris, o, d, t, any_hit=any_hit
            )
        return traverse_kd.traverse(scene.kd, scene.tris, o, d, t, any_hit=any_hit)
    return walk_bvh(scene, scene.bvh, scene.tris, o, d, t, any_hit=any_hit, mask=mask)


def find_nearest(scene: DeviceScene, o: jnp.ndarray, d: jnp.ndarray, t0=None, mask=None):
    """Nearest hit over light quad -> floor plane -> triangle accel, the same
    composition as FileScene::FindNearest (file_scene.cpp:170-175).

    `mask` (optional [R] bool) marks live rays; on the BVH, dead lanes walk
    with t0 = -1 and report no triangle hit.

    Returns dict(t, obj_idx, tri_idx, bary, traversed, tested).
    """
    if isinstance(scene, prim_scene.PrimScene):
        return prim_scene.find_nearest(scene, o, d, t0=t0, mask=mask)
    r = o.shape[0]
    if t0 is None:
        t = jnp.full((r,), constants.RAY_FAR, jnp.float32)
    else:
        t = jnp.broadcast_to(jnp.asarray(t0, jnp.float32), (r,))
    obj = jnp.full((r,), -1, jnp.int32)

    if scene.has_light:
        lt, lhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, t)
        t = jnp.where(lhit, lt, t)
        obj = jnp.where(lhit, 0, obj)
    if scene.has_floor:
        ft, fhit = intersect.plane(o, d, FLOOR_NORMAL, FLOOR_D, t)
        t = jnp.where(fhit, ft, t)
        obj = jnp.where(fhit, 1, obj)

    res = _traverse_accel(scene, o, d, t, mask=mask)
    tri_hit = res["tri_idx"] >= 0
    out = dict(
        t=res["t"],
        obj_idx=jnp.where(tri_hit, res["obj_id"], obj),
        tri_idx=res["tri_idx"],
        bary=res["bary"],
        mat_id_tri=res["mat_id"],
        traversed=res["traversed"],
        tested=res["tested"],
    )
    return out


def find_nearest_diff(scene: DeviceScene, o: jnp.ndarray, d: jnp.ndarray, t0=None, mask=None):
    """Differentiable nearest-hit: traversal runs detached (discrete hit
    SELECTION carries no gradient — `lax.while_loop` is not reverse-mode
    differentiable and visibility is discontinuous anyway), then t and the
    barycentrics are RECOMPUTED differentiably from the selected primitive,
    so gradients flow to ray origins/directions, triangle vertices and the
    light transform.  This is the classic detached-sampling formulation of
    differentiable rendering (non-silhouette gradients)."""
    hit = find_nearest(
        scene, jax.lax.stop_gradient(o), jax.lax.stop_gradient(d), t0, mask=mask,
    )
    hit = {k: jax.lax.stop_gradient(v) for k, v in hit.items()}
    tri = hit["tri_idx"]
    obj = hit["obj_idx"]
    tid = jnp.maximum(tri, 0)

    # triangle: differentiable Möller–Trumbore solve against the hit tri.
    # Shared-BLAS mode: the pool is object space, so transform the ray by
    # the winning instance's (constant) inverse matrix first — t is the
    # same scalar in both spaces because d is not renormalized.
    if scene.shared is not None:
        sh = scene.shared
        n_i = sh.inst_minv.shape[0]
        iidx = jnp.clip(obj - 2, 0, n_i - 1)
        oh = jax.nn.one_hot(iidx, n_i, dtype=jnp.float32)
        mi = jnp.dot(
            oh, sh.inst_minv.reshape(n_i, 16), precision=jax.lax.Precision.HIGHEST
        ).reshape(-1, 4, 4)
        hp = jax.lax.Precision.HIGHEST
        o_mt = jnp.einsum("rij,rj->ri", mi[:, :3, :3], o, precision=hp) + mi[:, :3, 3]
        d_mt = jnp.einsum("rij,rj->ri", mi[:, :3, :3], d, precision=hp)
    else:
        o_mt, d_mt = o, d
    # plain row gathers with the default scatter transpose (vm.gather_rows3
    # is for gathers whose cotangents stack inside scans, e.g. the texel
    # atlas; these do not, since the bilinear tap records are deferred as
    # 1-D arrays — render/pathtracer._TAP_KEYS).
    v0 = scene.tris.v0[tid]
    e1 = scene.tris.e1[tid]
    e2 = scene.tris.e2[tid]
    h = jnp.cross(d_mt, e2)
    a = vm.dot(e1, h)
    f = 1.0 / jnp.where(jnp.abs(a) < np.float32(1e-20), np.float32(1e-20), a)
    s = o_mt - v0
    u = f * vm.dot(s, h)
    q = jnp.cross(s, e1)
    v = f * vm.dot(d_mt, q)
    t_tri = f * vm.dot(e2, q)

    # floor plane: t = -(o.y + 1) / d.y
    dy = jnp.where(jnp.abs(d[..., 1]) < np.float32(1e-20), np.float32(1e-20), d[..., 1])
    t_floor = -(o[..., 1] + FLOOR_D) / dy

    # light quad: local-y plane through the light transform
    it = scene.light_inv_t
    oy = o[..., 0] * it[1, 0] + o[..., 1] * it[1, 1] + o[..., 2] * it[1, 2] + it[1, 3]
    dyq = d[..., 0] * it[1, 0] + d[..., 1] * it[1, 1] + d[..., 2] * it[1, 2]
    dyq = jnp.where(jnp.abs(dyq) < np.float32(1e-20), np.float32(1e-20), dyq)
    t_quad = oy / -dyq

    is_tri = tri >= 0
    t = jnp.where(
        is_tri,
        t_tri,
        jnp.where(obj == 1, t_floor, jnp.where(obj == 0, t_quad, hit["t"])),
    )
    bary = jnp.where(
        is_tri[..., None], jnp.stack([u, v], axis=-1), hit["bary"]
    )
    out = dict(hit)
    out["t"] = t
    out["bary"] = bary
    return out


def is_occluded(scene: DeviceScene, o: jnp.ndarray, d: jnp.ndarray, dist: jnp.ndarray, mask=None):
    """Shadow query with the reference's exact semantics
    (file_scene.cpp:177-187): the light quad is tested against
    t = dist (the caller passes dist - 2*EPSILON), then the triangle accel is
    tested with t RESET TO 1e34 (quirk: triangles occlude regardless of
    distance).  Planes are skipped.

    Inputs are detached: visibility is boolean (no useful tangent) and the
    traversal while_loop cannot be reverse-differentiated."""
    if isinstance(scene, prim_scene.PrimScene):
        return prim_scene.is_occluded(scene, o, d, dist)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    dist = jax.lax.stop_gradient(dist)
    r = o.shape[0]
    occ = jnp.zeros((r,), jnp.bool_)
    if scene.has_light:
        _, lhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, dist)
        occ = occ | lhit
    tri_t = (
        jnp.full((r,), constants.RAY_FAR, jnp.float32)
        if scene.shadow_quirk
        else dist
    )
    res = _traverse_accel(scene, o, d, tri_t, any_hit=True, mask=mask)
    return occ | (res["tri_idx"] >= 0)


def get_hit_info(scene: DeviceScene, hit: dict, point: jnp.ndarray, d: jnp.ndarray):
    """Normal / uv / material id per ray (tlas_file_scene.cpp:220-260),
    including the back-face flip `if dot(N, D) > 0: N = -N`."""
    if isinstance(scene, prim_scene.PrimScene):
        return prim_scene.get_hit_info(scene, hit, point, d)
    obj = hit["obj_idx"]
    tri_hit = hit["tri_idx"] >= 0

    n_tri, uv_tri = traverse_bvh.interpolate_hit(scene.tris, hit["tri_idx"], hit["bary"])
    if scene.shared is not None:
        # shared-BLAS mode: pool normals are OBJECT space; map to world with
        # the winning instance's inverse-transpose (one-hot matmul — the
        # instance table is tiny) and renormalize
        sh = scene.shared
        n_i = sh.inst_nrm.shape[0]
        iidx = jnp.clip(obj - 2, 0, n_i - 1)
        oh = jax.nn.one_hot(iidx, n_i, dtype=jnp.float32)
        nm = jnp.dot(
            oh, sh.inst_nrm.reshape(n_i, 9), precision=jax.lax.Precision.HIGHEST
        ).reshape(-1, 3, 3)
        n_w = jnp.einsum("rij,rj->ri", nm, n_tri, precision=jax.lax.Precision.HIGHEST)
        n_w = n_w / jnp.maximum(jnp.linalg.norm(n_w, axis=-1, keepdims=True), 1e-20)
        n_tri = jnp.where(tri_hit[..., None], n_w, n_tri)
    # light quad normal: TransformVector((0,-1,0), T) (primitives.h:365-369)
    light_n = -scene.light_t[:3, 1]
    floor_uv = intersect.plane_uv(point, scene.floor_inv_to)

    is_light = obj == 0
    is_floor = obj == 1
    normal = jnp.where(
        tri_hit[..., None],
        n_tri,
        jnp.where(
            is_light[..., None],
            jnp.broadcast_to(light_n, n_tri.shape),
            jnp.broadcast_to(FLOOR_NORMAL, n_tri.shape),
        ),
    )
    uv = jnp.where(tri_hit[..., None], uv_tri, jnp.where(is_floor[..., None], floor_uv, 0.0))
    mat_id = jnp.where(tri_hit, hit["mat_id_tri"], jnp.where(is_light, 0, 1))
    # error material (pink) for misses queried anyway
    mat_id = jnp.where(obj < 0, scene.materials.count - 1, mat_id)
    # back-face flip
    flip = vm.dot(normal, d) > 0
    normal = jnp.where(flip[..., None], -normal, normal)
    return normal, uv, mat_id


def material_fields(scene, mat_id: jnp.ndarray):
    """All per-ray material scalars in ONE one-hot matmul against the (tiny)
    material table — replaces five separate per-ray [mat_id] gathers."""
    m = scene.materials
    # texture-table columns ride the same matmul: per-material (offset,
    # width, height) joined from the atlas here (M-sized gathers, free)
    # kills the three per-RAY table gathers in the texture tap.  f32 holds
    # integers exactly below 2^24 — texel offsets beyond that fall back to
    # the gather path in get_albedo.
    tid_m = m.tex_id
    ts = jnp.maximum(tid_m, 0)
    atlas = scene.atlas
    tex_cols = [
        jnp.where(tid_m >= 0, atlas.offset[ts], 0).astype(jnp.float32)[:, None],
        jnp.where(tid_m >= 0, atlas.width[ts], 1).astype(jnp.float32)[:, None],
        jnp.where(tid_m >= 0, atlas.height[ts], 1).astype(jnp.float32)[:, None],
    ]
    table = jnp.concatenate(
        [
            m.albedo,  # 0:3
            m.reflectivity[:, None],  # 3
            m.refractivity[:, None],  # 4
            m.absorption,  # 5:8
            m.is_light[:, None].astype(jnp.float32),  # 8
            m.tex_id[:, None].astype(jnp.float32),  # 9
            *tex_cols,  # 10:13 tex offset / width / height
        ],
        axis=1,
    )
    oh = jax.nn.one_hot(mat_id, m.count, dtype=jnp.float32)
    # HIGHEST precision: a reduced-precision matmul (bf16 or TF32) would
    # round the f32 table, shifting reflectivity/refractivity lobe
    # thresholds vs the reference's exact values; the matmul is tiny.
    f = jnp.dot(
        oh, table, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return dict(
        albedo=f[..., 0:3],
        reflectivity=f[..., 3],
        refractivity=f[..., 4],
        absorption=f[..., 5:8],
        is_light=f[..., 8] > 0.5,
        tex_id=jnp.round(f[..., 9]).astype(jnp.int32),
        tex_off=jnp.round(f[..., 10]).astype(jnp.int32),
        tex_w=jnp.round(f[..., 11]).astype(jnp.int32),
        tex_h=jnp.round(f[..., 12]).astype(jnp.int32),
    )


def get_albedo(scene: DeviceScene, mat_id: jnp.ndarray, uv: jnp.ndarray, obj=None, point=None, fields=None):
    """Material::GetAlbedo plus the reference's isAlbedoOverridden path
    (renderer.cpp:32): PrimitiveScene walls override albedo procedurally.

    `fields` (an optional material_fields() result) enables the fused path:
    the texture-table values already rode the one-hot matmul, so the tap is
    a single packed-texel gather instead of five per-ray gathers."""
    if (
        fields is not None
        and not isinstance(scene, prim_scene.PrimScene)
        and not scene.bilinear
        and scene.atlas.packed is not None
        and int(scene.atlas.packed.shape[0]) < (1 << 24)
    ):
        # Per-call lax.cond around the texel gather: the tap is an HBM
        # random-access gather (~14 ns/ray — 12.8 ms at 1M rays) yet most
        # BOUNCE chunks contain no textured hit at all (bunny_teapot: only
        # the floor plane is textured).  The path tracer calls shade per
        # compaction chunk, so chunks whose rays all hit untextured
        # materials (or sky) skip the gather entirely.
        any_tex = jnp.any(fields["tex_id"] >= 0)

        def _tap(_):
            texel = tex_mod.nearest_texel(
                scene.atlas, fields["tex_off"], fields["tex_w"], fields["tex_h"],
                uv[..., 0], uv[..., 1],
            )
            return jnp.where((fields["tex_id"] >= 0)[..., None], texel, fields["albedo"])

        return jax.lax.cond(any_tex, _tap, lambda _: fields["albedo"], None)
    if isinstance(scene, prim_scene.PrimScene):
        base = scene.materials.albedo[mat_id]
        if obj is None or point is None:
            return base
        override = prim_scene.get_albedo_override(scene, obj, point)
        overridden = (obj >= 4) & (obj <= 6)
        return jnp.where(overridden[..., None], override, base)
    return mat_mod.get_albedo(
        scene.materials,
        scene.atlas,
        mat_id,
        uv[..., 0],
        uv[..., 1],
        bilinear=scene.bilinear,
    )


def sky_color(scene: DeviceScene, d: jnp.ndarray):
    """Equirect skydome sample, or black when the scene has none
    (primitive_scene.cpp:82-85)."""
    skydome = getattr(scene, "skydome_tex", -1)
    if skydome < 0:
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    return tex_mod.sample_equirect(scene.atlas, skydome, d, scene.bilinear)


def get_light_pos(scene: DeviceScene) -> jnp.ndarray:
    """Middle of the light quad minus a small y offset
    (tlas_file_scene.cpp:191-196)."""
    c1 = vm.transform_position(jnp.array([-0.5, 0.0, -0.5], jnp.float32), scene.light_t)
    c2 = vm.transform_position(jnp.array([0.5, 0.0, 0.5], jnp.float32), scene.light_t)
    return (c1 + c2) * 0.5 - jnp.array([0.0, 0.01, 0.0], jnp.float32)
