"""Whitted-style ray tracing as a bounded wavefront with compaction.

The reference's recursive `Trace` (2. WhittedStyle/renderer.cpp:21-126)
branches: a dielectric surface recurses into BOTH the refracted `(1-Fr)` and
reflected `Fr` rays, a mirror into one ray, a diffuse surface into none
(its radiance is computed locally from a shadow ray + constant ambient).

Batched formulation: one ray buffer per depth level.  Level 0 holds the
primary rays; each level traces its buffer, scatters local radiance
(sky/light/diffuse) into the film weighted by the per-ray throughput, and
compacts up to two weighted children per ray into the next level's buffer
with a prefix-sum scatter.  All shapes are static: the child buffer capacity
is `cap_factor * n_pixels` (children beyond capacity are dropped and
counted — with the shipped scenes' mostly-diffuse materials the buffers are
never near full).
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.core import camera as cam_mod
from cpu_ray_tracer_tpu.core import vecmath as vm
from cpu_ray_tracer_tpu.render import common
from cpu_ray_tracer_tpu.scene import query
from cpu_ray_tracer_tpu.scene.types import DeviceScene

EPS = constants.SHADE_EPS
AMBIENT = np.array(constants.AMBIENT, np.float32)


def _shade_level(
    scene: DeviceScene, o, d, inside, weight, pixel, alive, emit_children: bool,
    differentiable: bool = False,
):
    """Trace + shade one wavefront level.

    Returns (film_contrib_indices, film_contrib_values, child dict or None,
    stats dict).
    """
    nearest = query.find_nearest_diff if differentiable else query.find_nearest
    res = nearest(scene, o, d, mask=alive)
    t = res["t"]
    obj = res["obj_idx"]
    hit_mask = (obj >= 0) & alive
    miss_mask = (~(obj >= 0)) & alive

    point = o + t[..., None] * d
    normal, uv, mat_id = query.get_hit_info(scene, res, point, d)
    mf = query.material_fields(scene, mat_id)
    albedo = query.get_albedo(scene, mat_id, uv, obj=obj, point=point, fields=mf)

    is_light = mf["is_light"] & hit_mask
    surf = hit_mask & (~is_light)

    refl = mf["reflectivity"]
    refr = mf["refractivity"]
    diff = 1.0 - (refl + refr)
    medium = jnp.where(
        inside[..., None], jnp.exp(mf["absorption"] * (-t)[..., None]), 1.0
    )

    # --- local radiance ---------------------------------------------------
    # sky: chunked with dead-chunk skipping (pathtracer._chunked_contrib) —
    # primary misses are contiguous in pixel order, so chunks without a
    # miss skip the equirect gather entirely
    from cpu_ray_tracer_tpu.render.pathtracer import _chunked_contrib, _pick_chunks

    def sky_fn(m, w_, dd):
        return jnp.where(m[..., None], w_, 0.0) * query.sky_color(scene, dd)

    contrib = _chunked_contrib(
        sky_fn, miss_mask, (miss_mask, weight, d),
        _pick_chunks(miss_mask.shape[0], 48),
    )
    contrib = jnp.where(is_light[..., None], weight * scene.light_color, contrib)

    do_diffuse = surf & (diff > 0.0)
    irradiance = common.direct_illumination(scene, point, normal, active=do_diffuse)
    brdf = albedo * constants.INVPI
    local = diff[..., None] * brdf * (irradiance + AMBIENT)
    contrib = jnp.where(do_diffuse[..., None], contrib + weight * medium * local, contrib)

    stats = dict(traversed=res["traversed"] * alive, tested=res["tested"] * alive)

    if not emit_children:
        return pixel, contrib, None, stats

    # --- children -----------------------------------------------------------
    # mirror branch (renderer.cpp:48-53): refl > 0 excludes the dielectric
    # branch (else-if), diffuse still runs on the side.
    is_mirror = surf & (refl > 0.0)
    is_diel = surf & (~(refl > 0.0)) & (refr > 0.0)

    fr, can_refract, t_dir, r_dir = common.dielectric_terms(d, normal, inside)

    # child 1: reflection (mirror, or dielectric Fr); fresh rays have
    # inside = False (template/ray.h default — reference quirk kept)
    emit1 = is_mirror | is_diel
    w1 = jnp.where(
        is_mirror[..., None],
        weight * medium * refl[..., None] * albedo,
        weight * medium * albedo * fr[..., None],
    )
    o1 = point + r_dir * EPS
    # child 2: dielectric refraction, flips `inside`
    emit2 = is_diel & can_refract
    w2 = weight * medium * albedo * (1.0 - fr)[..., None]
    o2 = point + t_dir * EPS
    children = dict(
        emit1=emit1, o1=o1, d1=r_dir, w1=w1,
        emit2=emit2, o2=o2, d2=t_dir, w2=w2,
        inside2=~inside,
    )
    return pixel, contrib, children, stats


def _compact_children(children, pixel, cap: int):
    """Prefix-sum scatter of up to two children per ray into a fresh level
    buffer of capacity `cap`.  Returns (o, d, inside, weight, pixel, alive,
    dropped_count).

    All per-child fields ride ONE packed [*, 11] record (ints bitcast to
    f32), so the compaction costs two scatters instead of ten."""
    bc = jax.lax.bitcast_convert_type
    e1 = children["emit1"]
    e2 = children["emit2"]
    src = jnp.arange(e1.shape[0], dtype=jnp.int32)
    n1 = jnp.cumsum(e1.astype(jnp.int32))
    total1 = n1[-1]
    # non-emitting slots get UNIQUE out-of-bounds positions (cap + src, all
    # distinct) rather than a shared `cap`: every position is then unique,
    # which admits XLA's unique-indices scatter lowering
    pos1 = jnp.where(e1, n1 - 1, cap + src)
    n2 = jnp.cumsum(e2.astype(jnp.int32))
    pos2 = jnp.where(e2, total1 + n2 - 1, cap + src)

    pix_f = bc(pixel, jnp.float32)[:, None]
    rec1 = jnp.concatenate(
        [
            children["o1"], children["d1"], children["w1"], pix_f,
            # reflection children: inside = False
            jnp.zeros_like(pix_f),
        ],
        axis=1,
    )
    rec2 = jnp.concatenate(
        [
            children["o2"], children["d2"], children["w2"], pix_f,
            bc(children["inside2"].astype(jnp.int32), jnp.float32)[:, None],
        ],
        axis=1,
    )
    # dead-slot defaults: o = w = 0, d = 1 (finite reciprocals in the
    # traversal), pix = 0, inside = 0
    base = jnp.zeros((cap, 11), jnp.float32).at[:, 3:6].set(1.0)

    def compact(_):
        # apply the prefix-sum permutation as a GATHER through its 1-D
        # inverse: a rank-1 inverse scatter + one [cap, 11] row gather in
        # place of two multi-lane [R, 11] scatters.  slot_src[k] = source
        # row (in the stacked rec1|rec2) whose child lands in slot k;
        # -1 = dead.
        r = src.shape[0]
        slot_src = (
            jnp.full((cap,), -1, jnp.int32)
            .at[pos1].set(src, mode="drop", unique_indices=True)
            .at[pos2].set(src + r, mode="drop", unique_indices=True)
        )
        recs = jnp.concatenate([rec1, rec2], axis=0)
        got = recs[jnp.maximum(slot_src, 0)]
        return jnp.where((slot_src >= 0)[:, None], got, base)

    # pure-diffuse wavefronts emit nothing at all (e.g. upstream
    # inside_scene: every material has refl = refr = 0) — skip the
    # compaction outright in that case
    count = total1 + n2[-1]
    buf = jax.lax.cond(count > 0, compact, lambda _: base, None)

    o = buf[:, 0:3]
    d = buf[:, 3:6]
    w = buf[:, 6:9]
    pix = bc(buf[:, 9], jnp.int32)
    inside = bc(buf[:, 10], jnp.int32) > 0

    slot = jnp.arange(cap)
    alive = slot < jnp.minimum(count, cap)
    dropped = jnp.maximum(count - cap, 0)
    return o, d, inside, w, pix, alive, dropped


def render(
    scene: DeviceScene,
    camera: cam_mod.Camera,
    depth_limit: int = constants.DEPTH_LIMIT,
    cap_factor: float = 0.25,
    differentiable: bool = False,
):
    """Render one Whitted frame.  Returns dict(image [H,W,3], traversed,
    tested [H,W] of the primary rays — the reference's per-ray
    instrumentation — plus dropped-ray count)."""
    n = camera.width * camera.height
    rays = cam_mod.full_frame_rays(camera)

    # Capacity PYRAMID: level L's buffer holds cap_factor*n*decay^(L-1)
    # rays (floor 8192).  Secondary wavefronts shrink geometrically in
    # practice (only mirror/dielectric hits emit children), and every
    # per-level cost — traversal, shadow any-hit, shading, sky gather —
    # scales with the STATIC buffer width, so fixed full-size levels paid
    # several times the live work.  Correctness is unaffected: overflow
    # at any level is counted and render_adaptive grows cap_factor
    # (grow-or-fail), so dielectric-heavy scenes that really do double per
    # level still render unbiased.
    decay = float(_os.environ.get("CRT_WHITTED_DECAY", "0.5"))
    # floor never exceeds the requested capacity: deliberately tiny
    # cap_factors (tests, memory-constrained runs) must still drop+grow
    floor_cap = max(1, min(int(cap_factor * n), 8192))

    def level_cap(level: int) -> int:
        c = int(cap_factor * n * decay ** (level - 1))
        return max(min(c, int(cap_factor * n)), floor_cap)

    film = jnp.zeros((n, 3), jnp.float32)

    # level 0 (primary)
    pixel0 = jnp.arange(n, dtype=jnp.int32)
    alive0 = jnp.ones((n,), jnp.bool_)
    w0 = jnp.ones((n, 3), jnp.float32)
    pix, contrib, children, stats0 = _shade_level(
        scene, rays.o, rays.d, rays.inside, w0, pixel0, alive0,
        emit_children=depth_limit >= 1, differentiable=differentiable,
    )
    # level 0's pixel ids are the identity, so the film scatter is a plain
    # add
    film = film + contrib
    dropped = jnp.zeros((), jnp.int32)

    if children is not None:
        o, d, inside, w, pixv, alive, drop = _compact_children(
            children, pixel0, level_cap(1)
        )
        dropped += drop

        def run_level(emit, cap_out, carry):
            """One secondary wavefront level; skipped wholesale (lax.cond)
            when no children were emitted — in mostly-diffuse scenes the
            primary level emits none and the frame costs one level."""
            film, dropped, o, d, inside, w, pixv, alive = carry
            pix, contrib, children, _ = _shade_level(
                scene, o, d, inside, w, pixv, alive, emit_children=emit,
                differentiable=differentiable,
            )
            # flat rank-1 scatter-add in place of a multi-lane [n, 3] add
            # at colliding pixel ids
            contrib = jnp.where(alive[..., None], contrib, 0.0)
            fi = pix[:, None] * 3 + jnp.arange(3, dtype=pix.dtype)[None, :]
            film = (
                film.reshape(-1).at[fi.reshape(-1)].add(contrib.reshape(-1))
            ).reshape(film.shape)
            if children is None:
                return (film, dropped) + _dead_level(cap_out)
            o, d, inside, w, pixv, alive, drop = _compact_children(
                dict(
                    emit1=children["emit1"] & alive,
                    o1=children["o1"], d1=children["d1"], w1=children["w1"],
                    emit2=children["emit2"] & alive,
                    o2=children["o2"], d2=children["d2"], w2=children["w2"],
                    inside2=children["inside2"],
                ),
                pixv,
                cap_out,
            )
            return film, dropped + drop, o, d, inside, w, pixv, alive

        def _dead_level(cap_out: int):
            return (
                jnp.zeros((cap_out, 3), jnp.float32),
                jnp.ones((cap_out, 3), jnp.float32),
                jnp.zeros((cap_out,), jnp.bool_),
                jnp.zeros((cap_out, 3), jnp.float32),
                jnp.zeros((cap_out,), jnp.int32),
                jnp.zeros((cap_out,), jnp.bool_),
            )

        carry = (film, dropped, o, d, inside, w, pixv, alive)
        for level in range(1, depth_limit + 1):
            emit = level < depth_limit
            # next level's (static) buffer width; the last level emits none
            cap_out = level_cap(level + 1) if emit else floor_cap
            n_live = jnp.sum(carry[7].astype(jnp.int32))
            if isinstance(n_live, jax.core.Tracer):
                carry = jax.lax.cond(
                    n_live > 0,
                    lambda c, emit=emit, co=cap_out: run_level(emit, co, c),
                    lambda c, co=cap_out: (c[0], c[1]) + _dead_level(co),
                    carry,
                )
            elif int(n_live) > 0:
                # EAGER path: a python branch instead of lax.cond — tracing
                # the cond eagerly would compile its branches with the scene
                # arrays inlined as HLO constants (giant programs, XLA CPU
                # compiler aborts), and eager numerics (no FMA contraction)
                # are what the scalar-oracle goldens pin
                carry = run_level(emit, cap_out, carry)
            else:
                carry = (carry[0], carry[1]) + _dead_level(cap_out)
        film, dropped = carry[0], carry[1]

    img = film.reshape(camera.height, camera.width, 3)
    return dict(
        image=img,
        traversed=stats0["traversed"].reshape(camera.height, camera.width),
        tested=stats0["tested"].reshape(camera.height, camera.width),
        dropped=dropped,
    )


render_jit = jax.jit(render, static_argnames=("depth_limit", "cap_factor", "differentiable"))


def render_adaptive(
    scene: DeviceScene,
    camera: cam_mod.Camera,
    depth_limit: int = constants.DEPTH_LIMIT,
    cap_factor: float = 0.25,
    max_cap_factor: float = 8.0,
    differentiable: bool = False,
    on_grow=None,
):
    """Grow-or-fail child-buffer policy (host loop around `render_jit`):
    whenever secondary rays are dropped at the capacity, double the cap
    (recompiling for the new static shape) and re-render.  A frame that
    still drops rays at `max_cap_factor` raises instead of returning a
    silently darkened (biased) image.  `on_grow(dropped, new_cap_factor)`
    is called before each retry (for CLI messaging)."""
    cf = cap_factor
    while True:
        out = render_jit(
            scene, camera, depth_limit=depth_limit, cap_factor=cf,
            differentiable=differentiable,
        )
        n_dropped = int(out["dropped"])  # scalar device->host read
        if n_dropped == 0:
            out["cap_factor"] = cf
            return out
        if cf >= max_cap_factor:
            raise RuntimeError(
                f"whitted: {n_dropped} secondary rays still dropped at "
                f"cap_factor={cf} (max {max_cap_factor}); refusing to return "
                "a biased render"
            )
        cf = min(cf * 2.0, max_cap_factor)
        if on_grow is not None:
            on_grow(n_dropped, cf)
