"""Monte-Carlo path tracer as a bounded megabatch loop.

The reference's recursive `Sample` (3. PathTracer/renderer.cpp:50-101) is
tail recursion with a single stochastic child per bounce — exactly a loop.
Here the whole frame (or shard) of rays advances in lockstep through
`depth_limit + 1` bounce iterations carrying SoA state
{origin, dir, throughput, inside, seed, alive}; terminated lanes are masked.

Estimator parity (renderer.cpp:84-99):
* one uniform draw r selects the lobe: r < refl -> mirror;
  r < refl + refr -> dielectric (stochastic Fresnel choice); else diffuse;
* diffuse bounce: uniform-hemisphere direction, estimator
  brdf * 2pi * cos(R, N);
* miss -> skydome BEFORE the depth check; light hit -> light color (the sky
  gather itself is deferred to one post-loop pass — a ray escapes at most
  once);
* Beer absorption while inside; fresh rays reset `inside` except the
  refracted child (template/ray.h default — reference behavior kept).

Wavefront compaction: before every bounce >= 1 the ray state is globally
re-sorted by (terminated-last, origin Morton code, direction octant) and
processed in CHUNKS; a chunk whose slots lie wholly beyond the live-ray
count is skipped with `lax.cond` — real, unbiased work skipping (XLA
branches at runtime), adaptive to how fast paths terminate.

RNG: stateless per-ray xorshift32 streams (core/rng.py) seeded by
(pixel, sample) — the vectorizable replacement for the reference's per-tile
sequential stream.
"""

from __future__ import annotations

import functools
import os as _os

import jax
import jax.numpy as jnp

from cpu_ray_tracer_tpu import constants
from cpu_ray_tracer_tpu.core import camera as cam_mod
from cpu_ray_tracer_tpu.core import rng as rng_mod
from cpu_ray_tracer_tpu.ops.traverse_bvh import ray_octants
from cpu_ray_tracer_tpu.render import common
from cpu_ray_tracer_tpu.scene import query
from cpu_ray_tracer_tpu.scene.types import DeviceScene

EPS = constants.SHADE_EPS


def _default_chunks() -> int:
    """Compaction chunks per bounce (shared by sample_radiance and
    render_pass — keep the default in ONE place)."""
    return int(_os.environ.get("CRT_COMPACTION_CHUNKS", "48"))


def _pick_chunks(r: int, c: int) -> int:
    """Largest divisor of r that is <= the requested chunk count.

    A non-dividing count must not silently fall to 1 (= compaction OFF):
    at 1024x640, 655360 % 48 != 0."""
    if r < 4096 or c <= 1:
        return 1
    while c > 1 and r % c != 0:
        c -= 1
    return max(c, 1)

# per-ray state keys permuted by the compaction sort.  No "radiance"
# lane: a path emits at most ONCE (light hit XOR sky miss), dead lanes are
# never mutated, so emission is reconstructed post-loop from the frozen
# throughput and two flag bits (lit/missed) — 3 fewer f32 lanes in every
# compaction permute and chunk scan.
_RAY_KEYS = (
    "o", "d", "seed", "throughput", "inside", "alive",
    "missed", "lit", "traversed", "tested", "pixel", "locus",
)


@jax.custom_vjp
def _apply_perm(x, perm, inv):
    """Permutation gather with a GATHER backward: y = x[perm] transposes to
    dL/dx = dL/dy[inv] because a permutation's adjoint is its inverse.  The
    autodiff default would transpose the gather into a random-index
    multi-lane scatter."""
    return x[perm]


def _apply_perm_fwd(x, perm, inv):
    return x[perm], inv


def _apply_perm_bwd(inv, g):
    return (g[inv], None, None)


_apply_perm.defvjp(_apply_perm_fwd, _apply_perm_bwd)


def _inverse_perm(perm):
    """Inverse permutation via a 1-D iota scatter."""
    r = perm.shape[0]
    return (
        jnp.zeros((r,), jnp.int32)
        .at[perm]
        .set(jnp.arange(r, dtype=jnp.int32), unique_indices=True)
    )


def _permute_state_diff(state: dict, perm) -> dict:
    """Differentiable-mode permutation: float fields ride one [R, 9] pack
    (plus the 2 tap lerp weights when deferred tap records are present —
    they carry uv tangents) through the custom-vjp gather (_apply_perm);
    integer/flag fields ride a separate int32 gather, which autodiff
    ignores entirely (integer arrays carry no tangents) — no bitcast ever
    meets a differentiated value."""
    bc = jax.lax.bitcast_convert_type
    has_taps = "tap_i0" in state
    inv = _inverse_perm(perm)
    fcols = [state["o"], state["d"], state["throughput"]]
    if has_taps:
        fcols += [state["tap_tx"][..., None], state["tap_ty"][..., None]]
    fl = jnp.concatenate(fcols, axis=1)
    fl = _apply_perm(fl, perm, inv)
    flags = (
        state["inside"].astype(jnp.int32)
        + 2 * state["alive"].astype(jnp.int32)
        + 4 * state["missed"].astype(jnp.int32)
        + 8 * state["lit"].astype(jnp.int32)
    )
    icols = [
        bc(state["seed"], jnp.int32),
        flags,
        state["traversed"],
        state["tested"],
        state["pixel"],
        state["locus"],
    ]
    if has_taps:
        icols += [state[k] for k in _TAP_KEYS[:4]]
    ints = jnp.stack(icols, axis=1)[perm]
    pflags = ints[:, 1]
    out = dict(
        o=fl[:, 0:3],
        d=fl[:, 3:6],
        throughput=fl[:, 6:9],
        seed=bc(ints[:, 0], jnp.uint32),
        inside=(pflags & 1) > 0,
        alive=(pflags & 2) > 0,
        missed=(pflags & 4) > 0,
        lit=(pflags & 8) > 0,
        traversed=ints[:, 2],
        tested=ints[:, 3],
        pixel=ints[:, 4],
        locus=ints[:, 5],
    )
    if has_taps:
        out["tap_tx"] = fl[:, 9]
        out["tap_ty"] = fl[:, 10]
        for j, k in enumerate(_TAP_KEYS[:4]):
            out[k] = ints[:, 6 + j]
    return out


def _permute_state(state: dict, perm) -> dict:
    """Apply one permutation to the whole per-ray state with a SINGLE gather:
    all fields are packed (ints bitcast to f32 — a gather only moves bytes)
    into one [R, 15] array, gathered once, then split back: one wide row
    gather in place of a dozen 1-3-lane ones.  The bool flags share one
    bit-packed lane and the miss/lit records are single bits (see
    _RAY_KEYS note).

    Deferred bilinear tap records (_TAP_KEYS, the d1-tap deferral — see
    sample_radiance) ride the same packed gather as 6 extra lanes when
    present: 21 in all.

    `perm` is either gather indices (sources), or ("scatter", pos) with
    DESTINATION indices (the counting-sort path computes the inverse
    permutation directly — applying it as a scatter skips the argsort)."""
    bc = jax.lax.bitcast_convert_type
    has_taps = "tap_i0" in state
    flags = (
        state["inside"].astype(jnp.int32)
        + 2 * state["alive"].astype(jnp.int32)
        + 4 * state["missed"].astype(jnp.int32)
        + 8 * state["lit"].astype(jnp.int32)
    )
    cols = [
        state["o"],  # 0:3
        state["d"],  # 3:6
        state["throughput"],  # 6:9
        bc(state["seed"], jnp.float32)[..., None],  # 9
        bc(flags, jnp.float32)[..., None],  # 10 (inside|alive|missed|lit)
        bc(state["traversed"], jnp.float32)[..., None],  # 11
        bc(state["tested"], jnp.float32)[..., None],  # 12
        bc(state["pixel"], jnp.float32)[..., None],  # 13
        bc(state["locus"], jnp.float32)[..., None],  # 14
    ]
    if has_taps:
        cols += [
            bc(state[k], jnp.float32)[..., None] for k in _TAP_KEYS[:4]
        ] + [state[k][..., None] for k in _TAP_KEYS[4:]]  # 15:19 ids, 19:21 w
    stacked = jnp.concatenate(cols, axis=1)
    if isinstance(perm, tuple) and perm[0] == "scatter":
        packed = jnp.zeros_like(stacked).at[perm[1]].set(stacked, unique_indices=True)
    else:
        packed = stacked[perm]
    pflags = bc(packed[:, 10], jnp.int32)
    out = dict(
        o=packed[:, 0:3],
        d=packed[:, 3:6],
        throughput=packed[:, 6:9],
        seed=bc(packed[:, 9], jnp.uint32),
        inside=(pflags & 1) > 0,
        alive=(pflags & 2) > 0,
        missed=(pflags & 4) > 0,
        lit=(pflags & 8) > 0,
        traversed=bc(packed[:, 11], jnp.int32),
        tested=bc(packed[:, 12], jnp.int32),
        pixel=bc(packed[:, 13], jnp.int32),
        locus=bc(packed[:, 14], jnp.int32),
    )
    if has_taps:
        for j, k in enumerate(_TAP_KEYS[:4]):
            out[k] = bc(packed[:, 15 + j], jnp.int32)
        out["tap_tx"] = packed[:, 19]
        out["tap_ty"] = packed[:, 20]
    return out


def _compaction_perm(scene: DeviceScene, o, d, alive, locus=None, allow_scatter=True):
    """Compaction sort key (perf-only: the estimator is order-invariant, so
    the image is bit-identical under ANY permutation here).

    Default "locus": STABLE (dead-last, direction octant, previous-hit
    triangle id) — the finest origin-coherence key (rays leaving the same
    triangle share an origin to within one primitive).  CRT_RESORT=octant
    keeps only the stable octant order; CRT_RESORT=morton uses the
    (dead, Morton, octant) key."""
    oct_ = ray_octants(d)
    mode = _os.environ.get("CRT_RESORT", "locus")
    if mode == "octant_cs" and not allow_scatter:
        mode = "octant"  # diff mode needs a gatherable permutation
    if mode == "octant_cs":
        # stable 9-bucket counting sort: pos[i] = start[key[i]] + rank-in-
        # bucket via one-hot cumsum — no 32-bit bitonic sort.  Returns the
        # INVERSE permutation (destinations); caller scatters with it.
        key = jnp.where(alive, oct_, jnp.int32(8))
        oh = jax.nn.one_hot(key, 9, dtype=jnp.int32)
        within = jnp.cumsum(oh, axis=0) - oh
        counts = within[-1] + oh[-1]
        starts = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]]
        )
        pos = jnp.sum(oh * (starts[None, :] + within), axis=1)
        return ("scatter", pos)
    if mode == "octant" or (mode == "locus" and locus is None):
        key = jnp.where(alive, oct_, jnp.int32(8))
        return jnp.argsort(key, stable=True)
    if mode == "locus":
        # (dead, octant, previous-hit triangle): rays leaving the same
        # triangle share an origin to within one primitive — far tighter
        # tile unions than any quantized-origin code
        key = (oct_ << 21) | jnp.clip(locus + 1, 0, (1 << 21) - 1)
        key = jnp.where(alive, key, jnp.int32(0x7FFFFFFF))
        return jnp.argsort(key, stable=True)
    root = getattr(scene, "bvh", None)
    if getattr(scene, "shared", None) is not None:
        # shared-instancing mode: mesh-0's root box is object space; the
        # instance-AABB union is the world box
        wmin = jnp.asarray(scene.shared.world_min, jnp.float32)
        wext = jnp.maximum(
            jnp.asarray(scene.shared.world_max, jnp.float32) - wmin, 1e-20
        )
        q = jnp.clip(((o - wmin) / wext) * 127.0, 0.0, 127.0).astype(jnp.int32)

        def spread3(v):
            v = (v | (v << 8)) & 0x0300F00F
            v = (v | (v << 4)) & 0x030C30C3
            v = (v | (v << 2)) & 0x09249249
            return v

        morton = spread3(q[..., 0]) | (spread3(q[..., 1]) << 1) | (spread3(q[..., 2]) << 2)
        key = (morton << 3) | oct_
        key = jnp.where(alive, key, jnp.int32(0x7FFFFFFF))
        return jnp.argsort(key)
    if root is not None:
        wmin = scene.bvh.node_min[scene.bvh.root]
        wext = jnp.maximum(scene.bvh.node_max[scene.bvh.root] - wmin, 1e-20)
        q = jnp.clip(((o - wmin) / wext) * 127.0, 0.0, 127.0).astype(jnp.int32)

        def spread3(v):
            v = (v | (v << 8)) & 0x0300F00F
            v = (v | (v << 4)) & 0x030C30C3
            v = (v | (v << 2)) & 0x09249249
            return v

        morton = spread3(q[..., 0]) | (spread3(q[..., 1]) << 1) | (spread3(q[..., 2]) << 2)
        key = (morton << 3) | oct_
    else:
        key = oct_
    key = jnp.where(alive, key, jnp.int32(0x7FFFFFFF))
    return jnp.argsort(key)


def _bounce_step(scene, nearest, depth_limit, depth, s, tap_chunks=1, defer_tex=False):
    """Advance every ray in `s` one path segment (any batch size).

    `tap_chunks`: chunk the albedo texel tap (only) so image regions
    with no textured hit skip its HBM gather (see get_albedo's
    lax.cond).  Used by the full-width PRIMARY call, whose pixel order
    is spatially coherent; bounce-depth calls are already chunked by
    depth_body so they pass 1.

    `defer_tex` (bilinear diff mode): do NOT gather texels here — record
    the 4 bilinear tap indices + 2 lerp weights ("tap_idx" [W, 4] i32,
    "tap_w" [W, 2] f32 in the returned dict) and use albedo = 1 on
    textured lanes; the caller multiplies the texture factor into
    throughput at depth width, OUTSIDE the chunk scans (see
    sample_radiance — this is what makes compaction chunking affordable
    under texture-learning grads: the scan transpose otherwise
    materializes one atlas cotangent per chunk iteration).  Albedo is a
    purely multiplicative per-bounce factor on throughput (lobe choice
    and direction never read it), so the deferral is exact."""
    alive = s["alive"]
    res = nearest(scene, s["o"], s["d"], mask=alive)
    t = res["t"]
    obj = res["obj_idx"]
    hit = (obj >= 0) & alive
    miss = (~(obj >= 0)) & alive

    missed = s["missed"] | miss
    # depth cutoff AFTER the miss/sky record (renderer.cpp:52-55)
    # (jnp ops: python `~False` is -2 and would int-promote the mask)
    past_limit = jnp.asarray(depth >= depth_limit)
    hit = jnp.logical_and(hit, jnp.logical_not(past_limit))

    point = s["o"] + t[..., None] * s["d"]
    normal, uv, mat_id = query.get_hit_info(scene, res, point, s["d"])
    mf = query.material_fields(scene, mat_id)
    w = mat_id.shape[0]
    if defer_tex:
        # bilinear tap indices/weights only (sample_bilinear's address
        # math on the fused per-ray table fields); gather deferred
        textured = mf["tex_id"] >= 0
        albedo = jnp.where(textured[..., None], 1.0, mf["albedo"])
    elif tap_chunks > 1 and w % tap_chunks == 0:

        def tap_body(_, args):
            mid_c, uv_c, obj_c, pt_c, mf_c = args
            return None, query.get_albedo(
                scene, mid_c, uv_c, obj=obj_c, point=pt_c, fields=mf_c
            )

        ck = lambda x: x.reshape(tap_chunks, w // tap_chunks, *x.shape[1:])
        _, albedo = jax.lax.scan(
            tap_body,
            None,
            (ck(mat_id), ck(uv), ck(obj), ck(point), {k: ck(v) for k, v in mf.items()}),
        )
        albedo = albedo.reshape(w, 3)
    else:
        albedo = query.get_albedo(scene, mat_id, uv, obj=obj, point=point, fields=mf)
    # light hit: the ray DIES here with throughput frozen, so the emission
    # throughput*light_color is reconstructed post-loop from the lit bit
    # (see _RAY_KEYS note) — no radiance lanes ride the state
    is_light = mf["is_light"] & hit
    lit = s["lit"] | is_light
    surf = hit & (~is_light)

    refl = mf["reflectivity"]
    refr = mf["refractivity"]
    medium = jnp.where(
        s["inside"][..., None],
        jnp.exp(mf["absorption"] * (-t)[..., None]),
        1.0,
    )

    seed = s["seed"]
    seed, r_lobe = rng_mod.random_float(seed)
    pick_mirror = surf & (r_lobe < refl)
    pick_diel = surf & (~pick_mirror) & (r_lobe < refl + refr)
    pick_diff = surf & (~pick_mirror) & (~pick_diel)

    # dielectric: stochastic Fresnel branch (renderer.cpp:27-45)
    fr, can_refract, t_dir, r_dir = common.dielectric_terms(s["d"], normal, s["inside"])
    seed, r_fresnel = rng_mod.random_float(seed)
    take_refract = pick_diel & can_refract & (r_fresnel > fr)

    # diffuse: uniform hemisphere + estimator brdf * 2pi * cos
    seed, r1 = rng_mod.random_float(seed)
    seed, r2 = rng_mod.random_float(seed)
    diff_dir = common.uniform_hemisphere(normal, r1, r2)
    cosr = jnp.maximum(common.vm.dot(diff_dir, normal), 0.0)
    diff_w = albedo * constants.INVPI * (2.0 * constants.PI) * cosr[..., None]

    new_d = jnp.where(
        pick_diff[..., None],
        diff_dir,
        jnp.where(take_refract[..., None], t_dir, r_dir),
    )
    lobe_w = jnp.where(
        pick_diff[..., None],
        diff_w,
        albedo,  # mirror / dielectric multiply albedo only
    )
    throughput = jnp.where(
        surf[..., None], s["throughput"] * medium * lobe_w, s["throughput"]
    )
    new_o = point + new_d * EPS
    inside = jnp.where(take_refract, ~s["inside"], jnp.zeros_like(s["inside"]))

    out = dict(
        o=jnp.where(surf[..., None], new_o, s["o"]),
        d=jnp.where(surf[..., None], new_d, s["d"]),
        seed=seed,
        throughput=throughput,
        inside=inside,
        alive=surf,
        missed=missed,
        lit=lit,
        traversed=s["traversed"] + res["traversed"],
        tested=s["tested"] + res["tested"],
        pixel=s["pixel"],
        locus=jnp.where(surf, res["tri_idx"], s["locus"]),
    )
    if defer_tex:
        # only lanes that BOUNCE off a textured surface carry a tap: light
        # hits / misses / dead lanes never have albedo multiplied into
        # throughput, so their deferred factor is exactly 1 and the
        # estimator is unchanged.  Records are six 1-D arrays (_TAP_KEYS
        # note).
        rec = surf & textured
        recs = _bilinear_records(
            mf["tex_off"], mf["tex_w"], mf["tex_h"],
            uv[..., 0], uv[..., 1], rec,
        )
        for k, v in zip(_TAP_KEYS, recs):
            out[k] = v
    return out


def _chunked_contrib(fn, any_mask, args, chunks: int):
    """Map `fn(*args) -> [W, 3]` over chunked [R, ...] args, skipping chunks
    where `any_mask` has no set lane (lax.cond — real runtime skipping;
    skipped chunks contribute zeros)."""
    r = any_mask.shape[0]
    if chunks <= 1 or r % chunks != 0:
        return fn(*args)
    w = r // chunks
    ck = lambda x: x.reshape(chunks, w, *x.shape[1:])

    def body(_, a):
        m, aa = a
        out = jax.lax.cond(
            jnp.any(m),
            lambda z: fn(*z),
            lambda z: jnp.zeros((w, 3), jnp.float32),
            aa,
        )
        return None, out

    _, out = jax.lax.scan(body, None, (ck(any_mask), tuple(ck(x) for x in args)))
    return out.reshape(r, *out.shape[2:])


# deferred-tap record keys emitted by _bounce_step in defer_tex mode: four
# tap indices (-1 = no tap) + two lerp weights, all 1-D [W] arrays.  The
# 1-D shape keeps the residuals that stack across the depth scan
# ([deep, W]) free of small trailing dims, which tiled layouts pad.
_TAP_KEYS = ("tap_i0", "tap_i1", "tap_i2", "tap_i3", "tap_tx", "tap_ty")


def _bilerp_weights(tx, ty):
    return (1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty


def _tap_rows(texels_flat, idx):
    """[W] tap rows gathered as 3 channel columns (row gather, not a
    3-index flat gather — one index per row).  Runs only inside
    _apply_tap_factor's fwd/bwd, where intermediates are residual-free."""
    t = texels_flat.reshape(-1, 3)[idx]
    return t[:, 0], t[:, 1], t[:, 2]


def _tap_pairs(texels_flat, ileft, iright):
    """Fetch the horizontally-ADJACENT tap pair with ONE 6-wide slice
    gather: bilinear taps within a texture row satisfy
    iright in {ileft, ileft + 1} (clamp-to-edge), so one [W, 6] fetch
    replaces two [W, 3] row gathers.  The boundary duplicate (iright == ileft at the
    texture's right edge) selects the left slice; the 6-wide fetch may then
    read 3 floats past the row (or the atlas — CLIP mode clamps), whose
    values are discarded by the same select.

    Returns ([W] x3 left-channel, [W] x3 right-channel)."""
    # the very last atlas texel as a left tap would need a slice past the
    # array end; CLIP would silently SHIFT the slice (corrupting the left
    # values), so gather from a safe base and re-select.  ileft == K-1 is
    # always a clamp-duplicate (the last texel has no right neighbor), so
    # right == left there by construction.
    kmax = texels_flat.shape[0] // 3 - 2
    il = jnp.maximum(ileft, 0)
    shifted = il > kmax
    base = jnp.minimum(il, kmax)
    out = jax.lax.gather(
        texels_flat,
        (base * 3)[:, None],
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
        ),
        slice_sizes=(6,),
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    dup = iright == ileft
    left = tuple(
        jnp.where(shifted, out[:, 3 + c], out[:, c]) for c in range(3)
    )
    right = tuple(
        jnp.where(dup, left[c], out[:, 3 + c]) for c in range(3)
    )
    return left, right


def _tap_quad(texels_flat, i0, i1, i2, i3):
    """All four bilinear taps: [4][3] of [W].

    Default: four per-tap ROW gathers (`_tap_rows`).  The 6-wide
    adjacent-PAIR slice gather (`_tap_pairs`, CRT_TAP_PAIRS=1) halves the
    index count; on the H100 it is not measured."""
    if _os.environ.get("CRT_TAP_PAIRS", "0") == "1":
        t0, t1 = _tap_pairs(texels_flat, i0, i1)
        t2, t3 = _tap_pairs(texels_flat, i2, i3)
        return [t0, t1, t2, t3]
    return [
        _tap_rows(texels_flat, jnp.maximum(i, 0)) for i in (i0, i1, i2, i3)
    ]


def _tap_channels(texels_flat, i0, i1, i2, i3, tx, ty):
    """Per-channel bilinear texture factor from flat tap records."""
    valid = i0 >= 0
    ws = _bilerp_weights(tx, ty)
    out = []
    taps = _tap_quad(texels_flat, i0, i1, i2, i3)
    for c in range(3):
        acc = sum(t[c] * w for t, w in zip(taps, ws))
        out.append(jnp.where(valid, acc, 1.0))
    return out


def _bilinear_records(off, w, h, u, v, rec):
    """Clamp-to-edge bilinear tap records (sample_bilinear's address math):
    (i0..i3, tx, ty), all 1-D, indices -1 where `rec` is False."""
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    fx = uu * w.astype(jnp.float32) - 0.5
    fy = vv * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx, ty = fx - x0, fy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    taps = tuple(
        jnp.where(rec, off + xi + yi * w, -1)
        for xi, yi in ((x0i, y0i), (x1i, y0i), (x0i, y1i), (x1i, y1i))
    )
    return taps + (jnp.where(rec, tx, 0.0), jnp.where(rec, ty, 0.0))


@jax.custom_vjp
def _apply_tap_factor(tp, texels_flat, i0, i1, i2, i3, tx, ty):
    """throughput [W, 3] * deferred bilinear texture factor (1 on tapless
    lanes).  Runs at depth width OUTSIDE the chunk scans but INSIDE the
    depth scan, so the custom VJP exists to pin the residual shapes: only
    the 1-D records and three 1-D throughput channel slices are saved
    (default AD would stack [W, 4, 3] gather residuals per depth
    iteration)."""
    f0, f1, f2 = _tap_channels(texels_flat, i0, i1, i2, i3, tx, ty)
    return jnp.stack([tp[:, 0] * f0, tp[:, 1] * f1, tp[:, 2] * f2], axis=1)


def _apply_tap_factor_fwd(tp, texels_flat, i0, i1, i2, i3, tx, ty):
    out = _apply_tap_factor(tp, texels_flat, i0, i1, i2, i3, tx, ty)
    res = (tp[:, 0], tp[:, 1], tp[:, 2], texels_flat, i0, i1, i2, i3, tx, ty)
    return out, res


def _apply_tap_factor_bwd(res, g):
    tp0, tp1, tp2, texels_flat, i0, i1, i2, i3, tx, ty = res
    valid = i0 >= 0
    ws = _bilerp_weights(tx, ty)
    idx = tuple(jnp.maximum(i, 0) for i in (i0, i1, i2, i3))
    taps = _tap_quad(texels_flat, i0, i1, i2, i3)  # [4][3] of [W]
    fs = [
        jnp.where(valid, sum(t[c] * w for t, w in zip(taps, ws)), 1.0)
        for c in range(3)
    ]
    gs = (g[:, 0], g[:, 1], g[:, 2])
    tps = (tp0, tp1, tp2)
    d_tp = jnp.stack([gs[c] * fs[c] for c in range(3)], axis=1)
    # gtp_c = dL/d(factor_c); zero where no tap (factor pinned to 1)
    gtp = [jnp.where(valid, gs[c] * tps[c], 0.0) for c in range(3)]
    # texel cotangents: 12 rank-1 contributions per lane (4 taps x 3
    # channels), scatter-added into the flat atlas CHUNKED with dead-chunk
    # skipping: taps exist only on textured-bounce lanes (~15-25% at depth
    # 0, less deeper), so a full-width scatter runs at mostly-zero
    # occupancy.  A lax.cond per chunk skips the scatter where no lane is
    # valid (the zero contributions are exact either way).
    w = valid.shape[0]
    ids2 = jnp.stack([idx[j] * 3 + c for j in range(4) for c in range(3)])
    cts2 = jnp.stack([gtp[c] * ws[j] for j in range(4) for c in range(3)])
    n_ck = _pick_chunks(w, int(_os.environ.get("CRT_TAP_SCATTER_CHUNKS", "48")))
    if n_ck > 1:
        idc = ids2.reshape(12, n_ck, -1).transpose(1, 0, 2)
        ctc = cts2.reshape(12, n_ck, -1).transpose(1, 0, 2)
        anyc = jnp.any(valid.reshape(n_ck, -1), axis=1)

        def body(acc, z):
            i, c, a = z
            return (
                jax.lax.cond(
                    a,
                    lambda acc_: acc_.at[i.reshape(-1)].add(c.reshape(-1)),
                    lambda acc_: acc_,
                    acc,
                ),
                None,
            )

        d_tex, _ = jax.lax.scan(
            body, jnp.zeros_like(texels_flat), (idc, ctc, anyc)
        )
    else:
        d_tex = (
            jnp.zeros_like(texels_flat)
            .at[ids2.reshape(-1)]
            .add(cts2.reshape(-1))
        )
    # weight cotangents d_wj = sum_c gtp_c * tap_jc, then chain to (tx, ty)
    dw = [sum(gtp[c] * taps[j][c] for c in range(3)) for j in range(4)]
    d_tx = dw[0] * -(1 - ty) + dw[1] * (1 - ty) + dw[2] * -ty + dw[3] * ty
    d_ty = dw[0] * -(1 - tx) + dw[1] * -tx + dw[2] * (1 - tx) + dw[3] * tx
    zero = jnp.where(valid, 1.0, 0.0)
    return (d_tp, d_tex, None, None, None, None, d_tx * zero, d_ty * zero)


_apply_tap_factor.defvjp(_apply_tap_factor_fwd, _apply_tap_factor_bwd)


def _sort_state(scene, st, diff=False):
    perm = _compaction_perm(
        scene,
        jax.lax.stop_gradient(st["o"]),
        jax.lax.stop_gradient(st["d"]),
        st["alive"],
        st["locus"],
        allow_scatter=not diff,
    )
    if diff:
        return _permute_state_diff(st, perm)
    return _permute_state(st, perm)


def _make_depth_body(scene, bounce, chunk, diff=False, texels_flat=None,
                     sort=True, apply_taps=True):
    """`texels_flat` non-None = deferred-tap bilinear diff mode: the bounce
    emits tap records through the chunk scan (stacked outputs — small), and
    the texture factor multiplies throughput here at depth width, outside
    the scan, so the scan transpose never accumulates atlas cotangents.

    `apply_taps=False` (the d1-tap deferral) leaves the records IN the
    returned state instead: they ride the next compaction sort as 6 extra
    permute lanes and the cascade applies the factor on the compacted tier
    HEAD — tap-carrying lanes are exactly the lanes alive at the next
    depth, so the factor's backward (the atlas cotangent scatter) runs at
    tier width instead of full width.

    `sort=False` skips the per-depth compaction resort: a cascade tier's
    entry sort already compacted+ordered the state, so the FIRST depth
    inside a tier re-sorting it is a pure no-op permutation."""
    defer_tex = texels_flat is not None

    def depth_body(carry, depth):
        """One bounce depth at the carried state's (static) width: global
        compaction resort, then chunked bounce with dead-chunk skipping."""
        state, rays_traced = carry
        w = state["alive"].shape[0]
        n_chunks = max(w // chunk, 1)
        cw = w // n_chunks
        n_alive = jnp.sum(state["alive"].astype(jnp.int32))
        rays_traced = rays_traced + n_alive
        if n_chunks > 1 and sort:
            state = _sort_state(scene, state, diff)
        chunked = {
            k: state[k].reshape(n_chunks, cw, *state[k].shape[1:])
            for k in _RAY_KEYS
        }
        # per-chunk live counts (exact skip: dead rays never resurrect)
        chunk_alive = jnp.sum(
            state["alive"].reshape(n_chunks, cw).astype(jnp.int32),
            axis=1,
        )

        def dead_chunk(p):
            out = dict(p)
            if defer_tex:
                for k in _TAP_KEYS[:4]:
                    out[k] = jnp.full((cw,), -1, jnp.int32)
                out["tap_tx"] = jnp.zeros((cw,), jnp.float32)
                out["tap_ty"] = jnp.zeros((cw,), jnp.float32)
            return out

        def chunk_body(_, inp):
            piece, calive = inp
            out = jax.lax.cond(
                calive > 0,
                lambda p: bounce(depth, p),
                dead_chunk,
                piece,
            )
            return None, out

        _, chunked = jax.lax.scan(chunk_body, None, (chunked, chunk_alive))
        state = {
            k: chunked[k].reshape(w, *chunked[k].shape[2:]) for k in _RAY_KEYS
        }
        if defer_tex and apply_taps:
            state["throughput"] = _apply_tap_factor(
                state["throughput"], texels_flat,
                *(chunked[k].reshape(w) for k in _TAP_KEYS),
            )
        elif defer_tex:
            for k in _TAP_KEYS:
                state[k] = chunked[k].reshape(w)
        return (state, rays_traced), None

    return depth_body


def _cascade(scene, state, rays_traced, deep, chunk, depth_body, r,
             diff=False, tiers=None, depth_body_first=None, texels_flat=None):
    """Liveness cascade over the `deep` depth indices.

    Deeper bounces usually have FEW survivors on open scenes (about 60%
    live at depth 1, under 5% from depth 2), yet a full-width depth
    iteration pays its resort and per-chunk fixed costs regardless of
    liveness.  So a cascade picks the
    narrowest static buffer (lax.cond nest) that holds every live ray, and
    all remaining depths run inside it; the full-width scan stays as the
    fallback for mirror-box-style scenes where most paths survive.  The
    chunk width is identical in every tier, so the traced bounce body is
    shared across tiers.

    `tiers`: ladder of tier widths in chunks (default (1, 4, 16, 36, 44)).

    `depth_body_first`: nosort variant of depth_body for the FIRST depth
    inside a tier (the tier's entry sort already ordered the head — see
    _make_depth_body sort=False)."""

    has_taps = "tap_i0" in state

    def apply_deferred(st):
        """Apply the deferred d1 tap factor (r5 d1-tap deferral) and drop
        the record lanes.  Called on the sorted tier HEAD where possible:
        every tap-carrying lane is alive at the next depth, so the entry
        sort compacted them all into the head."""
        st = dict(st)
        st["throughput"] = _apply_tap_factor(
            st["throughput"], texels_flat, *(st.pop(k) for k in _TAP_KEYS)
        )
        return st

    def deep_full(carry):
        st, rt = carry
        if has_taps:
            st = apply_deferred(st)  # no entry sort here: full width
        (st, rt), _ = jax.lax.scan(depth_body, (st, rt), jnp.asarray(deep))
        return st, rt

    first_body = depth_body_first if depth_body_first is not None else depth_body

    def make_tier(width):
        def tier(carry):
            st, rt = carry
            st = _sort_state(scene, st, diff)  # compact live rays into the prefix
            head = {k: st[k][:width] for k in st}
            tail = {k: st[k][width:] for k in _RAY_KEYS}
            if has_taps:
                head = apply_deferred(head)
            (head, rt), _ = first_body((head, rt), jnp.asarray(deep[0]))
            if len(deep) > 1:
                (head, rt), _ = jax.lax.scan(
                    depth_body, (head, rt), jnp.asarray(deep[1:])
                )
            st = {
                k: jnp.concatenate([head[k], tail[k]], axis=0)
                for k in _RAY_KEYS
            }
            return st, rt

        return tier

    n_live = jnp.sum(state["alive"].astype(jnp.int32))
    # tier ladder extends with the ray population: megapasses (several
    # samples per pass) keep chunk SIZE constant, so deep-depth live counts
    # scale with samples/pass and a short ladder would fall through to the
    # full-width fallback.  Extra tiers are free at 1 spp (the cond nest
    # just never takes them).
    if tiers is None:
        # wide rungs (36/44 chunks) for closed-interior scenes: inside_scene
        # keeps 52%/35%/25% of paths alive through depths 2-4, which would
        # otherwise fall through to the full-width fallback — every deep
        # depth then pays a full-width sort+permute.  A 0.75R tier caps
        # that at no cost to open scenes (their ~5% deep liveness still
        # lands on the narrow rungs).
        tiers = (1, 4, 16, 36, 44)
    tier_ws = [w * chunk for w in tiers if w * chunk < r]
    run = deep_full
    for w in reversed(tier_ws):  # build the cond nest widest-first
        run = (
            lambda carry, w=w, fallback=run: jax.lax.cond(
                n_live <= w, make_tier(w), fallback, carry
            )
        )
    return run((state, rays_traced))


def sample_radiance(
    scene: DeviceScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    seeds: jnp.ndarray,
    depth_limit: int = constants.DEPTH_LIMIT,
    differentiable: bool = False,
    compaction_chunks: int | None = None,
):
    """Estimate radiance along rays (o, d) [R, 3] with per-ray uint32 seeds.

    Returns (radiance [R, 3] in the INPUT ray order, stats dict).  The
    per-ray stats (traversed/tested) are in internal compaction order —
    use them only through permutation-invariant reductions.
    `compaction_chunks`: chunks per bounce >= 1 (default from
    CRT_COMPACTION_CHUNKS, see _default_chunks(); 1 disables skipping).

    differentiable=True keeps full compaction: each bounce is
    rematerialized (jax.checkpoint) so the per-chunk scan saves only its
    chunk INPUTS instead of the shading intermediates, and the compaction
    permutes go through a custom-vjp gather whose backward is the INVERSE
    gather (never a random-index scatter).  Bilinear (texture-learning)
    scenes chunk too: the texel tap is
    deferred out of every chunk scan as (index, weight) records and
    applied at depth width (_bounce_step defer_tex / _tap_factor), with a
    flat [K*3] atlas view so scan transposes accumulate unpadded
    cotangents (core/vecmath.gather_rows3)."""
    r = o.shape[0]
    if compaction_chunks is None:
        # grad mode prefers coarser chunks: the backward replays every live
        # chunk, so per-chunk fixed costs weigh double
        c = (
            int(_os.environ.get("CRT_COMPACTION_CHUNKS_DIFF", "16"))
            if differentiable
            else _default_chunks()
        )
        compaction_chunks = _pick_chunks(r, c)

    state = dict(
        o=o,
        d=d,
        seed=seeds,
        throughput=jnp.ones((r, 3), jnp.float32),
        inside=jnp.zeros((r,), jnp.bool_),
        alive=jnp.ones((r,), jnp.bool_),
        # deferred emission (see _RAY_KEYS note): a ray misses (or hits the
        # light) AT MOST once and nothing mutates its d/throughput
        # afterwards, so both records are ONE BIT — emission is applied
        # post-loop as missed*tp*sky(d) + lit*tp*light_color
        missed=jnp.zeros((r,), jnp.bool_),
        lit=jnp.zeros((r,), jnp.bool_),
        traversed=jnp.zeros((r,), jnp.int32),
        tested=jnp.zeros((r,), jnp.int32),
        pixel=jnp.arange(r, dtype=jnp.int32),
        # previous-hit triangle id: the finest origin-coherence signal for
        # the CRT_RESORT=locus compaction key (-1 until the first hit)
        locus=jnp.full((r,), -1, jnp.int32),
    )

    nearest = query.find_nearest_diff if differentiable else query.find_nearest
    # bilinear diff (texture learning): defer the texel tap out of every
    # chunk scan (see _bounce_step defer_tex) — the flat [K*3] texel view is
    # reshaped ONCE here so scan transposes accumulate unpadded flat
    # cotangents (vecmath._gather3_flat docstring)
    # CRT_DEFER_TEX=0 forces the INLINE bilinear tap (sample_bilinear via
    # autodiff) — the independent formulation the deferred path's
    # hand-written VJP is tested against (tests/test_diff.py)
    defer_tex = (
        differentiable
        and getattr(scene, "bilinear", False)
        and not isinstance(scene, query.prim_scene.PrimScene)
        and int(scene.atlas.texels.shape[0]) < (1 << 24)
        and _os.environ.get("CRT_DEFER_TEX", "1") != "0"
    )
    if differentiable and getattr(scene, "bilinear", False) and not defer_tex:
        # bilinear diff WITHOUT deferral (giant atlas or CRT_DEFER_TEX=0):
        # chunked inline taps stack one atlas cotangent per chunk iteration
        # in the scan transpose (gigabytes at bench size) — force the
        # safe unchunked configuration instead of running out of memory
        compaction_chunks = 1
    texels_flat = scene.atlas.texels.reshape(-1) if defer_tex else None
    bounce = functools.partial(
        _bounce_step, scene, nearest, depth_limit, defer_tex=defer_tex,
    )
    if differentiable:
        # rematerialize every bounce: backward recomputes traversal +
        # shading from the bounce's input state instead of saving the
        # shading intermediates — the classic remat trade
        raw_bounce = bounce

        def bounce(depth, s, tap_chunks=1):
            fn = lambda d_, s_: raw_bounce(d_, s_, tap_chunks=tap_chunks)
            return jax.checkpoint(fn)(depth, s)

    rays_traced = jnp.int32(r)
    state = bounce(0, state, tap_chunks=1 if defer_tex else compaction_chunks)
    if defer_tex:
        # full-width tap-factor application (a chunked lax.cond-skipping
        # variant pays per-chunk fixed costs twice under grad: the backward
        # replays every chunk)
        state["throughput"] = _apply_tap_factor(
            state["throughput"], texels_flat,
            *(state.pop(k) for k in _TAP_KEYS),
        )

    # Bounces 1..depth_limit as a scan over depth, each a scan over chunks:
    # `bounce` is traced exactly twice (full-width + chunk-width), keeping
    # the program small — a python-unrolled version took minutes to compile.
    chunk = r // compaction_chunks
    depth_body = _make_depth_body(
        scene, bounce, chunk, diff=differentiable, texels_flat=texels_flat
    )

    # d1-tap deferral: depth 1's tap records ride the cascade's entry
    # sort (6 extra permute lanes) and the factor applies on the compacted
    # tier HEAD, so the backward's atlas scatter runs at tier width, not
    # full width.  Exact: tap-carrying lanes are precisely the lanes
    # alive at depth 2, which the sort compacts into the head.
    d1_defer = (
        defer_tex
        and depth_limit >= 2
        and _os.environ.get("CRT_D1_TAP_DEFER", "1") != "0"
    )

    # Depth 1 runs at full width (typically >50% of paths survive the
    # primary hit); depths >= 2 go through the liveness cascade (see
    # _cascade).
    if depth_limit >= 1:
        body_d1 = (
            _make_depth_body(
                scene, bounce, chunk, diff=differentiable,
                texels_flat=texels_flat, apply_taps=False,
            )
            if d1_defer
            else depth_body
        )
        (state, rays_traced), _ = body_d1(
            (state, rays_traced), jnp.int32(1)
        )
    if depth_limit >= 2:
        state, rays_traced = _cascade(
            scene, state, rays_traced, jnp.arange(2, depth_limit + 1),
            chunk, depth_body, r, diff=differentiable,
            depth_body_first=_make_depth_body(
                scene, bounce, chunk, diff=differentiable,
                texels_flat=texels_flat, sort=False,
            ),
            texels_flat=texels_flat,
        )

    # terminated rays' d and throughput are frozen at termination time (dead
    # lanes are never mutated), so the deferred emissions need no separate
    # copies (see _RAY_KEYS note).  The light emission is a gather-free
    # multiply — full width.  The equirect sky gather is chunked like the
    # texel tap: compaction leaves absorbed/live rays clustered, so chunks
    # with no missed ray skip the random-access gather via lax.cond.
    def sky_contrib(missed, tp, d):
        sky_w = jnp.where(missed[..., None], tp, 0.0)
        return sky_w * query.sky_color(scene, d)

    radiance = jnp.where(
        state["lit"][..., None], state["throughput"] * scene.light_color, 0.0
    )
    # defer_tex keeps the sky OUTSIDE the chunk scan at full width
    if compaction_chunks > 1 and r % compaction_chunks == 0 and not defer_tex:
        ck = lambda x: x.reshape(compaction_chunks, r // compaction_chunks, *x.shape[1:])

        def sky_body(_, args):
            missed, tp, d = args
            out = jax.lax.cond(
                jnp.any(missed),
                lambda a: sky_contrib(*a),
                lambda a: jnp.zeros_like(a[1]),
                (missed, tp, d),
            )
            return None, out

        _, sky = jax.lax.scan(
            sky_body, None, (ck(state["missed"]), ck(state["throughput"]), ck(state["d"]))
        )
        radiance = radiance + sky.reshape(r, 3)
    else:
        radiance = radiance + sky_contrib(
            state["missed"], state["throughput"], state["d"]
        )
    # un-permute radiance to the caller's ray order: invert the
    # permutation with a ONE-LANE iota scatter and apply it as a gather,
    # inv[pixel[j]] = j  =>  out[i] = radiance[inv[i]].
    # traversed/tested stay in internal compaction order — every consumer
    # (traversal_summary) reduces them, which is permutation-invariant.
    # When no compaction sort ever ran (depth 0 or chunks == 1) `pixel` is
    # still the identity and the inverse is skipped outright.
    if depth_limit == 0 or compaction_chunks == 1:
        out = radiance
    else:
        # custom-vjp gather: backward re-applies the forward permutation
        # (`pixel`) instead of transposing into a random scatter
        out = _apply_perm(radiance, _inverse_perm(state["pixel"]), state["pixel"])
    return out, dict(
        rays_traced=rays_traced,
        traversed=state["traversed"],
        tested=state["tested"],
    )


def render_pass(
    scene: DeviceScene,
    camera: cam_mod.Camera,
    spp_index: jnp.ndarray,
    depth_limit: int = constants.DEPTH_LIMIT,
    differentiable: bool = False,
    samples_per_pass: int = 1,
):
    """One progressive pass: `samples_per_pass` jittered samples per pixel
    (3. PathTracer/renderer.cpp:117-131).  Returns (radiance [H, W, 3] =
    SUM of the pass's samples, stats).  `spp_index` salts the per-pixel RNG
    stream like the reference's `spp * 1799` tile seed; sample k of the
    megapass uses salt `spp_index + k`, so a 4-sample megapass at base b
    draws exactly the same per-sample streams as four 1-sample passes at
    b, b+1, b+2, b+3 — the estimator is unchanged, only batching differs.

    Why megabatch several samples: per-pass fixed costs amortize, and
    pixel-adjacent samples keep neighbouring rays coherent."""
    n = camera.width * camera.height
    s = samples_per_pass
    if s == 1:
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
        seeds = rng_mod.pixel_seeds(pixel_ids, spp_index)
        seeds, jx = rng_mod.random_float(seeds)
        seeds, jy = rng_mod.random_float(seeds)
        rays = cam_mod.full_frame_rays(camera, jitter_x=jx, jitter_y=jy)
        radiance, stats = sample_radiance(
            scene, rays.o, rays.d, seeds, depth_limit, differentiable=differentiable
        )
        return radiance.reshape(camera.height, camera.width, 3), stats

    # pixel-major layout: a pixel's s samples are ADJACENT
    pixel_ids = jnp.repeat(jnp.arange(n, dtype=jnp.uint32), s)
    sample_k = jnp.tile(jnp.arange(s, dtype=jnp.uint32), n)
    seeds = rng_mod.pixel_seeds(pixel_ids, jnp.asarray(spp_index, jnp.uint32) + sample_k)
    seeds, jx = rng_mod.random_float(seeds)
    seeds, jy = rng_mod.random_float(seeds)
    xs, ys = cam_mod.pixel_grid(camera)
    rays = cam_mod.primary_rays(
        camera, jnp.repeat(xs, s) + jx, jnp.repeat(ys, s) + jy
    )
    # keep the dead-chunk-skip granularity (chunk SIZE) equal to the 1-spp
    # configuration by scaling the chunk count with s
    c = _default_chunks() * s
    r = n * s
    chunks = _pick_chunks(r, c)
    radiance, stats = sample_radiance(
        scene,
        rays.o,
        rays.d,
        seeds,
        depth_limit,
        differentiable=differentiable,
        compaction_chunks=chunks,
    )
    radiance = radiance.reshape(n, s, 3).sum(axis=1)
    return radiance.reshape(camera.height, camera.width, 3), stats


render_pass_jit = jax.jit(
    render_pass,
    static_argnames=("depth_limit", "differentiable", "samples_per_pass"),
)
