"""On-card smoke test of the main path: the quickest proof that the system
runs on an NVIDIA GPU, and the check that the CUDA BVH walk answers what the
XLA walk answers.

    python chip_smoke.py                # one card: phases 1-6 below
    python chip_smoke.py --four-cards   # four cards: the sharded path only

Phases (each stops the run on failure; nothing is caught):
  1. require a GPU and print the card's name and power limit;
  2. compile the bunny+teapot bench scene (TLAS layout, 10,952 triangles),
     build the CUDA library, print the set-up times and the memory analysis
     of the compiled path-tracer pass;
  3. kernel vs XLA walk on three ray sets at 1280x720 (primary rays, one
     cosine-sampled bounce from the primary hits, shadow any-hit rays to
     the light), with both timings;
  4. render_pass at 1280x720, depth 5, 4 passes, with each walk;
  5. Whitted render_adaptive at 1024x640 with each walk, and the cube
     golden (tests/goldens/whitted_cube_48x32.npy, the scalar oracle's
     image) on the card;
  6. one diff.optimize train step at 256x144 with bilinear taps, with each
     walk.
--four-cards instead runs the sharded render (parallel/sharded.py) and the
psum train step (diff/optimize.py) on a 1-D `rays` mesh of 4 cards, each
compared with the same computation on one card.

Times are host-clock times around work that ends in block_until_ready, after
a warm-up call that compiles; they are first readings, not the benchmark.
The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_XML = os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml")
CUBE_XML = os.path.join(REPO, "assets", "scenes", "cube_scene.xml")
CUBE_GOLDEN = os.path.join(REPO, "tests", "goldens", "whitted_cube_48x32.npy")
BENCH_CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))

# Agreement limits between the kernel and the XLA walk.  nvcc and XLA may
# contract multiply-adds into FMAs differently, so t may differ in its last
# bits and a ray that grazes two triangles at (nearly) the same t may pick
# either: such a near-tie is the only allowed disagreement.  On a grazing
# hit the Möller–Trumbore determinant (or the t numerator) is a sum of
# products that cancels, and a last-bit difference in its terms grows by
# the cancellation factor kappa; there the t limit widens to
# T_RTOL + 8 * 2**-23 * kappa (hit_condition), and the run reports how many
# rays needed it.
T_RTOL = 1e-5
MIN_AGREE = 0.9999
ENERGY_RTOL = 1e-3
GRAD_RTOL = 1e-4


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed(fn, *args, reps=3):
    """(compile+first-call seconds, [seconds of each further call]); every
    call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, times


def ms(times):
    return f"median {1e3 * float(np.median(times)):.3f} ms over {len(times)} ({', '.join(f'{1e3 * t:.3f}' for t in times)})"


def variants(scene):
    """The two traversal implementations as scene variants."""
    return {"kernel": scene.replace(traversal="auto"), "xla": scene.replace(traversal="xla")}


def bench_scene(bilinear=False):
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    return compile_scene(BENCH_XML, layout="tlas", bilinear=bilinear)


def phase_setup(width, height):
    """Phase 2: scene compile, kernel build, memory analysis of the pass."""
    import jax

    from cpu_ray_tracer_tpu.accel import native
    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.ops import bvh_kernel
    from cpu_ray_tracer_tpu.render import pathtracer

    t0 = time.perf_counter()
    scene, info = bench_scene()
    compile_s = time.perf_counter() - t0
    print(
        f"[setup] scene '{info.name}': {info.triangle_count} triangles, "
        f"{int(scene.bvh.num_nodes)} BVH nodes, compiled in {compile_s:.3f} s; "
        f"native builder loaded: {native.get_lib() is not None}"
    )
    check(info.triangle_count == 10952, f"bench scene has {info.triangle_count} triangles, not 10952")
    if jax.devices()[0].platform == "gpu":
        build = bvh_kernel.ensure_registered()
        print(f"[setup] CUDA BVH walk: {build}")
    camera = cam_mod.make_camera(width, height, **BENCH_CAMERA)
    lowered = pathtracer.render_pass_jit.lower(scene, camera, np.uint32(0))
    mem = lowered.compile().memory_analysis()
    print(f"[setup] render_pass {width}x{height} memory analysis: {mem}")
    return scene, camera


def ray_sets(scene, camera):
    """Primary rays, one cosine-sampled bounce from the primary hits, and
    shadow rays from the primary hits to the light, as (o, d, t0, any_hit)
    with t0 = -1 on rays whose primary ray hit nothing."""
    import jax
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu import constants
    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.core import rng as rng_mod
    from cpu_ray_tracer_tpu.render import common
    from cpu_ray_tracer_tpu.scene import query

    @jax.jit
    def make(scene):
        ref = scene.replace(traversal="xla")
        rays = cam_mod.full_frame_rays(camera)
        o, d = rays.o, rays.d
        r = o.shape[0]
        far = jnp.full((r,), constants.RAY_FAR, jnp.float32)
        hit = query.find_nearest(ref, o, d)
        live = hit["obj_idx"] >= 0
        p = o + hit["t"][:, None] * d
        normal, _, _ = query.get_hit_info(ref, hit, p, d)
        seeds = rng_mod.pixel_seeds(jnp.arange(r, dtype=jnp.uint32), 7)
        seeds, r1 = rng_mod.random_float(seeds)
        _, r2 = rng_mod.random_float(seeds)
        tb, bt = common.orthonormal_basis(normal)
        rad, phi = jnp.sqrt(r1), 2.0 * np.pi * r2
        bd = (
            tb * (rad * jnp.cos(phi))[:, None]
            + bt * (rad * jnp.sin(phi))[:, None]
            + normal * jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))[:, None]
        )
        bo = p + bd * constants.SHADE_EPS
        lp = query.get_light_pos(scene)
        to_l = lp - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        sd = to_l / jnp.maximum(dist, 1e-20)[:, None]
        so = p + sd * constants.SHADE_EPS
        dead = np.float32(-1.0)
        return {
            "primary": (o, d, far),
            "bounce": (bo, bd, jnp.where(live, far, dead)),
            "shadow": (so, sd, jnp.where(live, dist - 2 * constants.SHADE_EPS, dead)),
        }

    any_hit = {"primary": False, "bounce": False, "shadow": True}
    return {k: (*v, any_hit[k]) for k, v in make(scene).items()}


def hit_condition(o, d, tris, tri):
    """Cancellation factor kappa of the Möller–Trumbore solve per ray for
    triangle `tri` (0 where tri < 0): |x||y| / |x . y| summed over the
    determinant e1 . (d x e2) and the largest of the u, v and t numerators,
    in float64 from the float32 inputs.  A last-bit difference in the terms
    of such a dot product moves its value by about kappa ulps."""
    idx = np.maximum(tri, 0)
    v0, e1, e2 = (np.asarray(x, np.float64)[idx] for x in (tris.v0, tris.e1, tris.e2))
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)

    def cancel(x, y):
        dot = np.abs(np.sum(x * y, -1))
        return np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1) / np.maximum(dot, 1e-300)

    h = np.cross(d, e2)
    s = o - v0
    q = np.cross(s, e1)
    kappa = cancel(e1, h) + np.maximum(np.maximum(cancel(s, h), cancel(d, q)), cancel(e2, q))
    return np.where(tri >= 0, kappa, 0.0)


def walk_limits(o, d, tris, tri_a, tri_b):
    """Per-ray limits for comparing two walks: (relative t limit, absolute
    barycentric limit) = T_RTOL + 8 * 2**-23 * kappa over both hits."""
    kappa = np.maximum(hit_condition(o, d, tris, tri_a), hit_condition(o, d, tris, tri_b))
    widen = 8 * 2.0**-23 * kappa
    return T_RTOL + widen, T_RTOL + widen


def compare_walks(name, ref, got, any_hit, o, d, tris):
    """Kernel vs XLA walk on one ray set (numpy dicts).  Closest-hit: t
    within the limit on every ray (so a tri_idx disagreement can only be a
    near-tie) and tri_idx equal on MIN_AGREE of the rays.  Any-hit: the
    occlusion flags equal on MIN_AGREE of the rays, and t within the limit
    where both walks stopped on the same triangle (any-hit t is the first
    hit found, not the nearest).  Returns (agreement, worst t rel diff,
    rays whose diff exceeded T_RTOL but not their widened limit)."""
    t_r, t_k = ref["t"], got["t"]
    check(bool(np.isfinite(t_k).all()), f"{name}: non-finite t")
    rel = np.abs(t_k - t_r) / np.maximum(np.abs(t_r), 1e-30)
    limit, _ = walk_limits(o, d, tris, ref["tri_idx"], got["tri_idx"])
    same = ref["tri_idx"] == got["tri_idx"]
    if any_hit:
        agree = float(np.mean((ref["tri_idx"] >= 0) == (got["tri_idx"] >= 0)))
        rel, limit = rel[same], limit[same]
    else:
        agree = float(np.mean(same))
    bad = rel > limit
    worst = float(rel.max()) if rel.size else 0.0
    check(not bad.any(), f"{name}: t differs beyond its limit on {int(bad.sum())} rays (worst relative {worst:.3g})")
    check(agree >= MIN_AGREE, f"{name}: {'any-hit flags' if any_hit else 'tri_idx'} agree on {agree:.6f} of rays")
    return agree, worst, int((rel > T_RTOL).sum())


def phase_walks(scene, camera, reps=5):
    """Phase 3: kernel vs XLA walk on the three ray sets."""
    import jax

    from cpu_ray_tracer_tpu.scene import query

    sets = ray_sets(scene, camera)
    scenes = variants(scene)
    for name, (o, d, t0, any_hit) in sets.items():
        out = {}
        for impl, sc in scenes.items():
            fn = jax.jit(lambda sc, o, d, t0, a=any_hit: query.walk_bvh(sc, sc.bvh, sc.tris, o, d, t0, any_hit=a))
            res, first, times = timed(fn, sc, o, d, t0, reps=reps)
            out[impl] = {k: np.asarray(v) for k, v in res.items()}
            print(f"[walk] {name:8s} {impl:6s} {o.shape[0]} rays: first call {first:.3f} s, {ms(times)}")
        agree, worst, widened = compare_walks(
            name, out["xla"], out["kernel"], any_hit, np.asarray(o), np.asarray(d), scene.tris
        )
        hits = int((out["xla"]["tri_idx"] >= 0).sum())
        print(
            f"[walk] {name:8s} agreement {agree:.6f}, worst t rel diff {worst:.3g} "
            f"({widened} grazing rays past {T_RTOL}, within their limit), {hits} triangle hits"
        )


def phase_pathtrace(scene, camera, passes=4):
    """Phase 4: render_pass with each walk, energies compared."""
    import jax
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.render import pathtracer

    energy = {}
    for impl, sc in variants(scene).items():
        t0 = time.perf_counter()
        jax.block_until_ready(pathtracer.render_pass_jit(sc, camera, jnp.uint32(0)))
        first = time.perf_counter() - t0
        film = jnp.zeros((camera.height, camera.width, 3), jnp.float32)
        nrays = jnp.int32(0)
        t0 = time.perf_counter()
        for p in range(passes):
            img, stats = pathtracer.render_pass_jit(sc, camera, jnp.uint32(p))
            film, nrays = film + img, nrays + stats["rays_traced"]
        film = jax.block_until_ready(film)
        dt = time.perf_counter() - t0
        img = np.asarray(film)
        check(np.isfinite(img).all(), f"pathtracer/{impl}: non-finite pixels")
        energy[impl] = float(img.astype(np.float64).sum())
        print(
            f"[pt] {impl:6s} {camera.width}x{camera.height} x {passes} passes: first pass "
            f"{first:.3f} s, {passes} passes {dt:.3f} s, {int(nrays)} rays, "
            f"{int(nrays) / dt:.6g} rays/s (first reading), energy {energy[impl]:.6g}"
        )
    rel = abs(energy["kernel"] - energy["xla"]) / max(abs(energy["xla"]), 1e-30)
    check(rel <= ENERGY_RTOL, f"pathtracer: energy differs by {rel:.3g} relative (limit {ENERGY_RTOL})")
    print(f"[pt] energy relative difference {rel:.3g}")


def phase_whitted(scene, width, height, golden=True):
    """Phase 5: Whitted frames with each walk, and the cube golden."""
    import jax

    from cpu_ray_tracer_tpu import constants
    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.render import whitted
    from cpu_ray_tracer_tpu.scene.build import compile_scene

    camera = cam_mod.make_camera(width, height, **BENCH_CAMERA)
    energy = {}
    for impl, sc in variants(scene).items():
        t0 = time.perf_counter()
        out = whitted.render_adaptive(sc, camera)
        img = np.asarray(jax.block_until_ready(out["image"]))
        first = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(
                whitted.render_jit(
                    sc, camera, depth_limit=constants.DEPTH_LIMIT,
                    cap_factor=out["cap_factor"], differentiable=False,
                )["image"]
            )
            times.append(time.perf_counter() - t0)
        check(np.isfinite(img).all(), f"whitted/{impl}: non-finite pixels")
        energy[impl] = float(img.astype(np.float64).sum())
        print(
            f"[whitted] {impl:6s} {width}x{height}: first frame {first:.3f} s, "
            f"{ms(times)}, cap_factor {out['cap_factor']}, energy {energy[impl]:.6g}"
        )
    rel = abs(energy["kernel"] - energy["xla"]) / max(abs(energy["xla"]), 1e-30)
    check(rel <= ENERGY_RTOL, f"whitted: energy differs by {rel:.3g} relative (limit {ENERGY_RTOL})")
    print(f"[whitted] energy relative difference {rel:.3g}")
    if golden:
        cube, _ = compile_scene(CUBE_XML, layout="tlas")
        cam = cam_mod.make_camera(48, 32)
        img = np.asarray(whitted.render_jit(cube, cam)["image"])
        want = np.load(CUBE_GOLDEN)
        edge = floor_texel_edges(cube, cam)
        check(edge.mean() <= 0.3, f"cube golden: {int(edge.sum())} texel-edge pixels")
        err = np.abs(img - want).max(axis=-1)
        # the golden test's own tolerance (tests/test_goldens.py)
        bad = (err > 2e-3 + 1e-3 * np.abs(want).max(axis=-1)) & ~edge
        check(not bad.any(), f"cube golden: {int(bad.sum())} pixels off, max error {err[~edge].max():.3g}")
        print(
            f"[whitted] cube golden 48x32 matches the oracle image on the {int((~edge).sum())} pixels "
            f"off texel edges (max abs error {err[~edge].max():.3g}); {int((err[edge] > 2e-3).sum())} "
            f"of the {int(edge.sum())} edge pixels took the neighbouring texel"
        )


def floor_texel_edges(scene, camera):
    """Pixels whose primary ray (in float64, as the reference's camera
    defines it) hits the floor within 1e-3 texel of a texel edge.  The cube
    golden's camera puts many floor hits exactly on edges, where a one-ulp
    change of the ray (a fused multiply-add, a reciprocal in place of a
    division) picks the neighbouring texel; such a pixel proves nothing
    about the renderer's precision, so the golden check skips it."""
    w, h = camera.width, camera.height
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    tl, tr, bl, pos = (np.asarray(x, np.float64) for x in (camera.top_left, camera.top_right, camera.bottom_left, camera.pos))
    p = tl + (xs / w)[..., None] * (tr - tl) + (ys / h)[..., None] * (bl - tl)
    d = p - pos
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -(pos[1] + 1.0) / d[..., 1]  # floor plane y = -1 (query.FLOOR_D)
        q = pos + t[..., None] * d
        tex_w = float(np.asarray(scene.atlas.width)[0])  # texture 0 is the floor's
        s = q[..., [0, 2]] * float(scene.floor_inv_to) * tex_w
        return (t > 0) & (np.abs(s - np.round(s)) < 1e-3).any(axis=-1)


def _grads_close(a, b):
    """Relative tolerance GRAD_RTOL; entries below GRAD_RTOL of the leaf's
    largest magnitude are compared against that floor instead."""
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        floor = GRAD_RTOL * float(np.abs(x).max() or 1.0)
        bad = np.abs(x - y) > GRAD_RTOL * np.abs(x) + floor
        check(not bad.any(), f"grad {k}: {int(bad.sum())} of {x.size} entries differ beyond rtol {GRAD_RTOL}")


def _keep_grads(inner):
    """An optimizer that applies `inner` and keeps the last gradients in
    its state, so one train step yields the grads it applied."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    return optax.GradientTransformation(init, update)


def _train_inputs(width, height):
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.diff import grad as grad_mod

    scene, _ = bench_scene(bilinear=True)
    camera = cam_mod.make_camera(width, height, **BENCH_CAMERA)
    target = jnp.full((height, width, 3), 0.25, jnp.float32)
    params = grad_mod.extract_params(scene, keys=("albedo", "texels", "light_color"))
    return scene, camera, target, params


def phase_train(width, height):
    """Phase 6: one train step with bilinear taps, with each walk."""
    import jax
    import optax

    from cpu_ray_tracer_tpu.diff import optimize

    scene, camera, target, params = _train_inputs(width, height)
    grads = {}
    for impl, sc in variants(scene).items():
        opt = _keep_grads(optax.adam(1e-2))
        step = optimize.make_train_step(sc, camera, target, opt)
        state = opt.init(params)
        (new_params, (_, g), loss), first, times = timed(step, params, state, np.uint32(0), reps=3)
        check(np.isfinite(float(loss)), f"train/{impl}: loss {float(loss)}")
        check(all(np.isfinite(np.asarray(v)).all() for v in new_params.values()), f"train/{impl}: non-finite params")
        grads[impl] = {k: np.asarray(v) for k, v in g.items()}
        print(
            f"[train] {impl:6s} {width}x{height}: first step (compile+run) {first:.3f} s, "
            f"step {ms(times)}, loss {float(loss):.6g}"
        )
    _grads_close(grads["xla"], grads["kernel"])
    print("[train] grads agree between the walks")


def phase_four_cards(width, height, n_devices=4):
    """The multi-card path: sharded render and psum train step on a 1-D
    `rays` mesh, each compared with the same computation on one device."""
    import jax
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.core import rng as rng_mod
    from cpu_ray_tracer_tpu.diff import optimize
    from cpu_ray_tracer_tpu.parallel import mesh as mesh_mod
    from cpu_ray_tracer_tpu.parallel import sharded
    from cpu_ray_tracer_tpu.render import pathtracer

    check(len(jax.devices()) >= n_devices, f"need {n_devices} devices, JAX has {len(jax.devices())}")
    mesh = mesh_mod.make_mesh(n_devices)
    scene, _ = bench_scene()
    camera = cam_mod.make_camera(width, height, **BENCH_CAMERA)

    run = sharded.sharded_render_pass(mesh_mod.replicate_scene(scene, mesh), camera, mesh)
    img4, first, times = timed(run, jnp.uint32(0), reps=3)
    print(f"[4 cards] sharded render {width}x{height}: first call {first:.3f} s, {ms(times)}")

    @jax.jit
    def single(scene, spp):
        n = camera.width * camera.height
        seeds = rng_mod.pixel_seeds(jnp.arange(n, dtype=jnp.uint32), spp)
        seeds, jx = rng_mod.random_float(seeds)
        seeds, jy = rng_mod.random_float(seeds)
        rays = cam_mod.full_frame_rays(camera, jitter_x=jx, jitter_y=jy)
        rad, _ = pathtracer.sample_radiance(scene, rays.o, rays.d, seeds)
        return rad.reshape(camera.height, camera.width, 3)

    img1, first1, times1 = timed(single, scene, jnp.uint32(0), reps=3)
    print(f"[4 cards] same pass on one device: first call {first1:.3f} s, {ms(times1)}")
    a, b = np.asarray(img4), np.asarray(img1)
    check(np.isfinite(a).all(), "sharded render: non-finite pixels")
    rel = abs(a.sum() - b.sum()) / max(abs(float(b.sum())), 1e-30)
    check(rel <= ENERGY_RTOL, f"sharded render: energy differs by {rel:.3g} relative")
    print(f"[4 cards] sharded vs one device: energy relative difference {rel:.3g}, max pixel diff {np.abs(a - b).max():.3g}")

    t_scene, t_camera, target, params = _train_inputs(width // 4, height // 4)
    vg4 = jax.jit(optimize.make_sharded_value_and_grad(
        mesh_mod.replicate_scene(t_scene, mesh), t_camera, target, mesh)(params))
    (loss4, g4), first4, times4 = timed(vg4, params, np.uint32(0), reps=3)
    vg1 = jax.jit(optimize.make_value_and_grad(t_scene, t_camera, target))
    (loss1, g1), _, times1 = timed(vg1, params, np.uint32(0), reps=3)
    check(np.isfinite(float(loss4)), f"sharded train step: loss {float(loss4)}")
    lrel = abs(float(loss4) - float(loss1)) / max(abs(float(loss1)), 1e-30)
    check(lrel <= GRAD_RTOL, f"sharded loss differs by {lrel:.3g} relative")
    _grads_close({k: np.asarray(v) for k, v in g1.items()}, {k: np.asarray(v) for k, v in g4.items()})
    print(
        f"[4 cards] psum train step {t_camera.width}x{t_camera.height}: {ms(times4)} "
        f"(one device {ms(times1)}); loss {float(loss4):.6g} vs {float(loss1):.6g}; grads agree"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded render and train step")
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    from cpu_ray_tracer_tpu.utils.runtime import card_description, enable_compile_cache, require_gpu

    device = require_gpu()
    print(f"[card] {card_description()}")
    print(f"[device] {device}; compile cache {enable_compile_cache()}")
    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards(1280, 720)
    else:
        scene, camera = phase_setup(1280, 720)
        phase_walks(scene, camera)
        phase_pathtrace(scene, camera)
        phase_whitted(scene, 1024, 640)
        phase_train(256, 144)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
