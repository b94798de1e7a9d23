"""Forward+backward benchmark on one GPU.  Times `jax.value_and_grad` of the
differentiable path-trace loss on the bunny+teapot TLAS scene, gradients
w.r.t. the full parameter set (material table, texels, light color, triangle
vertices — diff/grad.py PARAM_KEYS).

Texel-gradient caveat (recorded in the output's `detail.texel_grads`): this
bench renders in the reference-parity NEAREST-tap mode, whose texel fetch
goes through the PACKED u32 atlas — an integer path that carries no
tangents, so the `texels` leaf receives zero gradient here.  Texture
learning uses bilinear mode (BENCH_BILINEAR=1, scene compile
`bilinear=True`), where texel gradients flow and are FD-validated; bilinear
diff runs with full compaction chunking too — the texel tap is deferred out
of the chunk scans (pathtracer._bounce_step defer_tex), so the scan
transposes never stack atlas cotangents.

Prints the card's name and power limit, then ONE JSON line like bench.py.
Rays counted = path segments of the forward pass (the backward pass
re-traverses the same segments via rematerialization; the metric is
forward-equivalent rays through fwd+bwd per second).  Fails without a GPU.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

WIDTH, HEIGHT = 1280, 720
STEPS = 16
DEPTH_LIMIT = 5  # the forward benchmark's own depth


def main():
    import jax
    import jax.numpy as jnp

    from cpu_ray_tracer_tpu.core import camera as cam_mod
    from cpu_ray_tracer_tpu.diff import grad as grad_mod
    from cpu_ray_tracer_tpu.render import pathtracer
    from cpu_ray_tracer_tpu.scene.build import compile_scene
    from cpu_ray_tracer_tpu.utils.metrics import runtime_flags
    from cpu_ray_tracer_tpu.utils.runtime import card_description, enable_compile_cache, require_gpu

    device = require_gpu()
    print(f"card: {card_description()}")
    enable_compile_cache()

    width = int(os.environ.get("BENCH_WIDTH", WIDTH))
    height = int(os.environ.get("BENCH_HEIGHT", HEIGHT))
    steps = int(os.environ.get("BENCH_STEPS", STEPS))
    depth_limit = int(os.environ.get("BENCH_DEPTH", DEPTH_LIMIT))
    out_path = os.environ.get("BENCH_OUT", "")
    # BENCH_BILINEAR=1: texture-LEARNING mode — bilinear taps through the
    # rank-1 custom-VJP texel gather (vecmath.gather_rows3), so the
    # `texels` leaf receives real gradients; optionally
    # BENCH_FD=1 validates the largest texel gradient against a central
    # finite difference at full bench scale.
    bilinear = os.environ.get("BENCH_BILINEAR", "0") == "1"
    run_fd = os.environ.get("BENCH_FD", "0") == "1"

    scene, info = compile_scene(
        os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml"),
        layout="tlas", bilinear=bilinear,
    )
    camera = cam_mod.make_camera(width, height, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
    params = grad_mod.extract_params(scene, keys=grad_mod.PARAM_KEYS)

    def loss_fn(params, scene, target, spp_index):
        s = grad_mod.apply_params(scene, params)
        img, stats = pathtracer.render_pass(
            s, camera, spp_index, depth_limit=depth_limit, differentiable=True
        )
        return grad_mod.l2_image_loss(img, target), stats["rays_traced"]

    @jax.jit
    def fwd_bwd(params, scene, target, spp_index, acc_loss, acc_rays):
        (loss, nrays), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, scene, target, spp_index
        )
        # accumulate the grad norm into the output so XLA cannot dead-code
        # the backward pass (a literal *0 would be constant-folded away)
        gnorm = sum(jnp.sum(g * g) for g in jax.tree.leaves(grads))
        return acc_loss + loss + gnorm, acc_rays + nrays.astype(jnp.float32)

    target = jnp.zeros((height, width, 3), jnp.float32)
    # compile + warm
    acc, nr = fwd_bwd(params, scene, target, jnp.uint32(0), jnp.float32(0.0), jnp.float32(0.0))
    jax.block_until_ready((acc, nr))

    acc = jnp.float32(0.0)
    nrays = jnp.float32(0.0)
    t0 = time.perf_counter()
    for p in range(steps):
        acc, nrays = fwd_bwd(params, scene, target, jnp.uint32(p + 1), acc, nrays)
    jax.block_until_ready(acc)
    dt = time.perf_counter() - t0

    total_rays = float(nrays)
    rays_per_s = total_rays / dt

    texel_note = "zero in this parity-tap mode; see module docstring"
    fd_detail = None
    if bilinear:
        grads_fn = jax.jit(jax.grad(lambda p, sc, tg, i: loss_fn(p, sc, tg, i)[0]))
        g = grads_fn(params, scene, target, jnp.uint32(1))
        g_tex = jax.device_get(g["texels"])
        import numpy as np

        texel_note = (
            f"bilinear: nonzero ({int((np.abs(g_tex) > 0).sum())} texel-channels), "
            f"max |g| {float(np.abs(g_tex).max()):.3e}"
        )
        if run_fd:
            flat = np.abs(g_tex).reshape(-1)
            idx = int(flat.argmax())
            eps = 0.05

            def loss_at(delta):
                p = dict(params)
                tex = p["texels"].reshape(-1).at[idx].add(delta).reshape(
                    p["texels"].shape
                )
                p = {**p, "texels": tex}
                l, _ = jax.jit(loss_fn)(p, scene, target, jnp.uint32(1))
                return float(l)

            fd = (loss_at(+eps) - loss_at(-eps)) / (2 * eps)
            an = float(g_tex.reshape(-1)[idx])
            fd_detail = {
                "texel_index": idx,
                "analytic": an,
                "finite_difference": fd,
                "rel_err": abs(an - fd) / max(abs(fd), 1e-12),
            }
    result = {
        "metric": "path_trace_fwdbwd_rays_per_s",
        "value": rays_per_s,
        "unit": "rays/s",
        "device": device,
        "detail": {
            "resolution": [width, height],
            "steps": steps,
            "depth_limit": depth_limit,
            "seconds": dt,
            "total_rays": total_rays,
            "triangles": info.triangle_count,
            "param_leaves": len(jax.tree.leaves(params)),
            "bilinear": bilinear,
            "texel_grads": texel_note,
            "texel_fd_check": fd_detail,
            **runtime_flags(),
        },
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
