"""Command-line renderer — the headless driver replacing the reference's
GLFW window main loop (template/template.cpp:83-359).

    python -m cpu_ray_tracer_tpu.cli --scene-xml assets/scenes/bunny_teapot.xml \
        --integrator pathtracer --spp 16 --width 640 --height 360 --out out.png
"""

from __future__ import annotations

import sys


def main(argv=None):
    from cpu_ray_tracer_tpu.utils.config import parse_args

    cfg = parse_args(argv)
    if not cfg.scene_xml:
        print("--scene-xml is required", file=sys.stderr)
        return 2

    import numpy as np

    from cpu_ray_tracer_tpu.core import film as film_mod
    from cpu_ray_tracer_tpu.utils import checkpoint as ckpt_mod
    from cpu_ray_tracer_tpu.utils import metrics as metrics_mod
    from cpu_ray_tracer_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    scene, info = cfg.build_scene()
    camera = cfg.build_camera()
    print(
        f"scene '{info.name}': {info.triangle_count} tris, "
        f"{info.object_count} objects, build {info.build_time_us} us, "
        f"max depth {info.max_tree_depth}, accel={cfg.accel} layout={cfg.layout}"
    )
    logger = metrics_mod.JsonlLogger(cfg.metrics_jsonl)

    if cfg.integrator == "basics":
        from cpu_ray_tracer_tpu.render import basics

        img = basics.render_jit(scene, camera, aov=cfg.aov)
    elif cfg.integrator == "whitted":
        from cpu_ray_tracer_tpu.render import whitted

        fm = metrics_mod.FrameMetrics(cfg.width, cfg.height)
        fm.start()
        if cfg.whitted_grow_cap:
            def on_grow(n_dropped, new_cf):
                print(
                    f"whitted: {n_dropped} secondary rays dropped; growing "
                    f"child-buffer cap_factor to {new_cf} and re-rendering",
                    file=sys.stderr,
                )

            out = whitted.render_adaptive(
                scene, camera, depth_limit=cfg.depth_limit,
                cap_factor=cfg.whitted_cap_factor, on_grow=on_grow,
            )
        else:
            out = whitted.render_jit(
                scene, camera, depth_limit=cfg.depth_limit,
                cap_factor=cfg.whitted_cap_factor,
            )
        out["image"].block_until_ready()
        timing = fm.stop()
        rec = dict(**timing, **metrics_mod.traversal_summary(out["traversed"], out["tested"]))
        n_dropped = int(out["dropped"])
        if n_dropped > 0:
            # silent child-buffer overflow would darken the image (biased
            # render) — surface it loudly and say how to fix it
            print(
                f"WARNING: {n_dropped} secondary rays dropped at the child-"
                f"buffer cap; image is biased (dark). Raise "
                f"--whitted-cap-factor (currently {cfg.whitted_cap_factor}; "
                f"dielectric-heavy scenes may need 2.0).",
                file=sys.stderr,
            )
            rec["dropped_rays"] = n_dropped
        print(rec)
        logger.log(rec)
        img = out["image"]
    else:
        from cpu_ray_tracer_tpu.render import progressive

        film = None
        if cfg.checkpoint:
            import os

            if os.path.exists(cfg.checkpoint):
                film, _ = ckpt_mod.load_film(cfg.checkpoint)
                print(f"resumed from {cfg.checkpoint} at spp={int(film.spp)}")
        if cfg.sharded:
            import jax

            from cpu_ray_tracer_tpu.parallel.mesh import make_mesh, replicate_scene
            from cpu_ray_tracer_tpu.parallel.sharded import sharded_render_pass

            mesh = make_mesh(cfg.n_devices or None)
            scene = replicate_scene(scene, mesh)
            run = sharded_render_pass(scene, camera, mesh)
            render_fn = lambda s, c, i: run(i)
        else:
            render_fn = None
        film = progressive.render_progressive(
            scene,
            camera,
            cfg.spp,
            depth_limit=cfg.depth_limit,
            film=film,
            checkpoint_path=cfg.checkpoint,
            checkpoint_every=cfg.checkpoint_every,
            logger=logger,
            render_fn=render_fn,
        )
        img = film.mean()
        print(f"energy: {float(film_mod.energy(img)):.1f} at spp={int(film.spp)}")

    u8 = np.asarray(film_mod.to_rgb8(img))
    film_mod.write_png(cfg.out, u8)
    print(f"wrote {cfg.out}")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
