"""Host-side scene compiler: XML spec -> DeviceScene.

This is the device-side replacement for the whole reference `Init()` stack
(SURVEY.md §3.1): it parses the XML, loads models/textures, transforms
geometry, builds acceleration structures and emits flat device arrays.  It
runs once per scene (and per transform change), so it lives in numpy.

Two layouts, mirroring the reference's two XML scene classes:

* `layout="mono"` — FileScene (infra/scene/file_scene.cpp): every object's
  triangles pre-transformed by the FULL TRS matrix and merged into ONE
  accelerator.  Reference quirk kept in parity mode: vertex normals are
  transformed with the rotation-transpose of the full TRS (the reference's
  `FastInvertedTransformNoScale` misuse, model.cpp:57 + :70-72).
* `layout="tlas"` — TLASFileScene (infra/scene/tlas_file_scene.cpp): one BLAS
  per object (scale baked into verts, rigid T separate), TLAS on top.
  Twist for batched traversal: BLAS triangles and node AABBs are baked to WORLD space
  (conservative 8-corner AABB transform), and TLAS interior nodes + all BLAS
  nodes are fused into one threaded node forest.  Traversal then needs no
  per-ray transform or mode switch — one cursor, one link table.  The cost is
  slightly fatter interior boxes and per-instance node copies; transforms
  changing per frame re-bake only the affected instance (host-side,
  vectorized numpy).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.accel import bvh_builder, tlas_builder
from cpu_ray_tracer_tpu.accel.compile import make_triangle_pool
from cpu_ray_tracer_tpu.accel.types import BVHArrays, BuildStats, to_device_f32, to_device_i32
from cpu_ray_tracer_tpu.core import vecmath as vm
from cpu_ray_tracer_tpu.core.materials import make_table
from cpu_ray_tracer_tpu.core.textures import build_atlas
from cpu_ray_tracer_tpu.io.image import load_texture_image
from cpu_ray_tracer_tpu.io.obj import load_obj
from cpu_ray_tracer_tpu.io.scene_xml import SceneSpec, load_scene_xml, resolve_asset
from cpu_ray_tracer_tpu.scene.types import DeviceScene, SceneInfo

DEG2RAD = np.float32(np.pi / 180.0)


def _object_matrices(obj):
    t = (
        vm.mat_translate(obj.position)
        @ vm.mat_rotate_x(float(obj.rotation[0]) * DEG2RAD)
        @ vm.mat_rotate_y(float(obj.rotation[1]) * DEG2RAD)
        @ vm.mat_rotate_z(float(obj.rotation[2]) * DEG2RAD)
    )
    s = vm.mat_scale(tuple(obj.scale))
    return t, s


def _transform_aabb(bmin, bmax, t):
    """Conservative world AABB of a transformed box (8 corners), the same
    math as BLASBVH::SetTransform (blas_bvh.cpp:363-374)."""
    corners = np.array(
        [
            [bmin[0] if not (i & 1) else bmax[0],
             bmin[1] if not (i & 2) else bmax[1],
             bmin[2] if not (i & 4) else bmax[2]]
            for i in range(8)
        ],
        np.float32,
    )
    world = corners @ t[:3, :3].T + t[:3, 3]
    return world.min(axis=0), world.max(axis=0)


def compile_scene(
    xml_path: str | None = None,
    spec: SceneSpec | None = None,
    layout: str = "tlas",
    accel: str = "bvh",
    parity: bool = False,
    bilinear: bool = False,
    force_split_cap: int | None = 4,
    shadow_quirk: bool = True,
    leaf_target: int | None = None,
    instancing: str = "baked",
) -> tuple[DeviceScene, SceneInfo]:
    """`layout` picks FileScene ("mono") vs TLASFileScene ("tlas") semantics;
    `accel` picks the structure (USE_BVH / USE_Grid / USE_KDTree).  For
    layout="tlas" with grid/kdtree, one grid/KD tree is built per instance
    over its world-baked triangles and traversal chains the instances with a
    shared running t — the batched equivalent of the reference's TLASGrid /
    TLASKDTree (infra/tlas_grid.cpp:17-111, infra/tlas_kdtree.cpp:17-111,
    byte-identical clones of TLASBVH over different BLAS types).

    `instancing` (layout="tlas" + accel="bvh" only): "baked" fuses
    world-baked per-instance BVHs into one threaded forest (the default,
    fastest traversal); "shared" keeps ONE object-space BLAS per unique
    mesh and transforms rays per instance at query time — the reference's
    BLASBVH object-space semantics (blas_bvh.cpp:376-389) with O(1)
    SetTransform and N instances sharing one BLAS's memory."""
    if spec is None:
        spec = load_scene_xml(xml_path)
    xml_dir = spec.xml_dir
    if parity:
        force_split_cap = None

    # ---- textures ----------------------------------------------------
    images = []

    def add_tex(path_str: str) -> int:
        img = load_texture_image(resolve_asset(path_str, xml_dir), keep_float=bilinear)
        images.append(img)
        return len(images) - 1

    floor_tex = add_tex(spec.plane_texture_location)
    mat_tex_ids = []
    for m in spec.materials:
        mat_tex_ids.append(add_tex(m.texture_location) if m.texture_location else -1)
    skydome_tex = add_tex(spec.skydome_location)
    atlas = build_atlas(images)
    floor_tex_width = images[floor_tex].shape[1]

    # ---- materials ----------------------------------------------------
    rows = [
        {"is_light": True},  # slot 0: light quad (primitiveMaterials[0])
        {"tex_id": floor_tex},  # slot 1: floor plane
    ]
    for m, tid in zip(spec.materials, mat_tex_ids):
        rows.append(
            {
                "reflectivity": m.reflectivity,
                "refractivity": m.refractivity,
                "absorption": tuple(m.absorption),
                "tex_id": tid,
            }
        )
    rows.append({"albedo": (255 / 255.0, 192 / 255.0, 203 / 255.0)})  # error pink
    materials = make_table(rows)

    # ---- geometry ------------------------------------------------------
    mesh_cache: dict[str, object] = {}

    def get_mesh(path_str: str):
        path = resolve_asset(path_str, xml_dir)
        if path not in mesh_cache:
            mesh_cache[path] = load_obj(path)
        return mesh_cache[path]

    if instancing == "shared":
        if layout != "tlas" or accel != "bvh":
            raise ValueError(
                "instancing='shared' requires layout='tlas' and accel='bvh'"
            )
        pool, bvh, shared, info = _build_shared_instances(
            spec, get_mesh, force_split_cap, leaf_target
        )
        light_t = vm.mat_translate(tuple(spec.light_pos))
        light_inv_t = vm.mat_inverted_no_scale(light_t)
        scene = DeviceScene(
            tris=pool,
            bvh=bvh,
            materials=materials,
            atlas=atlas,
            light_t=to_device_f32(light_t),
            light_inv_t=to_device_f32(light_inv_t),
            light_size=jnp.float32(0.5),
            light_color=to_device_f32(np.array([24.0, 24.0, 22.0], np.float32)),
            floor_inv_to=jnp.float32(100.0 / floor_tex_width),
            accel_kind=accel,
            skydome_tex=skydome_tex,
            bilinear=bilinear,
            shadow_quirk=shadow_quirk,
            shared=shared,
        )
        return scene, info

    inst_v, inst_n, inst_uv, inst_obj, inst_mat = [], [], [], [], []
    for i, obj in enumerate(spec.objects):
        mesh = get_mesh(obj.model_location)
        v, n, uv = mesh.triangles()  # [F,3,3], [F,3,3], [F,3,2]
        t, s = _object_matrices(obj)
        if layout == "mono":
            full = t @ s
            wv = v @ full[:3, :3].T + full[:3, 3]
            rot = full[:3, :3].T if parity else np.linalg.inv(full[:3, :3]).T
            wn = n @ rot.T
            nz = np.linalg.norm(wn, axis=-1, keepdims=True)
            wn = wn / np.maximum(nz, 1e-20)
        else:
            # scale baked into object verts, then rigid world transform
            ov = v * obj.scale[None, None, :]
            wv = ov @ t[:3, :3].T + t[:3, 3]
            # normals: raw object normals rotated by T (blas_bvh.cpp:391-398;
            # scale intentionally NOT applied, as in the reference)
            wn = n @ t[:3, :3].T
        f = v.shape[0]
        inst_v.append(wv.astype(np.float32))
        inst_n.append(wn.astype(np.float32))
        inst_uv.append(uv.astype(np.float32))
        inst_obj.append(np.full((f,), 2 + i, np.int32))
        inst_mat.append(np.full((f,), 2 + obj.material_idx, np.int32))

    all_v = np.concatenate(inst_v, axis=0)
    pool = make_triangle_pool(
        all_v,
        np.concatenate(inst_n, axis=0),
        np.concatenate(inst_uv, axis=0),
        np.concatenate(inst_obj, axis=0),
        np.concatenate(inst_mat, axis=0),
    )

    # ---- acceleration structure ----------------------------------------
    grid_arr = None
    kd_arr = None
    if layout == "mono":
        host, idx, stats = bvh_builder.build_bvh(
            all_v, force_split_cap=force_split_cap, leaf_target=leaf_target
        )
        hit, miss = bvh_builder.thread_links(host.left, host.right, host.tri_count, host.axis)
        bvh = BVHArrays(
            node_min=to_device_f32(host.node_min),
            node_max=to_device_f32(host.node_max),
            left_first=to_device_i32(host.left_first),
            tri_count=to_device_i32(host.tri_count),
            hit_link=to_device_i32(hit),
            miss_link=to_device_i32(miss),
            tri_indices=to_device_i32(idx),
            max_leaf=stats.max_leaf,
            max_depth=stats.max_depth,
        )
        info = SceneInfo(
            name=spec.name,
            triangle_count=int(all_v.shape[0]),
            object_count=len(spec.objects),
            build_stats=stats,
        )
        if accel == "grid":
            from cpu_ray_tracer_tpu.accel import grid_builder

            ghost, gstats = grid_builder.build_grid(all_v)
            grid_arr = grid_builder.to_device(ghost)
            info.build_stats = gstats
        elif accel == "kdtree":
            from cpu_ray_tracer_tpu.accel import kdtree_builder

            khost, kstats = kdtree_builder.build_kdtree(all_v)
            kd_arr = kdtree_builder.to_device(khost)
            info.build_stats = kstats
    else:
        bvh, stats, blas_stats = _build_unified_tlas(
            inst_v, force_split_cap, leaf_target
        )
        info = SceneInfo(
            name=spec.name,
            triangle_count=int(all_v.shape[0]),
            object_count=len(spec.objects),
            build_stats=stats,
            blas_stats=blas_stats,
        )
        if accel == "grid":
            from cpu_ray_tracer_tpu.accel import grid_builder

            grids, tri_base = [], 0
            for v in inst_v:
                ghost, gstats = grid_builder.build_grid(v)
                ghost["cell_tris"] = ghost["cell_tris"] + tri_base
                grids.append(grid_builder.to_device(ghost))
                tri_base += v.shape[0]
            grid_arr = tuple(grids)
        elif accel == "kdtree":
            from cpu_ray_tracer_tpu.accel import kdtree_builder

            kds, tri_base = [], 0
            for v in inst_v:
                khost, kstats = kdtree_builder.build_kdtree(v)
                khost["tri_ids"] = khost["tri_ids"] + tri_base
                kds.append(kdtree_builder.to_device(khost))
                tri_base += v.shape[0]
            kd_arr = tuple(kds)

    # ---- light / floor ---------------------------------------------------
    light_t = vm.mat_translate(tuple(spec.light_pos))
    light_inv_t = vm.mat_inverted_no_scale(light_t)

    scene = DeviceScene(
        tris=pool,
        bvh=bvh,
        materials=materials,
        atlas=atlas,
        light_t=to_device_f32(light_t),
        light_inv_t=to_device_f32(light_inv_t),
        light_size=jnp.float32(0.5),
        light_color=to_device_f32(np.array([24.0, 24.0, 22.0], np.float32)),
        floor_inv_to=jnp.float32(100.0 / floor_tex_width),
        accel_kind=accel,
        skydome_tex=skydome_tex,
        bilinear=bilinear,
        shadow_quirk=shadow_quirk,
        grid=grid_arr,
        kd=kd_arr,
    )
    return scene, info


def instance_matrices(obj):
    """Full TRS matrix + inverse + normal (inverse-transpose) matrix for a
    scene object — the shared-instancing analog of BLASBVH::SetTransform
    (blas_bvh.cpp:363-374), but O(1): no node re-bake, just three small
    host matrices."""
    t, s = _object_matrices(obj)
    m = (t @ s).astype(np.float32)
    minv = np.linalg.inv(m).astype(np.float32)
    nrm = np.linalg.inv(m[:3, :3]).T.astype(np.float32)
    return m, minv, nrm


def _build_shared_instances(spec, get_mesh, force_split_cap, leaf_target):
    """One object-space BLAS per UNIQUE mesh + per-instance transform
    tables (see SharedInstances docstring, scene/types.py)."""
    from cpu_ray_tracer_tpu.scene.types import SharedInstances

    key_to_slot: dict[str, int] = {}
    inst_mesh = []
    for obj in spec.objects:
        k = obj.model_location
        if k not in key_to_slot:
            key_to_slot[k] = len(key_to_slot)
        inst_mesh.append(key_to_slot[k])
    slot_loc = {s: k for k, s in key_to_slot.items()}
    n_mesh = len(key_to_slot)

    # --- unique meshes: raw object-space geometry + one BVH each ---------
    mesh_v, mesh_n, mesh_uv, hosts, idxs, stats_all = [], [], [], [], [], []
    tri_bases, tri_base = [], 0
    for s in range(n_mesh):
        v, n, uv = get_mesh(slot_loc[s]).triangles()
        v = v.astype(np.float32)
        host, idx, stats = bvh_builder.build_bvh(
            v, force_split_cap=force_split_cap, leaf_target=leaf_target
        )
        mesh_v.append(v)
        mesh_n.append(n.astype(np.float32))
        mesh_uv.append(uv.astype(np.float32))
        hosts.append(host)
        idxs.append(idx)
        stats_all.append(stats)
        tri_bases.append(tri_base)
        tri_base += v.shape[0]

    all_v = np.concatenate(mesh_v, axis=0)
    all_n = np.concatenate(mesh_n, axis=0)
    all_uv = np.concatenate(mesh_uv, axis=0)
    # pool obj/mat ids are per-MESH placeholders — the winning instance
    # overrides both at query time (scene/query._traverse_instanced)
    pool_obj = np.concatenate(
        [np.full((v.shape[0],), s, np.int32) for s, v in enumerate(mesh_v)]
    )
    pool_mat = np.zeros(all_v.shape[0], np.int32)
    pool = make_triangle_pool(all_v, all_n, all_uv, pool_obj, pool_mat)

    bvhs = []
    for s in range(n_mesh):
        host, idx = hosts[s], idxs[s] + tri_bases[s]
        hit, miss = bvh_builder.thread_links(
            host.left, host.right, host.tri_count, host.axis
        )
        bvhs.append(
            BVHArrays(
                node_min=to_device_f32(host.node_min),
                node_max=to_device_f32(host.node_max),
                left_first=to_device_i32(host.left_first),
                tri_count=to_device_i32(host.tri_count),
                hit_link=to_device_i32(hit),
                miss_link=to_device_i32(miss),
                tri_indices=to_device_i32(idx),
                max_leaf=stats_all[s].max_leaf,
                max_depth=stats_all[s].max_depth,
            )
        )

    # --- per-instance tables --------------------------------------------
    n_inst = len(spec.objects)
    minv = np.zeros((n_inst, 4, 4), np.float32)
    nrm = np.zeros((n_inst, 3, 3), np.float32)
    amin = np.zeros((n_inst, 3), np.float32)
    amax = np.zeros((n_inst, 3), np.float32)
    obj_id = np.zeros(n_inst, np.int32)
    mat_id = np.zeros(n_inst, np.int32)
    for i, obj in enumerate(spec.objects):
        m, mi, nr = instance_matrices(obj)
        minv[i] = mi
        nrm[i] = nr
        host = hosts[inst_mesh[i]]
        amin[i], amax[i] = _transform_aabb(host.node_min[0], host.node_max[0], m)
        obj_id[i] = 2 + i
        mat_id[i] = 2 + obj.material_idx

    shared = SharedInstances(
        inst_minv=to_device_f32(minv),
        inst_nrm=to_device_f32(nrm),
        inst_aabb_min=to_device_f32(amin),
        inst_aabb_max=to_device_f32(amax),
        inst_obj=to_device_i32(obj_id),
        inst_mat=to_device_i32(mat_id),
        inst_mesh=tuple(inst_mesh),
        world_min=tuple(float(x) for x in amin.min(axis=0)),
        world_max=tuple(float(x) for x in amax.max(axis=0)),
        mesh_bounds=tuple(
            (tuple(float(x) for x in h.node_min[0]), tuple(float(x) for x in h.node_max[0]))
            for h in hosts
        ),
        bvhs=tuple(bvhs),
    )
    total_tris = sum(mesh_v[inst_mesh[i]].shape[0] for i in range(n_inst))
    info = SceneInfo(
        name=spec.name,
        triangle_count=total_tris,
        object_count=n_inst,
        build_stats=stats_all[0],
        blas_stats=stats_all[1:],
    )
    return pool, bvhs[0], shared, info


def _build_unified_tlas(inst_v: list[np.ndarray], force_split_cap, leaf_target=None):
    """Per-instance world-space BVHs + agglomerative TLAS, fused into one
    threaded node forest (see module docstring)."""
    n_inst = len(inst_v)
    blas_hosts = []
    blas_idx = []
    blas_stats = []
    tri_base = 0
    inst_bounds = []
    for v in inst_v:
        host, idx, stats = bvh_builder.build_bvh(
            v, force_split_cap=force_split_cap, leaf_target=leaf_target
        )
        blas_hosts.append(host)
        blas_idx.append(idx + tri_base)
        blas_stats.append(stats)
        inst_bounds.append((host.node_min[0].copy(), host.node_max[0].copy()))
        tri_base += v.shape[0]

    tlas = tlas_builder.build_tlas(
        np.stack([b[0] for b in inst_bounds]), np.stack([b[1] for b in inst_bounds])
    )

    n_top = tlas.node_min.shape[0]  # interior TLAS nodes
    # global node layout: [TLAS interior][BLAS 0 nodes][BLAS 1 nodes]...
    blas_node_base = []
    base = n_top
    for host in blas_hosts:
        blas_node_base.append(base)
        base += host.nodes_used
    total_nodes = base

    node_min = np.zeros((total_nodes, 3), np.float32)
    node_max = np.zeros((total_nodes, 3), np.float32)
    left_first = np.zeros(total_nodes, np.int32)
    tri_count = np.zeros(total_nodes, np.int32)
    left = np.full(total_nodes, -1, np.int32)
    right = np.full(total_nodes, -1, np.int32)
    axis = np.zeros(total_nodes, np.int32)

    def map_child(c: int) -> int:
        # TLAS children < n_inst-1 are interior; >= are instance leaves ->
        # the instance's BLAS root node
        if c < n_top:
            return c
        return blas_node_base[c - n_top]

    if n_top:
        node_min[:n_top] = tlas.node_min
        node_max[:n_top] = tlas.node_max
        left[:n_top] = [map_child(int(c)) for c in tlas.left]
        right[:n_top] = [map_child(int(c)) for c in tlas.right]
        axis[:n_top] = tlas.axis

    tri_idx_offset = 0
    all_idx = np.concatenate(blas_idx, axis=0) if blas_idx else np.zeros(0, np.int32)
    for host, nb, idx in zip(blas_hosts, blas_node_base, blas_idx):
        m = host.nodes_used
        sl = slice(nb, nb + m)
        node_min[sl] = host.node_min
        node_max[sl] = host.node_max
        tri_count[sl] = host.tri_count
        leaf = host.tri_count > 0
        left_first[sl] = np.where(leaf, host.left_first + tri_idx_offset, 0)
        interior = ~leaf
        left[sl] = np.where(interior, host.left + nb, -1)
        right[sl] = np.where(interior, host.right + nb, -1)
        axis[sl] = host.axis
        tri_idx_offset += idx.shape[0]

    root = map_child(tlas.root)
    hit, miss = bvh_builder.thread_links(left, right, tri_count, axis, roots=[root])

    max_leaf = max(s.max_leaf for s in blas_stats)
    max_depth = (1 + int(np.ceil(np.log2(max(n_inst, 2))))) + max(
        s.max_depth for s in blas_stats
    )
    tlas_stats = BuildStats(
        build_time_us=0,
        max_depth=max_depth,
        num_nodes=total_nodes,
        num_leaves=int((tri_count > 0).sum()),
        max_leaf=max_leaf,
    )
    bvh = BVHArrays(
        node_min=to_device_f32(node_min),
        node_max=to_device_f32(node_max),
        left_first=to_device_i32(left_first),
        tri_count=to_device_i32(tri_count),
        hit_link=to_device_i32(hit),
        miss_link=to_device_i32(miss),
        tri_indices=to_device_i32(all_idx),
        max_leaf=max_leaf,
        max_depth=max_depth,
        root=root,
    )
    return bvh, tlas_stats, blas_stats
