"""Generate the substitute assets this repository ships in place of files
the upstream scenes reference but that are not distributed with it
(SURVEY.md §2 "Missing assets").  Every asset comes from a fixed seed, so a
rerun rewrites the committed files byte for byte:

* industrial_sunset_puresky_4k.hdr  -> procedural sunset sky (.png)
* textures/log_fence.png            -> procedural wood grain
* urna.obj + textures/urna.jpg      -> procedural lathed urn + ceramic texture (.png)
* cube.obj                          -> 12-triangle cube, positions in [-1, 1]
* bunny.obj                         -> closed blob, 4,968 triangles, normals, no uvs
* teapot.obj                        -> closed lathed blob, 2,992 triangles, uvs + normals

Images are written by io/image.write_png, whose None/Sub/Up filters the
repository's own PNG reader decodes without a per-byte loop.

Run from repo root: python tools/make_substitute_assets.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cpu_ray_tracer_tpu.io.image import write_png  # noqa: E402

ASSETS = os.path.join(REPO, "assets")

BUNNY_TRIS = 4968
TEAPOT_TRIS = 2992


def sunset_sky(w=2048, h=1024):
    """Equirect sunset: warm horizon band, blue-grey zenith, sun disk."""
    v = np.linspace(0.0, 1.0, h)[:, None]  # 0 = top (zenith)
    u = np.linspace(0.0, 1.0, w)[None, :]
    # vertical gradient: zenith steel blue -> horizon orange -> ground brown
    zenith = np.array([0.35, 0.47, 0.66])
    horizon = np.array([0.98, 0.62, 0.35])
    ground = np.array([0.25, 0.20, 0.17])
    t_sky = np.clip(v / 0.5, 0, 1) ** 1.5
    sky = zenith[None, None] * (1 - t_sky[..., None]) + horizon[None, None] * t_sky[..., None]
    t_gnd = np.clip((v - 0.5) / 0.5, 0, 1) ** 0.5
    img = sky * (1 - t_gnd[..., None]) + ground[None, None] * t_gnd[..., None]
    # sun disk just above horizon
    su, sv = 0.72, 0.47
    du = np.minimum(np.abs(u - su), 1 - np.abs(u - su)) * 2.0  # wrap
    dist = np.sqrt(du**2 + ((v - sv) * 1.0) ** 2)
    sun = np.clip(1.0 - dist / 0.03, 0, 1) ** 0.5
    glow = np.exp(-((dist / 0.25) ** 2))
    img = img + sun[..., None] * np.array([1.0, 0.9, 0.7]) + glow[..., None] * np.array([0.5, 0.3, 0.12])
    return np.clip(img, 0, 1)


def wood_grain(w=512, h=512, seed=7):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 12 * np.pi, w)[None, :]
    y = np.linspace(0, 3 * np.pi, h)[:, None]
    rings = np.sin(x + 2.2 * np.sin(y) + rng.normal(0, 0.4, (h, 1)).cumsum(0) * 0.15)
    grain = 0.5 + 0.5 * rings
    base_dark = np.array([0.33, 0.21, 0.11])
    base_light = np.array([0.55, 0.38, 0.21])
    img = base_dark[None, None] * (1 - grain[..., None]) + base_light[None, None] * grain[..., None]
    noise = rng.normal(0, 0.02, (h, w, 1))
    return np.clip(img + noise, 0, 1)


def ceramic(w=256, h=256, seed=3):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 6 * np.pi, h)[:, None]
    bands = 0.85 + 0.1 * np.sin(y)
    img = np.repeat(bands, w, axis=1)[..., None] * np.array([0.82, 0.72, 0.6])
    img += rng.normal(0, 0.015, (h, w, 3))
    return np.clip(img, 0, 1)


def urn_obj(rings=24, segs=32):
    """Lathed urn: revolve a vase profile around Y.  Returns OBJ text."""
    profile_t = np.linspace(0, 1, rings)
    radius = 0.25 + 0.35 * np.sin(profile_t * np.pi) ** 1.3 + 0.1 * (1 - profile_t) ** 4
    height = profile_t * 1.6 - 0.8
    verts, norms, uvs, faces = [], [], [], []
    for i, (r, hgt) in enumerate(zip(radius, height)):
        for j in range(segs):
            a = 2 * np.pi * j / segs
            verts.append((r * np.cos(a), hgt, r * np.sin(a)))
            # approximate normal from profile slope
            dr = (radius[min(i + 1, rings - 1)] - radius[max(i - 1, 0)])
            dh = (height[min(i + 1, rings - 1)] - height[max(i - 1, 0)])
            n = np.array([dh * np.cos(a), -dr, dh * np.sin(a)])
            n = n / (np.linalg.norm(n) + 1e-9)
            norms.append(tuple(n))
            uvs.append((j / segs, i / (rings - 1)))
    for i in range(rings - 1):
        for j in range(segs):
            a = i * segs + j
            b = i * segs + (j + 1) % segs
            c = (i + 1) * segs + (j + 1) % segs
            d = (i + 1) * segs + j
            faces.append((a, b, c))
            faces.append((a, c, d))
    lines = ["# procedural urn (substitute asset)"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    lines += [f"vt {t[0]:.6f} {t[1]:.6f}" for t in uvs]
    lines += [f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in norms]
    lines += [f"f {a+1}/{a+1}/{a+1} {b+1}/{b+1}/{b+1} {c+1}/{c+1}/{c+1}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def cube_obj():
    """Unit cube in [-1, 1]^3: 8 positions, one normal per face, a full uv
    square per face; 6 quads that the loader fan-triangulates into 12."""
    pos = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    idx = {p: i + 1 for i, p in enumerate(pos)}
    # (normal, four corners counter-clockwise seen from outside)
    faces = [
        ((1, 0, 0), [(1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1)]),
        ((-1, 0, 0), [(-1, -1, 1), (-1, 1, 1), (-1, 1, -1), (-1, -1, -1)]),
        ((0, 1, 0), [(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)]),
        ((0, -1, 0), [(-1, -1, 1), (-1, -1, -1), (1, -1, -1), (1, -1, 1)]),
        ((0, 0, 1), [(1, -1, 1), (1, 1, 1), (-1, 1, 1), (-1, -1, 1)]),
        ((0, 0, -1), [(-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1)]),
    ]
    lines = ["# unit cube (substitute asset)"]
    lines += [f"v {x:.1f} {y:.1f} {z:.1f}" for x, y, z in pos]
    lines += ["vt 0.0 0.0", "vt 1.0 0.0", "vt 1.0 1.0", "vt 0.0 1.0"]
    lines += [f"vn {n[0]:.1f} {n[1]:.1f} {n[2]:.1f}" for n, _ in faces]
    for k, (_, corners) in enumerate(faces):
        toks = [f"{idx[c]}/{t + 1}/{k + 1}" for t, c in enumerate(corners)]
        lines.append("f " + " ".join(toks))
    return "\n".join(lines) + "\n"


def _lat_long_mesh(radius_fn, slices, stacks):
    """Closed genus-0 mesh over a latitude/longitude grid: a pole vertex at
    each end, `stacks - 1` rings of `slices` vertices between them, and
    2 * slices * (stacks - 1) triangles.  `radius_fn(theta, phi)` gives the
    distance from the origin along each grid direction (theta from the top
    pole).  Returns positions [V, 3], triangle vertex indices [F, 3], and
    each corner's grid cell [F, 3, 2] as (ring, column): ring -1 / stacks-1
    are the poles, and the column is unwrapped (0..slices) so the corners of
    a triangle on the seam stay adjacent."""
    theta = np.linspace(0.0, np.pi, stacks + 1)
    phi = 2 * np.pi * np.arange(slices) / slices
    th, ph = np.meshgrid(theta[1:-1], phi, indexing="ij")  # [stacks-1, slices]
    r = radius_fn(th, ph)
    ring = np.stack(
        [r * np.sin(th) * np.cos(ph), r * np.cos(th), r * np.sin(th) * np.sin(ph)], -1
    ).reshape(-1, 3)
    top = np.array([[0.0, radius_fn(np.zeros(1), np.zeros(1))[0], 0.0]])
    bot = np.array([[0.0, -radius_fn(np.full(1, np.pi), np.zeros(1))[0], 0.0]])
    pos = np.concatenate([top, ring, bot])
    n_ring = stacks - 1

    last = len(pos) - 1
    corners = []  # per triangle: three (ring, unwrapped column) grid corners
    for j in range(slices):
        corners.append(((-1, 0), (0, j + 1), (0, j)))
    for i in range(n_ring - 1):
        for j in range(slices):
            a, b, c, d = (i, j), (i, j + 1), (i + 1, j + 1), (i + 1, j)
            corners.append((a, b, c))
            corners.append((a, c, d))
    for j in range(slices):
        corners.append(((n_ring, 0), (n_ring - 1, j), (n_ring - 1, j + 1)))
    grid = np.asarray(corners, np.int64)  # [F, 3, 2]
    ring_i, col = grid[..., 0], grid[..., 1]
    tris = np.where(ring_i < 0, 0, np.where(ring_i >= n_ring, last, 1 + ring_i * slices + col % slices))
    return pos, tris, grid


def _vertex_normals(pos, tris):
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]], pos[tris[:, 2]] - pos[tris[:, 0]])
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    return vn / np.linalg.norm(vn, axis=-1, keepdims=True)


def _smooth_noise(rng, terms):
    """A random band-limited function on the sphere: a sum of `terms`
    products of low-frequency sines in theta and phi."""
    freq_t = rng.integers(1, 4, terms)
    freq_p = rng.integers(0, 4, terms)
    phase = rng.uniform(0, 2 * np.pi, (terms, 2))
    amp = rng.uniform(0.03, 0.09, terms)

    def f(th, ph):
        out = np.zeros_like(th)
        for k in range(terms):
            out += amp[k] * np.sin(freq_t[k] * th + phase[k, 0]) * np.cos(freq_p[k] * ph + phase[k, 1])
        return out

    return f


def _sit_on_ground(pos):
    """Shift so the mesh rests on y = 0, centred on the y axis."""
    c = 0.5 * (pos.min(axis=0) + pos.max(axis=0))
    return pos - np.array([c[0], pos[:, 1].min(), c[2]])


def bunny_obj(seed=11, slices=54, stacks=47):
    """Closed blob standing in for the Stanford bunny: a squashed sphere
    with a smooth random bulge field and two raised lobes (the ears)."""
    assert 2 * slices * (stacks - 1) == BUNNY_TRIS
    noise = _smooth_noise(np.random.default_rng(seed), 6)

    def radius(th, ph):
        ears = sum(
            0.35 * np.exp(-(((th - 0.45) / 0.25) ** 2 + ((ph - c) / 0.3) ** 2))
            for c in (1.2, 1.9)
        )
        return 0.6 * (1.0 + noise(th, ph) + ears)

    pos, tris, _ = _lat_long_mesh(radius, slices, stacks)
    pos = _sit_on_ground(pos * np.array([1.0, 1.2, 0.85]))
    vn = _vertex_normals(pos, tris)
    lines = ["# procedural bunny stand-in (substitute asset)"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in vn]
    lines += [f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}" for a, b, c in tris]
    return "\n".join(lines) + "\n"


def teapot_obj(seed=5, slices=44, stacks=35):
    """Closed lathed blob standing in for the Utah teapot: a squat body
    with a lid knob, perturbed by a faint random field; uvs follow the
    latitude/longitude grid (a seam column of uvs closes the wrap)."""
    assert 2 * slices * (stacks - 1) == TEAPOT_TRIS
    noise = _smooth_noise(np.random.default_rng(seed), 4)

    def radius(th, ph):
        knob = 0.25 * np.exp(-((th / 0.3) ** 2))
        return 0.55 * (1.0 + 0.3 * noise(th, ph) + knob)

    pos, tris, grid = _lat_long_mesh(radius, slices, stacks)
    pos = _sit_on_ground(pos * np.array([1.0, 0.75, 1.0]))
    vn = _vertex_normals(pos, tris)
    # uv per grid corner, with a duplicated seam column (u = 1 beside
    # u = 0): ring i, column j has uv (j / slices, 1 - (i + 1) / stacks);
    # the poles take u = 0.5
    n_ring = stacks - 1
    uv = [(0.5, 1.0)]
    uv += [(j / slices, 1.0 - (i + 1) / stacks) for i in range(n_ring) for j in range(slices + 1)]
    uv += [(0.5, 0.0)]
    ring_i, col = grid[..., 0], grid[..., 1]
    tex = np.where(
        ring_i < 0, 0, np.where(ring_i >= n_ring, len(uv) - 1, 1 + ring_i * (slices + 1) + col)
    )
    lines = ["# procedural teapot stand-in (substitute asset)"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uv]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in vn]
    for vs, ts in zip(tris, tex):
        lines.append("f " + " ".join(f"{v+1}/{t+1}/{v+1}" for v, t in zip(vs, ts)))
    return "\n".join(lines) + "\n"


def generate():
    """Every substitute asset as {path relative to assets/: content}, where
    content is OBJ text or a uint8 RGB image."""
    u8 = lambda img: (img * 255).astype(np.uint8)  # noqa: E731
    return {
        "industrial_sunset_puresky_4k.png": u8(sunset_sky()),
        "textures/log_fence.png": u8(wood_grain()),
        "textures/urna.png": u8(ceramic()),
        "textures/T_Trim_01_BaseColor.png": u8(wood_grain(256, 256, seed=21)),
        "urna.obj": urn_obj(),
        "cube.obj": cube_obj(),
        "bunny.obj": bunny_obj(),
        "teapot.obj": teapot_obj(),
    }


def main():
    os.makedirs(os.path.join(ASSETS, "textures"), exist_ok=True)
    for rel, content in generate().items():
        path = os.path.join(ASSETS, rel)
        if isinstance(content, str):
            with open(path, "w") as f:
                f.write(content)
        else:
            write_png(path, content)
        print("wrote", path)


if __name__ == "__main__":
    main()
