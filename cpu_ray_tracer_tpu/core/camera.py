"""Pinhole camera as a small pytree + vectorized primary-ray generation.

Parity source: template/camera.h:11-79.  The reference's screen plane is at
`camPos + 2*ahead`, half-height 1, half-width = aspect; `GetPrimaryRay(x, y)`
bilerps topLeft/topRight/bottomLeft by (x/W, y/H).  Here the per-pixel loop
becomes one batched op producing the whole SoA ray batch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracer_tpu.utils import struct

from cpu_ray_tracer_tpu.core import vecmath
from cpu_ray_tracer_tpu.core.rays import Rays, make_rays


@struct.dataclass
class Camera:
    pos: jnp.ndarray  # [3]
    target: jnp.ndarray  # [3]
    top_left: jnp.ndarray  # [3]
    top_right: jnp.ndarray  # [3]
    bottom_left: jnp.ndarray  # [3]
    width: int = struct.field(pytree_node=False, default=1024)
    height: int = struct.field(pytree_node=False, default=640)

    @property
    def aspect(self) -> float:
        return self.width / self.height


def make_camera(
    width: int,
    height: int,
    pos=(0.0, 0.0, -2.0),
    target=(0.0, 0.0, -1.0),
) -> Camera:
    """Build a camera in the reference's default orientation.

    The default ctor (camera.h:14-22) hardcodes an axis-aligned frustum;
    `SetCameraState` (camera.h:61-73) recomputes the screen corners for an
    arbitrary pos/target.  We always use the SetCameraState math, which
    reproduces the default when pos=(0,0,-2), target=(0,0,-1).
    """
    aspect = np.float32(width / height)
    pos = np.asarray(pos, np.float32)
    target = np.asarray(target, np.float32)
    ahead = target - pos
    ahead = ahead / np.linalg.norm(ahead)
    tmp_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(tmp_up, ahead)
    right = right / np.linalg.norm(right)
    up = np.cross(ahead, right)
    up = up / np.linalg.norm(up)
    right = np.cross(up, ahead)
    right = right / np.linalg.norm(right)
    return Camera(
        pos=jnp.asarray(pos),
        target=jnp.asarray(target),
        top_left=jnp.asarray(pos + 2 * ahead - aspect * right + up),
        top_right=jnp.asarray(pos + 2 * ahead + aspect * right + up),
        bottom_left=jnp.asarray(pos + 2 * ahead - aspect * right - up),
        width=width,
        height=height,
    )


def handle_input(
    cam: Camera,
    dt_ms: float,
    move=(0.0, 0.0, 0.0),
    turn=(0.0, 0.0),
    move_speed: float = 5.0,
    turn_speed: float = 5.0,
) -> Camera:
    """Scripted equivalent of Camera::HandleInput (camera.h:31-60).

    move = (right, up, ahead) in {-1, 0, 1} (D/A, R/F, W/S);
    turn = (yaw, pitch) in {-1, 0, 1} (arrow keys).  Speeds and the
    0.00025 * dt scaling match the reference.
    """
    m_speed = np.float32(0.00025) * dt_ms * move_speed
    t_speed = np.float32(0.00025) * dt_ms * turn_speed
    pos = np.asarray(cam.pos, np.float32)
    target = np.asarray(cam.target, np.float32)
    ahead = target - pos
    ahead /= np.linalg.norm(ahead)
    tmp_up = np.array([0, 1, 0], np.float32)
    right = np.cross(tmp_up, ahead)
    right /= np.linalg.norm(right)
    up = np.cross(ahead, right)
    up /= np.linalg.norm(up)
    pos = pos + m_speed * 2 * (move[0] * right + move[2] * ahead + move[1] * up)
    target = pos + ahead
    target = target + t_speed * (-turn[1] * up - turn[0] * right)
    return make_camera(cam.width, cam.height, tuple(pos), tuple(target))


def primary_rays(cam: Camera, xs: jnp.ndarray, ys: jnp.ndarray) -> Rays:
    """Generate rays through continuous pixel coordinates (xs, ys) [N].

    Parity: camera.h:23-30 — u = x/W, v = y/H,
    P = topLeft + u*(topRight-topLeft) + v*(bottomLeft-topLeft),
    D = normalize(P - camPos).
    """
    u = (xs.astype(jnp.float32) / cam.width)[..., None]
    v = (ys.astype(jnp.float32) / cam.height)[..., None]
    p = cam.top_left + u * (cam.top_right - cam.top_left) + v * (cam.bottom_left - cam.top_left)
    d = vecmath.normalize(p - cam.pos)
    o = jnp.broadcast_to(cam.pos, d.shape)
    return make_rays(o, d)


def pixel_grid(cam: Camera) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Flat (xs, ys) integer pixel centers in scanline order [W*H]."""
    ys, xs = jnp.mgrid[0 : cam.height, 0 : cam.width]
    return xs.reshape(-1).astype(jnp.float32), ys.reshape(-1).astype(jnp.float32)


def full_frame_rays(cam: Camera, jitter_x=None, jitter_y=None) -> Rays:
    """One ray per pixel in scanline order, optionally sub-pixel jittered
    (3. PathTracer/renderer.cpp:123-126 adds RandomFloat jitter)."""
    xs, ys = pixel_grid(cam)
    if jitter_x is not None:
        xs = xs + jitter_x
    if jitter_y is not None:
        ys = ys + jitter_y
    return primary_rays(cam, xs, ys)
