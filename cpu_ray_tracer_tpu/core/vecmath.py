"""Batched 3D vector math on `[..., 3]` jnp arrays.

Replaces the reference's scalar float3 operator library
(template/tmplmath.h) with vectorized jnp ops.  Every function here maps
over arbitrary leading batch dimensions so the same code path serves a
single ray and a megabatch of millions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

EPS_NORMALIZE = np.float32(1e-20)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis; keeps no dims."""
    return jnp.sum(a * b, axis=-1)


def dotk(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product keeping the trailing axis (for broadcasting)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize; zero vectors stay (near) zero instead of NaN."""
    sq = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * jax_rsqrt(jnp.maximum(sq, EPS_NORMALIZE))


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    import jax.lax as lax

    return lax.rsqrt(x)


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of incident direction `i` about normal `n`.

    Parity: template/tmplmath.h:506 `i - 2*n*dot(n,i)`.
    """
    return i - 2.0 * n * dotk(n, i)


def refract_terms(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Shared dielectric terms.

    Returns (cosi, cost2, transmitted_dir).  `d` is the incoming ray
    direction (pointing at the surface), `n` the outward surface normal,
    `eta = n1/n2`.  Matches 2. WhittedStyle/renderer.cpp:57-66 /
    3. PathTracer/renderer.cpp:30-40:

        cosi  = dot(-D, N)
        cost2 = 1 - eta^2 (1 - cosi^2)
        T     = eta*D + (eta*cosi - sqrt(|cost2|)) * N
    """
    eta = jnp.asarray(eta)
    if eta.ndim < d.ndim:
        eta = eta[..., None]
    cosi = dotk(-d, n)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t = eta * d + (eta * cosi - jnp.sqrt(jnp.abs(cost2))) * n
    return cosi[..., 0], cost2[..., 0], t


def schlick_fresnel(cosi: jnp.ndarray, n1: jnp.ndarray, n2: jnp.ndarray) -> jnp.ndarray:
    """Schlick's approximation, exactly as the reference computes it:
    R0 = ((n1-n2)/(n1+n2))^2 ; Fr = R0 + (1-R0)(1-cosi)^5
    (2. WhittedStyle/renderer.cpp:60-62)."""
    a = n1 - n2
    b = n1 + n2
    r0 = (a * a) / (b * b)
    c = 1.0 - cosi
    return r0 + (1.0 - r0) * (c * c * c * c * c)


def beer_absorption(absorption: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Beer's-law medium transmittance exp(-absorption * t) per channel
    (2. WhittedStyle/renderer.cpp:81-88)."""
    return jnp.exp(absorption * (-t)[..., None])


# ---------------------------------------------------------------------------
# Transforms. Matrices are row-major 4x4 like the reference's mat4
# (template/tmplmath.h:639+): world = M @ [p; 1].
# ---------------------------------------------------------------------------


def transform_position(p: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Apply a row-major 4x4 (or 3x4) matrix to positions `[..., 3]`.

    Parity: template/tmplmath.h TransformPosition.
    `m` may be [..., 4, 4] or [..., 3, 4]; broadcasting over batch dims.
    """
    # Explicit expansion instead of einsum: keeps the 3-wide contraction in
    # full fp32 elementwise math (a default-precision matmul may round f32
    # operands, and a 3x3 contraction gains nothing from a matrix unit).
    out = transform_vector(p, m)
    return out + m[..., :3, 3]


def transform_vector(v: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Apply only the rotational part of a row-major matrix to vectors."""
    rot = m[..., :3, :3]
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return rot[..., :, 0] * x + rot[..., :, 1] * y + rot[..., :, 2] * z


# ---------------------------------------------------------------------------
# Host-side (numpy) matrix builders mirroring mat4::Translate/RotateX/.../Scale
# (template/tmplmath.h:639-833).  These run in the scene compiler only.
# ---------------------------------------------------------------------------


def mat_translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3], m[2, 3] = v
    return m


def mat_scale(v) -> np.ndarray:
    if np.isscalar(v):
        v = (v, v, v)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def mat_rotate_x(a: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = ca, -sa, sa, ca
    return m


def mat_rotate_y(a: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = ca, sa, -sa, ca
    return m


def mat_rotate_z(a: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = ca, -sa, sa, ca
    return m


def mat_inverted_no_scale(m: np.ndarray) -> np.ndarray:
    """Fast inverse of a rigid (rotation+translation) matrix.

    Parity: mat4::FastInvertedTransformNoScale (template/tmplmath.h:808+):
    transpose the rotation block, back-rotate the translation.
    """
    r = np.eye(4, dtype=np.float32)
    r[:3, :3] = m[:3, :3].T
    r[:3, 3] = -(m[:3, :3].T @ m[:3, 3])
    return r


def mat_inverted(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m).astype(np.float32)


# --- flat-cotangent row gather -------------------------------------------
# For [N, 3] tables gathered inside DIFFERENTIATED lax.scan bodies (chunked
# bounces): a scan transpose stacks one cotangent instance of every
# closed-over operand per iteration, and a tiled layout pads the small
# trailing dim of a [N, 3] f32 cotangent.  Gathering
# through a FLAT [N*3] view keeps every stacked cotangent unpadded; the
# single reshape back to [N, 3] (and its padded instance) happens once,
# outside all scans, where the flat views are CSE'd.

import jax as _jax


@_jax.custom_vjp
def _gather3_flat(flat: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """flat.reshape(-1, 3)[idx] ([N*3] f32, [...] i32 -> [..., 3]).

    The forward is a plain ROW gather (one index per row); only the
    COTANGENT is flat."""
    return flat.reshape(-1, 3)[idx]


def _gather3_flat_fwd(flat, idx):
    return _gather3_flat(flat, idx), (idx, flat.shape[0])


def _gather3_flat_bwd(res, g):
    idx, n3 = res
    # rank-1 scatter-add in place of a multi-lane row scatter
    fi = idx.reshape(-1)[:, None] * 3 + jnp.arange(3, dtype=idx.dtype)[None, :]
    gt = jnp.zeros((n3,), g.dtype).at[fi.reshape(-1)].add(g.reshape(-1))
    return gt, None


_gather3_flat.defvjp(_gather3_flat_fwd, _gather3_flat_bwd)


def gather_rows3(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for a differentiable [N, 3] table, flat-cotangent backward.

    Identical forward values to `table[idx]`; use for any gather of a
    PARAMETER table that sits inside a differentiated scan body."""
    return _gather3_flat(table.reshape(-1), idx)
