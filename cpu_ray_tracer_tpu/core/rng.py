"""Counter-based, batched random number generation.

The reference uses a mutable xorshift32 stream per tile with WangHash seeding
(template/tmplmath.cpp:3-34).  A mutable sequential stream cannot be
vectorized across a megabatch, so the batched design makes the RNG
*stateless and counter-based*: every draw is a pure function of
(pixel id, sample id, bounce, draw index).  Two interchangeable backends:

* `xorshift` — bit-exact xorshift32/WangHash arithmetic of the reference,
  advanced a fixed number of steps per draw.  Deterministic and cheap; used
  for parity-style experiments and as the default in-kernel generator.
* `threefry` — `jax.random` keys, fold_in by the same counters; the
  statistically strongest option.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

UINT_TO_FLOAT = jnp.float32(2.3283064365387e-10)  # 1/2^32, tmplmath.cpp:25


def wang_hash(s: jnp.ndarray) -> jnp.ndarray:
    """WangHash (template/tmplmath.cpp:5-12), on uint32 arrays."""
    s = s.astype(jnp.uint32)
    s = (s ^ jnp.uint32(61)) ^ (s >> 16)
    s = s * jnp.uint32(9)
    s = s ^ (s >> 4)
    s = s * jnp.uint32(0x27D4EB2D)
    s = s ^ (s >> 15)
    return s


def init_seed(seed_base: jnp.ndarray) -> jnp.ndarray:
    """InitSeed (template/tmplmath.cpp:13-16): WangHash((seedBase+1)*17)."""
    s = seed_base.astype(jnp.uint32)
    return wang_hash((s + jnp.uint32(1)) * jnp.uint32(17))


def xorshift32(state: jnp.ndarray) -> jnp.ndarray:
    """One xorshift32 step (template/tmplmath.cpp:17-23). Returns new state
    (which doubles as the random draw)."""
    s = state.astype(jnp.uint32)
    s = s ^ (s << 13)
    s = s ^ (s >> 17)
    s = s ^ (s << 5)
    return s


def random_uint(state: jnp.ndarray):
    """Returns (new_state, uint32 draw)."""
    s = xorshift32(state)
    return s, s


def random_float(state: jnp.ndarray):
    """Returns (new_state, float32 in [0,1)) — uint * 2.3283064365387e-10
    exactly as RandomFloat (tmplmath.cpp:25)."""
    s = xorshift32(state)
    return s, s.astype(jnp.float32) * UINT_TO_FLOAT


def pixel_seeds(pixel_ids: jnp.ndarray, spp: jnp.ndarray | int, salt: int = 1799) -> jnp.ndarray:
    """Per-ray deterministic seeds keyed by (pixel, sample index).

    Mirrors the *intent* of the reference's per-tile
    `InitSeed(tx + ty*W + spp*1799)` (3. PathTracer/renderer.cpp:120) but at
    per-pixel granularity so each lane owns an independent stream.
    """
    base = pixel_ids.astype(jnp.uint32) + jnp.uint32(salt) * jnp.asarray(spp, jnp.uint32)
    return init_seed(base)


# --- threefry backend -------------------------------------------------------


def threefry_uniform(key: jax.Array, shape, lo=0.0, hi=1.0) -> jnp.ndarray:
    return jax.random.uniform(key, shape, jnp.float32, lo, hi)


def fold_counters(key: jax.Array, *counters) -> jax.Array:
    for c in counters:
        key = jax.random.fold_in(key, c)
    return key
