"""Device mesh construction + scene replication.

The reference's only parallelism is intra-process threads over pixels
(SURVEY.md §2 P1/P2); the device equivalent of its tile-job fan-out is a
1-D `rays` mesh axis: the flat pixel/sample batch is sharded across cards,
the scene (BVH nodes, triangles, textures, materials) is replicated per
device, and film assembly / gradient reduction ride XLA collectives (NCCL
over NVLink on a multi-GPU host, whose all-to-all links suit a 1-D mesh).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def replicate_scene(scene, mesh: Mesh):
    """Place every scene leaf replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scene)


def shard_rays(o, d, mesh: Mesh, axis: str = "rays"):
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(o, sharding), jax.device_put(d, sharding)
