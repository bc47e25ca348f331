"""Device mesh construction.

The reference is a single-browser-process, single-GPUDevice app
(gpu_context.ts:12-26) — it has no distribution at all (SURVEY.md §2.3).
This module is the new capability: a 2D logical mesh

    ('data', 'tile')

where 'data' shards the camera batch (data parallelism over views) and
'tile' shards image tiles within a view (the multi-device analogue of the
reference's per-pixel fragment-shader parallelism, i.e. context/sequence parallelism for
a rasterizer). Gaussians are replicated in round 1; parameter gradients are
psum-reduced over both axes.

The mesh shape follows the algorithm alone: on one host every card reaches
every other at the same rate, so no axis order is chosen for topology.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    tile: str = "tile"


AXES = MeshAxes()


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    data: Optional[int] = None,
    tile: Optional[int] = None,
) -> Mesh:
    """Build a ('data', 'tile') mesh over the given (default: all) devices.

    With neither axis size given, all devices go to 'tile' (maximize pixel
    parallelism for single-view interactive rendering); pass data=… for
    multi-view training.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None and tile is None:
        data, tile = 1, n
    elif data is None:
        data = n // tile
    elif tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    arr = np.asarray(devices).reshape(data, tile)
    return Mesh(arr, (AXES.data, AXES.tile))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (tile-chunk) axis across the 'tile' mesh axis."""
    return NamedSharding(mesh, P(AXES.tile))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (camera-batch) axis across 'data'."""
    return NamedSharding(mesh, P(AXES.data))


def flat_psum(tree, axes):
    """psum every leaf of `tree` over `axes` as ONE all-reduce of the
    raveled tree (leaves come back in their own dtypes).

    Inside a shard_map step, collectives with no data dependency between
    them may be issued in different orders on different devices. XLA's
    CPU runtime runs such independent collectives concurrently on a
    shared thread pool, and when every pool thread is blocked in a
    collective whose peers are waiting in another one, the step deadlocks
    until the rendezvous timeout aborts the process. One collective per
    reduction, chained by data dependencies, leaves one order only."""
    from jax.flatten_util import ravel_pytree

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    flat, unravel = ravel_pytree([x.astype(jnp.float32) for x in leaves])
    out = unravel(jax.lax.psum(flat, axes))
    return jax.tree_util.tree_unflatten(
        treedef, [o.astype(x.dtype) for o, x in zip(out, leaves)])
