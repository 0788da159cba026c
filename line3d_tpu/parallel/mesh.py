"""Device-mesh helpers for multi-chip / multi-host execution.

The reference is single-process single-GPU (SURVEY.md §2); this build's
scaling axis is #views x #segments: views are sharded over a 1-D "views"
mesh axis (data parallel; every card of a host reaches every other at the
same rate, so the mesh follows the algorithm alone), each device matching
its view shard against replicated neighbor data.  Collectives are inserted by XLA from the
shardings; nothing here talks to hardware directly.
"""
from __future__ import annotations

import math

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def view_chunk_size(mesh: "Mesh", multiple: int = 1,
                    axis: str = "views") -> int:
    """Chunk size for chunked device-program dispatch over the view axis.

    Both device programs (matching, collinearity) execute in chunks of this
    many views so every scene shares the same chunk-shaped executables;
    warmup (pipeline.warmup_async) and dispatch (match/engine.py,
    pipeline.compute_3d_model) MUST use this one formula or a warmed
    executable never matches the runtime one and every scene pays a
    cold compile.  Multi-process runs do not chunk
    (per-chunk globalize/replicate round trips would serialize on DCN) —
    callers use Vp there.
    """
    return math.lcm(mesh.shape[axis], max(int(multiple), 1))


def make_view_mesh(devices=None, axis: str = "views") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def pad_views_to_mesh(num_views: int, mesh: Mesh, axis: str = "views",
                      multiple: int = 1) -> int:
    """Views must be divisible by the mesh size for even sharding.

    `multiple` additionally buckets the padded count (see
    L3DConfig.view_pad_multiple) so compiled program shapes are stable
    across scenes of similar size.
    """
    n = math.lcm(mesh.shape[axis], max(int(multiple), 1))
    return ((num_views + n - 1) // n) * n


def shard_leading(mesh: Mesh, x, axis: str = "views"):
    """Place an array with its leading dim sharded over `axis`.

    Multi-process meshes route through multihost.globalize (a plain
    device_put of a host-local array is rejected under a multi-process
    mesh; every process holds the same full array in this codebase's
    host-replicated flow, so each device just reads its slice)."""
    spec = P(axis, *([None] * (np.ndim(x) - 1)))
    if jax.process_count() > 1:
        from . import multihost
        return multihost.globalize(mesh, spec, x)
    return jax.device_put(x, NamedSharding(mesh, spec))
