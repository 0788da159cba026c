"""Multi-host orchestration for runs across several hosts.

The reference is strictly single-process (SURVEY.md §2); scaling line3d_tpu
beyond one host follows the standard JAX SPMD recipe:

  1. every host calls `initialize()` (jax.distributed) with the same
     coordinator,
  2. every host loads the full scene METADATA (cameras, neighbor lists —
     tiny) but only detects segments for its own view shard
     (`my_view_range`), then all-gathers the padded segment tensor
     (`allgather_segments`) so the replicated [V, S, 4] layout the matching
     engine expects holds globally,
  3. the matching mesh spans all hosts' devices; jax.sharding places each
     view's work on the device that owns its shard and XLA routes any
     cross-host traffic over DCN,
  4. the cluster stage runs host-replicated, with its dominant parallel
     component — the affinity weight sweep (similarity + threshold,
     ~10 s / 1000 views) — SHARDED by candidate range across the
     processes and allgathered
     (cluster/affinity.py:_finalize_candidates_sharded); the cheap
     sequential emission + union-find + fit run identically everywhere so
     the model stays host-replicated with no designated writer.

Host-side stages after matching are O(verified matches); measured at
1000-view production density they total ~25 s on a 4-core host (fused
native affinity finalize + packed-pair enumeration + native F-H +
batched fit); the device stage at that scale is not yet measured on the
GPU (ROADMAP W1).  With N hosts the weight
sweep divides by N; the serial-exact Amdahl floor is the order-dependent
enumeration itself (~5 s / 1000 views, linear), replicated because the
reference's `used`-set traversal is sequential by construction
(line3D.cc:984-1221).
"""
from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Initialize jax.distributed (no-op if single-process or already up)."""
    import jax
    if num_processes in (None, 1):
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def globalize(mesh, spec, x):
    """Build a (possibly multi-host) global device array from a
    host-replicated numpy value.

    Every process must hold the same full array (the pipeline's state is
    host-replicated after allgather_segments); each device reads its own
    slice, so no data moves between hosts.  Single-process this is just a
    device_put with the sharding.
    """
    import jax
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, spec)
    x = np.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sh)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def replicate(mesh, tree):
    """Re-shard device outputs to fully-replicated so every host can
    materialize them with np.asarray (a shard_map output is sharded over
    the mesh; its non-addressable pieces live on other hosts)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    rep = NamedSharding(mesh, PartitionSpec())
    shardings = jax.tree_util.tree_map(lambda _: rep, tree)
    return jax.jit(lambda t: t, out_shardings=shardings)(tree)


def my_view_range(num_views: int, process_id: int, num_processes: int):
    """Contiguous view shard [start, end) for this host (detection split)."""
    per = (num_views + num_processes - 1) // num_processes
    start = min(process_id * per, num_views)
    return start, min(start + per, num_views)


def allgather_segments(local_segments: np.ndarray, local_mask: np.ndarray,
                       start: int, num_views: int):
    """All-gather per-host segment shards into the replicated [V, S, 4]
    tensor via jax.experimental.multihost_utils.

    local_segments: [V_local, S, 4] detected by this host for views
    [start, start + V_local).
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    V_local, S, _ = local_segments.shape
    # hosts detect independently, so their padded segment axes can differ
    # (per-shard max counts); collectives need identical shapes on every
    # process — agree on the global max S first (one tiny allgather)
    S_all = np.asarray(multihost_utils.process_allgather(
        jnp.asarray([S], np.int32)))
    S_global = int(S_all.max())
    if S_global != S:
        pad = S_global - S
        local_segments = np.pad(local_segments, [(0, 0), (0, pad), (0, 0)])
        local_mask = np.pad(local_mask, [(0, 0), (0, pad)])
        S = S_global
    segs = np.zeros((num_views, S, 4), np.float32)
    mask = np.zeros((num_views, S), bool)
    segs[start:start + V_local] = local_segments
    mask[start:start + V_local] = local_mask
    # sum-reduce across hosts: each host contributed a disjoint slice
    out = multihost_utils.process_allgather(
        (jnp.asarray(segs), jnp.asarray(mask.astype(np.float32))))
    segs_all = np.asarray(out[0]).sum(axis=0) if out[0].ndim == 4 else \
        np.asarray(out[0])
    mask_all = np.asarray(out[1]).sum(axis=0) > 0.5 if out[1].ndim == 3 else \
        np.asarray(out[1]) > 0.5
    return segs_all.astype(np.float32), mask_all
