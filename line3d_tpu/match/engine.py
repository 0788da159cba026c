"""Per-view matching engine: pairwise matching + verification + selection.

Orchestrates the device kernels in `pairwise` and `scoring` over all views and
reproduces the host-side selection logic of the reference:
  * per-view match table build (performMatching, line3D.cc:698-885),
  * confidence filter conf > 1.0, conf /= 2 (cudawrapper.cu:1089-1110),
  * per-view median depth from best raw matches (cudawrapper.cu:1025-1076),
  * greedy best-match selection per source segment with score = min(conf, 1)
    (greedySelection, line3D.cc:899-965; addMatches only_best,
    view.cc:162-183).

Unlike the reference (which matches each unordered view pair once on the GPU
and spools reversed matches to the partner's disk file, line3D.cc:838-872),
every directed (view, neighbor) relation is recomputed on device — the pair
kernel is symmetric (the reference's reverse-spool relies on exactly this),
recompute is cheap on the device, and it removes the disk-spool data bus
entirely.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..scene import Scene
from . import pairwise, scoring


@dataclasses.dataclass
class ViewMatches:
    """Filtered (verified) matches of one source view."""
    view: int
    src_seg: np.ndarray      # [K] int32
    tgt_view: np.ndarray     # [K] int32 (global view index)
    tgt_seg: np.ndarray      # [K] int32
    # depths/confidence are populated by the per-view reference engine only;
    # nothing downstream consumes them (affinity uses identities, the best
    # hypothesis carries its own depths/score), so the sharded path never
    # moves them off device.
    depths: np.ndarray | None = None       # [K, 4] float32
    confidence: np.ndarray | None = None   # [K] float32 (already / 2)
    overflow: int = 0
    # exact uncapped capacity diagnostics (filled by the sharded engine;
    # they let the uncapped fallback size its re-run without a counting
    # dispatch): max / sum over src segments of raw gate-passing counts
    need_capacity: int = 0
    total_candidates: int = 0


@dataclasses.dataclass
class BestMatches:
    """Per-(view, segment) best hypothesis — the clustering input.

    Mirrors best_match_ (line3D.h:133): for every source segment with at
    least one verified match, the highest-confidence one, unprojected to a 3D
    segment in conditioned space.
    """
    view: np.ndarray         # [B] int32
    seg: np.ndarray          # [B] int32
    tgt_view: np.ndarray     # [B] int32
    tgt_seg: np.ndarray      # [B] int32
    score: np.ndarray        # [B] float32 (min(conf, 1))
    P1: np.ndarray           # [B, 3] float64 (conditioned space)
    P2: np.ndarray           # [B, 3] float64
    dir: np.ndarray          # [B, 3] float64 normalized
    d1: np.ndarray           # [B] float32 depth of P1
    d2: np.ndarray           # [B] float32


@functools.partial(jax.jit, static_argnames=("quota", "m_total",
                                             "row_chunk", "support_t",
                                             "per_nb_cap"))
def _match_and_score_view(segs_src, mask_src, RtKinv_src, C_src,
                          segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb,
                          nb_mask, sigma_p, sigma_a, spatial_k,
                          quota: int, m_total: int, row_chunk: int,
                          support_t: float = 0.5,
                          per_nb_cap: int | None = None):
    """Full device-side matching step for one source view.

    Returns (cam [S, M], tgt [S, M], depths [S, M, 4], valid [S, M],
             conf [S, M], overflow [N]).
    """
    res = pairwise.match_view_against_neighbors(
        segs_src, mask_src, RtKinv_src, C_src,
        segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, nb_mask, quota,
        min_capacity=m_total, per_nb_cap=per_nb_cap)

    cam, tgt, valid = pairwise.merge_neighbor_tables(
        res, m_total, segs_nb.shape[1])
    # one [S, M, 4] target-coordinate gather, shared by the depth
    # recompute and the scoring prep (pairwise.gather_target_coords)
    tcoords = pairwise.gather_target_coords(segs_nb, cam, tgt)
    depths = pairwise.depths_for_matches(
        segs_src, segs_nb, cam, tgt, valid,
        F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb, tcoords=tcoords)

    conf = scoring.score_matches_best(
        segs_src, mask_src, RtKinv_src, C_src,
        cam, tgt, depths, valid, P_nb, segs_nb,
        sigma_p, sigma_a, spatial_k, row_chunk=row_chunk,
        support_threshold=support_t, tcoords=tcoords)

    total_overflow = res["overflow"]
    n_kept = jnp.sum(res["valid"], axis=(0, 2))      # per src seg, all nbrs
    dropped = jnp.maximum(n_kept - cam.shape[1], 0)
    total_overflow = jnp.sum(total_overflow) + jnp.sum(dropped)
    return cam, tgt, depths, valid, conf, total_overflow


@functools.partial(jax.jit, static_argnames=("quota", "m_total",
                                             "row_chunk", "k_export",
                                             "support_t"))
def _match_score_select_view(segs_src, mask_src, RtKinv_src, C_src,
                             segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb,
                             nb_mask, sigma_p, sigma_a, spatial_k, conf_t,
                             quota: int, m_total: int, row_chunk: int,
                             k_export: int, support_t: float = 0.5):
    """_match_and_score_view + DEVICE-side selection (parallel/sharded.py
    device_select): returns only the per-segment best fields, the packed
    verified-match export, the on-device median depth, and overflow
    counters.  The raw [S, M] tables never cross the device->host link:
    at uncapped-exact capacities (M >= 1024) they are ~50 MB/view, while
    the compact outputs are a few hundred KB."""
    from ..parallel import sharded

    cam, tgt, depths, valid, conf, overflow = \
        _match_and_score_view.__wrapped__(
            segs_src, mask_src, RtKinv_src, C_src,
            segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb, nb_mask,
            sigma_p, sigma_a, spatial_k,
            quota=quota, m_total=m_total, row_chunk=row_chunk,
            support_t=support_t)
    out = sharded.device_select(cam, tgt, depths, valid, conf, conf_t,
                                k_export, segs_nb.shape[0])
    out["match_overflow"] = overflow
    return out


def _pad_neighbors(arrs, n_max):
    """Pad leading neighbor axis of each array to n_max."""
    out = []
    for a in arrs:
        pad = n_max - a.shape[0]
        if pad > 0:
            cfg = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(a, cfg)
        out.append(a)
    return out


def _best_rows_f64_batched(scene: Scene, cameras: CameraSet, v_arr, s_arr,
                           d1, d2, bconf, tgt_view, tgt_seg):
    """Unproject best matches in float64 across MANY views at once and
    build the BestMatches row dict (unprojectSegment, view.cc:302-342;
    the parity-critical math has exactly this one implementation —
    the per-view helper below wraps it)."""
    n = len(v_arr)
    coords = scene.segments[v_arr, s_arr].astype(np.float64)
    ones = np.ones((n, 1))
    p1 = np.concatenate([coords[:, 0:2], ones], axis=1)
    p2 = np.concatenate([coords[:, 2:4], ones], axis=1)
    M = cameras.RtKinv[v_arr]                       # [n, 3, 3]
    r1 = np.einsum("bij,bj->bi", M, p1)
    r1 /= np.linalg.norm(r1, axis=1, keepdims=True)
    r2 = np.einsum("bij,bj->bi", M, p2)
    r2 /= np.linalg.norm(r2, axis=1, keepdims=True)
    C = cameras.C[v_arr]
    P1 = C + r1 * np.asarray(d1, np.float64)[:, None]
    P2 = C + r2 * np.asarray(d2, np.float64)[:, None]
    dirv = P2 - P1
    nrm = np.linalg.norm(dirv, axis=1, keepdims=True)
    dirv = np.divide(dirv, nrm, out=np.zeros_like(dirv), where=nrm > 0)
    return dict(view=np.asarray(v_arr, np.int32),
                seg=np.asarray(s_arr, np.int32),
                tgt_view=np.asarray(tgt_view, np.int32),
                tgt_seg=np.asarray(tgt_seg, np.int32),
                score=np.asarray(bconf, np.float32),
                P1=P1, P2=P2, dir=dirv,
                d1=np.asarray(d1, np.float32),
                d2=np.asarray(d2, np.float32))


def _best_rows_f64(scene: Scene, cameras: CameraSet, v: int, bs, d1, d2,
                   bconf, tgt_view, tgt_seg):
    """One view's best rows (see _best_rows_f64_batched)."""
    return _best_rows_f64_batched(
        scene, cameras, np.full(len(bs), v, np.int64), np.asarray(bs),
        d1, d2, bconf, tgt_view, tgt_seg)


class _ViewContext:
    """Shared f32 device views of a scene for per-view matching calls."""

    def __init__(self, scene: Scene, cameras: CameraSet, config: L3DConfig,
                 n_max: int):
        self.scene, self.cameras, self.config = scene, cameras, config
        self.n_max = n_max
        self.segs_f32 = np.asarray(scene.segments, np.float32)
        self.mask = np.asarray(scene.seg_mask)
        self.RtKinv32 = cameras.f32("RtKinv")
        self.C32 = cameras.f32("C")
        self.P32 = cameras.f32("P")
        self.spatial_ks = cameras.spatial_uncertainty_k(2.0 * config.sigma_p)

    def neighbor_arrays(self, v: int, nb: np.ndarray):
        F = self.cameras.fundamentals_for_pairs(
            np.stack([np.full(len(nb), v), nb], axis=1)).astype(np.float32)
        padded = _pad_neighbors(
            [self.segs_f32[nb], self.mask[nb], F, self.RtKinv32[nb],
             self.C32[nb], self.P32[nb]], self.n_max)
        nb_mask = np.zeros(self.n_max, bool)
        nb_mask[:len(nb)] = True
        return padded, nb_mask


def _match_one_view(ctx: _ViewContext, v: int, nb: np.ndarray,
                    quota: int, m_total: int):
    """One view's device matching step at the given caps; host numpy out."""
    (segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb), nb_mask = \
        ctx.neighbor_arrays(v, nb)
    S = ctx.scene.max_segments
    cam, tgt, depths, valid, conf, overflow = _match_and_score_view(
        ctx.segs_f32[v], ctx.mask[v], ctx.RtKinv32[v], ctx.C32[v],
        segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb, nb_mask,
        np.float32(ctx.config.sigma_p), np.float32(ctx.config.sigma_a),
        np.float32(ctx.spatial_ks[v]),
        quota=quota, m_total=m_total, row_chunk=min(128, S),
        support_t=float(ctx.config.support_threshold))
    return (np.asarray(cam), np.asarray(tgt), np.asarray(depths),
            np.asarray(valid), np.asarray(conf), int(overflow))


def _select_view_outputs(ctx: _ViewContext, v: int, nb: np.ndarray,
                         cam, tgt, depths, valid, conf, overflow: int,
                         verbose: bool = False):
    """Host-side selection for one view's match table: median depth,
    confidence filter, best-per-segment (cudawrapper.cu:1025-1110;
    greedySelection, line3D.cc:899-965).

    Returns (ViewMatches, best_row_dict | None, median_depth)."""
    scene, cameras, config = ctx.scene, ctx.cameras, ctx.config

    # --- median depth (cudawrapper.cu:1025-1076) --------------------
    median_depth = 1.0
    conf_m = np.where(valid, conf, -np.inf)
    max_conf = conf_m.max(axis=1)
    arg = conf_m.argmax(axis=1)  # first max (ties)
    has = max_conf > config.confidence_threshold / 2.0
    if has.any():
        rows = np.nonzero(has)[0]
        dsel = depths[rows, arg[rows]][:, :2]   # (d1, d2) per segment
        dall = dsel.reshape(-1)                 # seg-order, d1 then d2
        dall_sorted = np.sort(dall, kind="stable")
        median_depth = float(dall_sorted[len(dall_sorted) // 2])

    # --- confidence filter (cudawrapper.cu:1089-1110) ----------------
    keep = valid & (conf > config.confidence_threshold)
    si, mi = np.nonzero(keep)
    vm = ViewMatches(
        view=v,
        src_seg=si.astype(np.int32),
        tgt_view=nb[cam[si, mi]].astype(np.int32),
        tgt_seg=tgt[si, mi].astype(np.int32),
        depths=depths[si, mi],
        confidence=(conf[si, mi] / config.confidence_norm).astype(np.float32),
        overflow=int(overflow))

    # --- best match per segment (greedySelection) --------------------
    best_row = None
    conf_f = np.where(keep, conf, -np.inf)
    bmax = conf_f.max(axis=1)
    barg = conf_f.argmax(axis=1)
    bs = np.nonzero(bmax > -np.inf)[0]
    if len(bs):
        bm = barg[bs]
        bconf = np.minimum(conf[bs, bm] / config.confidence_norm, 1.0)
        best_row = _best_rows_f64(
            scene, cameras, v, bs,
            depths[bs, bm, 0], depths[bs, bm, 1], bconf,
            nb[cam[bs, bm]], tgt[bs, bm])

    if verbose:
        print(f"[L3D] view {v}: {len(si)} verified matches, "
              f"median_depth={median_depth:.4f}, overflow={int(overflow)}")
    return vm, best_row, median_depth


def run_matching(scene: Scene, cameras: CameraSet, neighbors: list,
                 config: L3DConfig, verbose: bool = False):
    """Match + verify every view against its visual neighbors.

    Returns (list[ViewMatches], BestMatches, median_depths [V] float64).
    Also sets cameras.median_depth (setMedianDepth, line3D.cc:835).
    """
    V = scene.num_views
    S = scene.max_segments
    n_max = max((len(n) for n in neighbors), default=0)
    if n_max == 0:
        return [], _empty_best(), np.ones(V)

    ctx = _ViewContext(scene, cameras, config, n_max)

    all_matches = []
    best_rows = []
    median_depths = np.ones(V)

    for v in range(V):
        nb = np.asarray(neighbors[v], np.int64)
        if len(nb) == 0:
            continue
        # a segment can match up to S targets in each of n_max neighbors,
        # so n_max*S (not S) is the true uncapped per-segment capacity
        outs = _match_one_view(ctx, v, nb,
                               quota=config.match_block_quota,
                               m_total=min(config.max_matches_per_segment,
                                           n_max * S))
        vm, best_row, median_depths[v] = _select_view_outputs(
            ctx, v, nb, *outs, verbose=verbose)
        cameras.median_depth[v] = median_depths[v]
        all_matches.append(vm)
        if best_row is not None:
            best_rows.append(best_row)

    best = _concat_best(best_rows)
    return all_matches, best, median_depths


@functools.partial(jax.jit)
def _count_view_matches(segs_src, mask_src, RtKinv_src, C_src,
                        segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, nb_mask):
    """Exact per-(neighbor, src segment) gate-passing match counts [N, S] —
    the capacity an uncapped run needs (the reference's unbounded list
    length, cudawrapper.cu:923-944).  Cheap: the pair gates only, no
    compaction/scoring."""
    def step(carry, nb):
        segs_t, mask_t, F, RtKinv_t, C_t = nb
        valid = pairwise.match_pair_valid(
            segs_src, segs_t, mask_src, mask_t,
            F, RtKinv_src, RtKinv_t, C_src, C_t,
            pairwise.MIN_OVERLAP_LOWER, pairwise.MIN_OVERLAP_UPPER)
        return carry, jnp.sum(valid, axis=1).astype(jnp.int32)

    _, nv = jax.lax.scan(
        step, None, (segs_nb, mask_nb & nb_mask[:, None],
                     F_nb, RtKinv_nb, C_nb))
    return nv


def rematch_views_exact(scene: Scene, cameras: CameraSet, neighbors: list,
                        config: L3DConfig, views, verbose: bool = False):
    """Re-match `views` with caps raised to their exact gate-passing
    capacity — reference semantics (every raw match kept,
    cudawrapper.cu:923-1007).

    Scoring, selection, and the median depth are view-local (support comes
    only from the view's own match table), so re-running just the
    overflowing views at sufficient capacity reproduces a fully uncapped
    run bit-for-bit.  The capacity is measured first with a cheap counting
    program, then rounded up to a power of two so repeated fallbacks reuse
    compiled executables.

    Returns {view: (ViewMatches, best_row | None, median_depth)}.
    """
    n_max = max((len(n) for n in neighbors), default=0)
    ctx = _ViewContext(scene, cameras, config, n_max)
    S = scene.max_segments

    # phase 1: dispatch the cheap counting program for every view BEFORE
    # any readback (executions queue back to back; a sync per view would
    # serialize a dispatch round-trip each)
    counts, nb_arrays = {}, {}
    for v in views:
        nb = np.asarray(neighbors[v], np.int64)
        if len(nb) == 0:
            continue
        nb_arrays[v] = (nb,) + ctx.neighbor_arrays(v, nb)
        (segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _P_nb), nb_mask = \
            nb_arrays[v][1:]
        counts[v] = _count_view_matches(
            ctx.segs_f32[v], ctx.mask[v], ctx.RtKinv32[v], ctx.C32[v],
            segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, nb_mask)

    # phase 2: dispatch every view's match+score+SELECT program at its
    # pow2-bucketed exact capacity (few distinct executables), again all
    # before any result readback.  Selection runs on device and only the
    # compact outputs cross the link; k_export is bounded by the view's
    # total gate-passing count (verified is a subset), so the export can
    # never drop.
    needs, lazy = {}, {}
    for v, nv_dev in counts.items():
        nv = np.asarray(nv_dev)
        need = int(nv.sum(axis=0).max())
        total = int(nv.sum())
        # pow2 bucket -> few distinct executables; quota=128 disables the
        # per-block cap entirely (compact_rows_blockq clamps to the block)
        m_total = 1 << max(int(np.ceil(np.log2(max(need, 1)))), 0)
        m_total = min(m_total, n_max * S)
        k_export = 1 << max(int(np.ceil(np.log2(max(total, 1)))), 8)
        k_export = min(k_export, S * m_total)
        needs[v] = (need, m_total)
        nb = nb_arrays[v][0]
        (segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb), nb_mask = \
            nb_arrays[v][1:]
        lazy[v] = _match_score_select_view(
            ctx.segs_f32[v], ctx.mask[v], ctx.RtKinv32[v], ctx.C32[v],
            segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb, nb_mask,
            np.float32(ctx.config.sigma_p), np.float32(ctx.config.sigma_a),
            np.float32(ctx.spatial_ks[v]),
            np.float32(ctx.config.confidence_threshold),
            quota=128, m_total=m_total, row_chunk=min(128, S),
            k_export=k_export,
            support_t=float(ctx.config.support_threshold))
        for arr in jax.tree_util.tree_leaves(lazy[v]):
            if hasattr(arr, "copy_to_host_async"):
                arr.copy_to_host_async()

    # phase 3: materialize the compact outputs + host assembly in view order
    out = {}
    for v, o in lazy.items():
        need, m_total = needs[v]
        overflow = int(o["match_overflow"]) + int(o["export_drop"])
        if overflow != 0:
            raise AssertionError(
                f"uncapped rematch of view {v} still overflowed "
                f"({overflow}) at capacity {m_total} (needed {need})")
        if verbose:
            print(f"[L3D] view {v}: re-matched uncapped "
                  f"(capacity {need} -> m_total {m_total}, "
                  f"{int(o['n_verified'])} verified)")
        out[v] = _assemble_view_outputs(ctx, v, nb_arrays[v][0], o,
                                        verbose=verbose)
    return out


def _assemble_view_outputs(ctx: _ViewContext, v: int, nb: np.ndarray, o,
                           verbose: bool = False):
    """Rebuild (ViewMatches, best_row | None, median_depth) from the
    device-selected compact outputs (the per-view twin of
    finalize_matching_sharded's per-view block; identities only — nothing
    downstream consumes per-match depths/confidence)."""
    from ..parallel import sharded

    S = ctx.scene.max_segments
    median_depth = float(o["median_depth"]) if bool(o["median_has"]) else 1.0

    packed = np.asarray(o["exp_packed"])
    packed = packed[packed >= 0]
    # the device packed cam slots with the PADDED neighbor-slot width
    # (ctx.n_max), not this view's actual count — the widths differ
    # whenever len(nb) rounds to a smaller bit length
    src, camslot, tgt = sharded.unpack_export(packed, S, ctx.n_max)
    vm = ViewMatches(
        view=v,
        src_seg=src,
        tgt_view=nb[camslot].astype(np.int32),
        tgt_seg=tgt,
        overflow=0)

    best_row = None
    bs = np.nonzero(np.asarray(o["best_has"]))[0]
    if len(bs):
        best_conf = np.asarray(o["best_conf"])
        best_d = np.asarray(o["best_depths"])
        bconf = np.minimum(best_conf[bs] / ctx.config.confidence_norm, 1.0)
        best_row = _best_rows_f64(
            ctx.scene, ctx.cameras, v, bs,
            best_d[bs, 0], best_d[bs, 1], bconf,
            nb[np.asarray(o["best_cam"])[bs]],
            np.asarray(o["best_tgt"])[bs])
    return vm, best_row, median_depth


def rematch_views_exact_sharded(scene: Scene, cameras: CameraSet,
                                neighbors: list, config: L3DConfig,
                                views, verbose: bool = False, mesh=None,
                                verified_hint: int = 0,
                                k_export_floor: int = 4096,
                                precounted: dict | None = None):
    """Sharded/chunked variant of rematch_views_exact: ONE chunked device
    program re-matches all overflowing views at their exact pow2-bucketed
    capacity (quota disabled), with device-side selection and the packed
    export — per-view dispatch/readback overhead collapses to the chunk
    pipeline's.

    The packed export is sized from `verified_hint` (the capped run's
    largest per-view verified count; the gate-passing total is a strict
    bound but ~4x oversized, and every export slot crosses the
    device->host link for every padded view).  A view whose export still drops is
    re-run through the per-view path at its strict bound, so exactness is
    unconditional.

    Returns {view: (ViewMatches, best_row | None, median_depth)}."""
    n_max = max((len(n) for n in neighbors), default=0)
    S = scene.max_segments

    views = [v for v in views if len(neighbors[v])]
    if not views:
        return {}
    if precounted is not None:
        # capacities already measured by the mainline sharded program
        # (raw gate-passing counts ride in its packed output) — no
        # counting dispatches at all
        need = max(precounted[v][0] for v in views)
        total = max(precounted[v][1] for v in views)
    else:
        # counting phase (dispatch-all-then-read, like rematch_views_exact)
        ctx = _ViewContext(scene, cameras, config, n_max)
        counts = {}
        for v in views:
            nb = np.asarray(neighbors[v], np.int64)
            (segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _P_nb), nb_mask = \
                ctx.neighbor_arrays(v, nb)
            counts[v] = _count_view_matches(
                ctx.segs_f32[v], ctx.mask[v], ctx.RtKinv32[v], ctx.C32[v],
                segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, nb_mask)
        nvs = {v: np.asarray(c) for v, c in counts.items()}
        need = max(int(nv.sum(axis=0).max()) for nv in nvs.values())
        total = max(int(nv.sum()) for nv in nvs.values())
    m_total = 1 << max(int(np.ceil(np.log2(max(need, 1)))), 0)
    m_total = min(m_total, n_max * S)
    k_guess = max(4 * verified_hint, k_export_floor) if verified_hint \
        else total
    k_export = 1 << max(int(np.ceil(np.log2(max(min(k_guess, total), 1)))),
                        6)

    bufs, mctx = dispatch_matching_sharded(
        scene, cameras, neighbors, config, mesh=mesh,
        m_total_override=m_total, quota_override=128,
        k_export_override=k_export, active_views=views,
        defer_export=True)
    matches, best_sub, med = finalize_matching_sharded(
        bufs, mctx, scene, cameras, config, verbose=verbose,
        only_views=views)

    out = {}
    best_by_view = {}
    for v in np.unique(best_sub.view):
        m = best_sub.view == v
        best_by_view[int(v)] = dict(
            view=best_sub.view[m], seg=best_sub.seg[m],
            tgt_view=best_sub.tgt_view[m], tgt_seg=best_sub.tgt_seg[m],
            score=best_sub.score[m], P1=best_sub.P1[m], P2=best_sub.P2[m],
            dir=best_sub.dir[m], d1=best_sub.d1[m], d2=best_sub.d2[m])
    retry = []
    for vm in matches:
        if vm.overflow != 0:
            # export undersized for this view (match capacity is exact by
            # construction) — strict-bound per-view re-run
            retry.append(vm.view)
            continue
        out[vm.view] = (vm, best_by_view.get(vm.view), med[vm.view])
        if verbose:
            print(f"[L3D] view {vm.view}: re-matched uncapped (sharded, "
                  f"capacity {need} -> m_total {m_total})")
    if retry:
        if verbose:
            print(f"[L3D] uncapped rematch: export hint too small for "
                  f"{len(retry)} view(s) {retry} — strict per-view re-run")
        out.update(rematch_views_exact(scene, cameras, neighbors, config,
                                       retry, verbose=verbose))
    return out


def apply_uncapped_fallback(matches, best, median_depths,
                            scene: Scene, cameras: CameraSet,
                            neighbors: list, config: L3DConfig,
                            verbose: bool = False, sharded: bool = False,
                            mesh=None):
    """Reference-exactness guard over a finished matching pass.

    Views whose overflow counter is zero are provably identical to an
    uncapped run (the caps only drop matches).  For the rest, re-match at
    exact capacity (rematch_views_exact / the chunked sharded variant) and
    splice the per-view results.

    Returns (matches, best, median_depths, num_rematched)."""
    over = [vm.view for vm in matches if vm.overflow > 0]
    if not over:
        return matches, best, median_depths, 0
    if verbose:
        print(f"[L3D] uncapped fallback: re-matching {len(over)} "
              f"overflowing view(s) {over}")
    if sharded:
        hint = max(len(vm.src_seg) for vm in matches)
        pre = {vm.view: (vm.need_capacity, vm.total_candidates)
               for vm in matches if vm.overflow > 0}
        if not all(n > 0 for n, _t in pre.values()):
            pre = None   # capacities not measured (per-view engine rows)
        repl = rematch_views_exact_sharded(scene, cameras, neighbors,
                                           config, over, verbose=verbose,
                                           mesh=mesh, verified_hint=hint,
                                           precounted=pre)
    else:
        repl = rematch_views_exact(scene, cameras, neighbors, config, over,
                                   verbose=verbose)

    matches = [repl[vm.view][0] if vm.view in repl else vm for vm in matches]
    median_depths = median_depths.copy()
    for v, (_vm, _row, med) in repl.items():
        median_depths[v] = med
        cameras.median_depth[v] = med

    # rebuild BestMatches in view-ascending order (the concatenation order
    # is part of the downstream determinism contract), taking each view's
    # rows from the replacement when one exists
    views_all = sorted({int(x) for x in np.unique(best.view)} | set(repl))
    rows = []
    for v in views_all:
        if v in repl:
            if repl[v][1] is not None:
                rows.append(repl[v][1])
        else:
            m = best.view == v
            rows.append(dict(view=best.view[m], seg=best.seg[m],
                             tgt_view=best.tgt_view[m],
                             tgt_seg=best.tgt_seg[m], score=best.score[m],
                             P1=best.P1[m], P2=best.P2[m], dir=best.dir[m],
                             d1=best.d1[m], d2=best.d2[m]))
    return matches, _concat_best(rows), median_depths, len(over)


def prepare_sharded_matching(scene: Scene, cameras: CameraSet,
                             neighbors: list, config: L3DConfig,
                             mesh=None, warm_only: bool = False,
                             active_views=None):
    """Host-side assembly shared by the capacity probe and the matching
    dispatch: mesh/view-axis bucketing, the per-view metadata stacks, and
    the (single) upload of the replicated segment tensor.  Returns a prep
    dict, or None when there is nothing to match.  Sharing the prep lets
    the one-pass exact flow (dispatch_capacity_probe → decide →
    dispatch_matching_sharded) build the stacks and cross the host→device
    link once, not per program."""
    from ..parallel import mesh as mesh_mod, sharded

    V = scene.num_views
    S = scene.max_segments
    n_max = max((len(n) for n in neighbors), default=0)
    if n_max == 0:
        return None

    if mesh is None:
        mesh = mesh_mod.make_view_mesh()
    Vp = mesh_mod.pad_views_to_mesh(V, mesh,
                                    multiple=config.view_pad_multiple)
    # the replicated segment tensor [Vp, S, 4] is an input of every chunk
    # execution, so its view axis is part of the executable shape: bucket
    # the chunk count to powers of two and the framework only ever
    # compiles O(log V) matching executables (each new Vp is a fresh
    # compile of the scene-scale program; padded views are dead lax.cond
    # branches)
    chunk_step = mesh_mod.view_chunk_size(
        mesh, config.view_pad_multiple, axis=mesh.axis_names[0])
    if jax.process_count() == 1:
        n_chunks = -(-Vp // chunk_step)
        Vp = chunk_step * (1 << (n_chunks - 1).bit_length())
    n_pad = config.matching_neighbors \
        if config.stable_shapes and config.matching_neighbors > 0 else None
    segments, seg_mask, stacks, nb_ids = sharded.build_stacks(
        scene, cameras, neighbors, config, num_pad_views=Vp,
        num_pad_neighbors=n_pad)
    if warm_only:
        stacks["view_active"] = np.zeros_like(stacks["view_active"])
    elif active_views is not None:
        # subset re-run (the sharded uncapped rematch): only the listed
        # views execute; the rest take the dead lax.cond branch
        act = np.zeros_like(stacks["view_active"])
        act[np.asarray(list(active_views), np.int64)] = True
        stacks["view_active"] = stacks["view_active"] & act

    axis = mesh.axis_names[0]
    # multi-host: the stacks/segments are host-replicated numpy; hand each
    # device its slice of a GLOBAL array (jit over a multi-process mesh
    # rejects host-local inputs), and replicate the sharded output so
    # finalize can materialize it on every host.  Chunking is skipped —
    # per-chunk globalize/replicate round trips would serialize on DCN.
    multi = jax.process_count() > 1
    if multi:
        from jax.sharding import PartitionSpec as _P
        from ..parallel import multihost
        spec_of = lambda v: _P(axis, *([None] * (np.ndim(v) - 1)))  # noqa
        segments = multihost.globalize(mesh, _P(), segments)
        seg_mask = multihost.globalize(mesh, _P(), seg_mask)
        stacks = {k: multihost.globalize(mesh, spec_of(v), v)
                  for k, v in stacks.items()}
        chunk = Vp
    else:
        chunk = chunk_step
        # the replicated segment tensor crosses the host->device link
        # once, not once per chunk
        from jax.sharding import NamedSharding, PartitionSpec as _P
        repl = NamedSharding(mesh, _P())
        segments = jax.device_put(segments, repl)
        seg_mask = jax.device_put(seg_mask, repl)

    # trailing all-padding chunks (pow2 bucketing can add several) are
    # skipped on the host — finalize only reads rows of views with
    # neighbors, all of which precede last_active.  Chunk 0 is always
    # dispatched so warm_only still forces the compile/load.
    if multi:
        last_active = Vp - 1
    else:
        act = np.flatnonzero(np.asarray(stacks["view_active"]))
        last_active = int(act[-1]) if act.size else 0
    return dict(mesh=mesh, axis=axis, Vp=Vp, chunk=chunk, multi=multi,
                segments=segments, seg_mask=seg_mask, stacks=stacks,
                nb_ids=nb_ids, last_active=last_active, n_max=n_max, S=S,
                neighbors=neighbors)


def _dispatch_chunks(prep, launch):
    """Run `launch(stacks_chunk) -> lazy device array (or tuple)` over the
    prepared view chunks, queueing each chunk's readback so it overlaps
    the next chunk's execution; returns the list of lazy buffers.

    When launch returns a tuple, only its FIRST element is queued for
    readback — trailing elements stay device-resident (the deferred
    export plane, sliced to actual size later)."""
    from ..parallel import multihost

    stacks, chunk, Vp = prep["stacks"], prep["chunk"], prep["Vp"]
    bufs = []
    for c0 in range(0, Vp, chunk):
        if c0 > prep["last_active"]:
            break
        stacks_c = stacks if chunk == Vp else \
            {k: v[c0:c0 + chunk] for k, v in stacks.items()}
        buf = launch(stacks_c)
        if prep["multi"]:
            buf = multihost.replicate(prep["mesh"], buf)
        # queue the readback now: it starts the moment this chunk's
        # program retires, overlapping the remaining chunks' execution
        head = buf[0] if isinstance(buf, tuple) else buf
        if hasattr(head, "copy_to_host_async"):
            head.copy_to_host_async()
        bufs.append(buf)
    return bufs


def dispatch_capacity_probe(prep):
    """Launch the chunked capacity-probe program (pair gates only, [Vc, 4]
    int32 counters (need, total, blockmax, nbmax) per chunk —
    sharded.sharded_probe_all_views) WITHOUT blocking.
    Returns the list of lazy chunk buffers."""
    from ..parallel import sharded

    return _dispatch_chunks(prep, lambda stacks_c:
                            sharded.sharded_probe_all_views(
                                prep["segments"], prep["seg_mask"],
                                stacks_c, mesh=prep["mesh"]))


def finalize_capacity_probe(bufs):
    """Read back the probe chunks → (need [Vp], total [Vp], blockmax [Vp],
    nbmax [Vp]) int64 per view (zeros in padded/inactive rows)."""
    res = np.concatenate([np.asarray(b) for b in bufs]).astype(np.int64)
    return res[:, 0], res[:, 1], res[:, 2], res[:, 3]


def decide_exact_capacities(need, total, blockmax, nbmax,
                            config: L3DConfig, n_max: int, S: int,
                            k_export_per_seg: int = 8):
    """Pick the single-pass launch capacities from probe counters.

    Returns None when the DEFAULT capacities are already exact for every
    view (the default executable — typically pre-compiled by
    warmup_async — is reused), else a dict of overrides bucketed for
    executable reuse: m_total to the next power of two, the block quota to
    {default, 32, 64, 128} (coarse buckets: every new (quota, m_total,
    k_export) combination is a fresh compile of the scene-scale program;
    the compaction width B*quota drives the cross-neighbor merge sort,
    which is why 64 sits between 32 and 128), k_export to the next power
    of two
    of the strict gate-passing bound (verified ⊆ gate-passing, so the
    packed export can never drop and the fallback guard never fires), and
    the per-neighbor second-compaction width to pow2(nbmax) when that
    shrinks the cross-neighbor merge sort (its largest single cost at
    exact capacities).
    """
    need_max = int(np.max(need, initial=0))
    total_max = int(np.max(total, initial=0))
    bmax = int(np.max(blockmax, initial=0))
    nbm = int(np.max(nbmax, initial=0))

    # compact_rows_blockq raises the per-block quota to cover min_capacity
    # (= m_total) and caps it at the block width; the lossless test must
    # use that EFFECTIVE quota, or views that already fit the (pre-warmed)
    # default launch would trigger an override dispatch and pay a fresh
    # compile
    blk = 128
    while S % blk:
        blk //= 2
    B = S // blk

    def eff_quota(q, m):
        return min(max(q, -(-m // B)), blk)

    quota0 = config.match_block_quota
    m0 = min(config.max_matches_per_segment, n_max * S)
    k0 = min(S * k_export_per_seg, S * m0)
    if need_max <= m0 and bmax <= eff_quota(quota0, m0) and total_max <= k0:
        return None

    m_total = 1 << max(int(np.ceil(np.log2(max(need_max, 1)))), 0)
    m_total = min(max(m_total, m0), n_max * S)
    quota = 128
    for q in (quota0, 32, 64, 128):
        if eff_quota(q, m_total) >= bmax:
            quota = q
            break
    k_export = 1 << max(int(np.ceil(np.log2(max(total_max, 1)))), 0)
    k_export = min(max(k_export, k0), S * m_total)
    # block-compaction capacity per neighbor at the LAUNCH capacities; the
    # second compaction only helps if its pow2 width is smaller
    cap1 = B * eff_quota(quota, m_total)
    nb_cap = 1 << max(int(np.ceil(np.log2(max(nbm, 1)))), 0)
    per_nb_cap = nb_cap if nb_cap < cap1 else None
    return dict(quota=quota, m_total=m_total, k_export=k_export,
                per_nb_cap=per_nb_cap,
                need=need_max, total=total_max, blockmax=bmax, nbmax=nbm)


def dispatch_matching_sharded(scene: Scene, cameras: CameraSet,
                              neighbors: list, config: L3DConfig,
                              mesh=None, k_export_per_seg: int = 8,
                              warm_only: bool = False,
                              m_total_override: int | None = None,
                              quota_override: int | None = None,
                              k_export_override: int | None = None,
                              active_views=None, prepared=None,
                              defer_export: bool = False,
                              per_nb_cap_override: int | None = None):
    """Launch the whole-scene matching WITHOUT blocking.

    Returns (bufs, ctx) where bufs is a list of lazy packed [Vc, D] device
    arrays (one per view chunk, concatenating to [Vp, D]) and ctx carries
    what finalize_matching_sharded needs to decode them, or (None, None)
    when there is nothing to match.  Keeping dispatch separate from
    readback lets the pipeline overlap this program's compile /
    execution with other device programs and host work.

    The view axis is dispatched in chunks of lcm(mesh size,
    view_pad_multiple) views (one executable, many executions) rather than
    one whole-scene program, for two reasons:
      * each chunk's device->host copy (queued here) overlaps the next
        chunk's execution, so only the LAST chunk's readback sits on the
        critical path;
      * every scene size shares the same chunk-shaped executable, so one
        warmup covers all scenes and growing a scene never recompiles
        (a new scene-scale executable compiles for tens of seconds: the
        25-view facade's first run was 42 s against 0.54 s warm on an
        H100, PERF.md).

    warm_only=True marks every view inactive: the dispatched program is the
    SAME executable (view_active is a runtime input) so it forces the
    compile/load, but every per-view lax.cond takes the dead branch and
    execution costs ~ms instead of the full scene.

    `prepared` reuses a prepare_sharded_matching prep (the one-pass exact
    flow shares it with the capacity probe so stacks build and the segment
    upload happen once).
    """
    from ..parallel import sharded

    prep = prepared if prepared is not None else prepare_sharded_matching(
        scene, cameras, neighbors, config, mesh=mesh, warm_only=warm_only,
        active_views=active_views)
    if prep is None:
        return None, None
    n_max, S = prep["n_max"], prep["S"]

    m_total = m_total_override or \
        min(config.max_matches_per_segment, n_max * S)
    m_total = min(m_total, n_max * S)
    k_export = k_export_override or S * k_export_per_seg
    k_export = min(k_export, S * m_total)
    # deferred export: the [Vc, k_export] identity plane stays
    # device-resident; finalize slices it to the ACTUAL max verified count
    # before transfer.  Worth a dispatch round-trip only when the bound is
    # large (the exact path's strict gate-passing bound is ~4-8x the
    # verified count); multi-host keeps the single-shot path (the
    # replicate/globalize round trips would serialize on DCN).
    defer = bool(defer_export) and not prep["multi"]
    bufs = _dispatch_chunks(prep, lambda stacks_c:
                            sharded.sharded_match_all_views(
                                prep["segments"], prep["seg_mask"], stacks_c,
                                np.float32(config.sigma_p),
                                np.float32(config.sigma_a),
                                np.float32(config.confidence_threshold),
                                quota=quota_override or
                                config.match_block_quota,
                                m_total=m_total,
                                row_chunk=min(128, S),
                                k_export=k_export,
                                support_t=float(config.support_threshold),
                                mesh=prep["mesh"], packed=True,
                                defer_export=defer,
                                per_nb_cap=per_nb_cap_override))
    ctx = dict(nb_ids=prep["nb_ids"], S=S, k_export=k_export,
               neighbors=neighbors, defer_export=defer)
    return bufs, ctx


def warmup_matching_sharded(num_views: int, max_segments: int,
                            config: L3DConfig, mesh=None):
    """Dispatch the sharded matching program on dummy inputs with the
    shapes a real `num_views`-view scene will use (requires
    config.stable_shapes so the segment axis snaps to a shape bucket and
    the neighbor axis is scene-independent; `max_segments` must already be
    the bucketed size — Line3D.warmup_async does this).  Returns the lazy
    output buffer; keep it referenced until the real run has been
    dispatched.

    Each new executable compiles on first execution — tens of seconds
    for the scene-scale program — so the CLI calls this before detection
    starts and the cost hides behind host work.
    """
    from ..core.cameras import CameraSet as CS

    V = max(int(num_views), 4)
    rng = np.random.RandomState(0)
    K = np.tile(np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1.0]]),
                (V, 1, 1))
    R = np.tile(np.eye(3), (V, 1, 1))
    t = rng.randn(V, 3)
    cams = CS(K=K, R=R, t=t, width=np.full(V, 1920), height=np.full(V, 1080),
              uncertainty_lower_px=config.uncertainty_lower_px,
              uncertainty_upper_px=config.uncertainty_upper_px)
    scene = Scene(segments=np.zeros((V, max_segments, 4), np.float32),
                  seg_mask=np.zeros((V, max_segments), bool),
                  seg_count=np.zeros(V, np.int32), cameras=cams,
                  config=config)
    n_nb = config.matching_neighbors if config.matching_neighbors > 0 \
        else V - 1
    n_nb = min(n_nb, V - 1)
    neighbors = [[(v + 1 + i) % V for i in range(n_nb)] for v in range(V)]
    prep = prepare_sharded_matching(scene, cams, neighbors, config,
                                    mesh=mesh, warm_only=True)
    bufs = []
    if prep is not None and config.uncapped_fallback and \
            config.capacity_probe:
        # the one-pass exact flow runs the probe program first — warm it
        # with the same dead-branch trick
        bufs += dispatch_capacity_probe(prep)
    b, _ = dispatch_matching_sharded(scene, cams, neighbors, config,
                                     mesh=mesh, prepared=prep)
    return bufs + (b or [])


def finalize_matching_sharded(bufs, ctx, scene: Scene, cameras: CameraSet,
                              config: L3DConfig, verbose: bool = False,
                              only_views=None, timings: dict | None = None):
    """Read back dispatch_matching_sharded chunk buffers and rebuild the
    ViewMatches / BestMatches structures (blocks on the device).

    `only_views` restricts decoding to a view subset (the sharded uncapped
    rematch — rows of inactive views are dead-branch zeros and must not be
    decoded).  `timings` (optional dict) receives the wall-time split:
    t_match_rows (blocking on the chunked executions' row buffers — the
    device execution critical path), t_match_export (export slice +
    transfer), t_match_decode (host decode + f64 best rows)."""
    from ..parallel import sharded

    V = scene.num_views
    if bufs is None:
        return [], _empty_best(), np.ones(V)
    tm0 = time.perf_counter()
    S, k_export = ctx["S"], ctx["k_export"]
    neighbors, nb_ids = ctx["neighbors"], ctx["nb_ids"]
    exp_flat = exp_offs = None
    if ctx.get("defer_export"):
        # two-step readback: the small rows first (they carry n_verified),
        # then the device-resident export planes ragged-concatenated into
        # ONE flat buffer of exactly the verified entries (pow2-bucketed
        # sum) — the exact path's strict gate-passing bound would
        # otherwise ship 4-8x the real data over the device->host link,
        # and even the per-view rectangular slice ships
        # Vp * pow2(max-per-view) (~2x the sum at typical view variance)
        # in one transfer per chunk
        rows = [np.asarray(b[0]) for b in bufs]
        rows = rows[0] if len(rows) == 1 else np.concatenate(rows)
        tm1 = time.perf_counter()
        nver = np.minimum(rows.view(np.int32)[:, -4], k_export)  # n_verified
        total = int(nver.sum())
        k_flat = 1 << max(int(np.ceil(np.log2(max(total, 1)))), 10)
        k_flat = min(k_flat, len(nver) * k_export)
        flat = sharded.flatpack_export(nver, *[b[1] for b in bufs],
                                       k_flat=k_flat)
        if hasattr(flat, "copy_to_host_async"):
            flat.copy_to_host_async()
        exp_flat = np.asarray(flat)[:total]
        exp_offs = np.concatenate([[0], np.cumsum(nver)]).astype(np.int64)
        tm2 = time.perf_counter()
        out = sharded.unpack_view_outputs(
            rows, S, 0, exp_packed=np.zeros((rows.shape[0], 0), np.int32))
    else:
        chunks = [np.asarray(b) for b in bufs]  # chunk order = retire order
        tm1 = tm2 = time.perf_counter()
        out = sharded.unpack_view_outputs(
            chunks[0] if len(chunks) == 1 else np.concatenate(chunks),
            S, k_export)
    if timings is not None:
        timings["t_match_rows"] = tm1 - tm0
        timings["t_match_export"] = tm2 - tm1
        timings["_t_decode_start"] = time.perf_counter()

    median_depths = np.ones(V)
    views_iter = [v for v in (range(V) if only_views is None
                              else sorted(only_views))
                  if len(neighbors[v])]
    if not views_iter:
        return [], _empty_best(), median_depths
    va = np.asarray(views_iter, np.int64)

    # medians (computed on device, cudawrapper.cu:1025-1076)
    has_med = np.asarray(out["median_has"][va])
    median_depths[va[has_med]] = out["median_depth"][va][has_med]
    cameras.median_depth[va] = median_depths[va]

    # packed verified-match exports: decode ALL views in one vector pass
    # (the per-view loop's numpy overhead was ~0.4 s at 25 views and
    # O(V) at the 1000-view scale), then slice per view
    n_slots = nb_ids.shape[1]
    if exp_flat is not None:
        # flat layout: entries already valid and in global view order;
        # take the active views' [exp_offs[v], exp_offs[v]+nver[v]) runs
        counts = nver[va]
        if len(va) == len(nver) or counts.sum() == len(exp_flat):
            packed_sel = exp_flat
        else:
            packed_sel = np.concatenate(
                [exp_flat[exp_offs[v]:exp_offs[v + 1]] for v in va]) \
                if len(va) else exp_flat[:0]
        src_a, cam_a, tgt_a = sharded.unpack_export(packed_sel, S, n_slots)
    else:
        packed_all = out["exp_packed"][va]
        valid = packed_all >= 0
        counts = valid.sum(axis=1)
        src_a, cam_a, tgt_a = sharded.unpack_export(packed_all[valid], S,
                                                    n_slots)
    tgtv_a = nb_ids[np.repeat(va, counts), cam_a].astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(counts)])

    all_matches = []
    for i, v in enumerate(views_iter):
        sl = slice(offs[i], offs[i + 1])
        all_matches.append(ViewMatches(
            view=v,
            src_seg=src_a[sl],
            tgt_view=tgtv_a[sl],
            tgt_seg=tgt_a[sl],
            overflow=int(out["overflow"][v]),
            need_capacity=int(out["need_capacity"][v]),
            total_candidates=int(out["total_candidates"][v])))
        if verbose:
            print(f"[L3D] view {v}: {int(counts[i])} verified matches "
                  f"(sharded), median_depth={median_depths[v]:.4f}")

    # best rows: one batched f64 unprojection across every view (row
    # order = (view asc, seg asc), identical to the old per-view loop)
    bh = np.asarray(out["best_has"][va])
    vi, si = np.nonzero(bh)
    if len(vi):
        v_arr = va[vi]
        bconf = np.minimum(out["best_conf"][va][vi, si] /
                           config.confidence_norm, 1.0)
        bd = out["best_depths"][va][vi, si]
        best = _concat_best([_best_rows_f64_batched(
            scene, cameras, v_arr, si, bd[:, 0], bd[:, 1], bconf,
            nb_ids[v_arr, out["best_cam"][va][vi, si]],
            out["best_tgt"][va][vi, si])])
    else:
        best = _empty_best()
    if timings is not None:
        timings["t_match_decode"] = \
            time.perf_counter() - timings.pop("_t_decode_start")
    return all_matches, best, median_depths


def run_matching_sharded(scene: Scene, cameras: CameraSet, neighbors: list,
                         config: L3DConfig, verbose: bool = False,
                         mesh=None, k_export_per_seg: int = 8):
    """Sharded/batched variant of run_matching: the whole scene's matching
    runs as chunked executions of one view-bucketed device program over a
    views mesh (parallel/sharded.py) — each chunk's device->host copy
    overlaps the next chunk's execution — then the host reconstructs the
    same ViewMatches / BestMatches structures.  Equivalence with the
    per-view engine is covered by tests/test_sharding.py.
    """
    bufs, ctx = dispatch_matching_sharded(scene, cameras, neighbors, config,
                                          mesh=mesh,
                                          k_export_per_seg=k_export_per_seg)
    return finalize_matching_sharded(bufs, ctx, scene, cameras, config,
                                     verbose=verbose)


def _empty_best() -> BestMatches:
    z = np.zeros(0, np.int32)
    zf = np.zeros(0, np.float32)
    z3 = np.zeros((0, 3))
    return BestMatches(view=z, seg=z, tgt_view=z, tgt_seg=z, score=zf,
                       P1=z3, P2=z3, dir=z3, d1=zf, d2=zf)


def _concat_best(rows) -> BestMatches:
    if not rows:
        return _empty_best()
    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    return BestMatches(**cat)
