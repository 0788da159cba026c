"""Per-view 2D segment collinearity.

Device equivalent of K_collinearity (reference: cudawrapper.cu:476-535)
launched from L3DSegments (segments.h:73-101): for every segment pair in one
view, a mutual max endpoint-to-line distance Gaussian (sigma = 2.0,
commons.h:48), kept if > 0.5 (L3D_COLLIN_AFF_T_G) AND the segments do not
overlap along their common direction (all four mutual endpoint dot products
positive).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import geometry as g


@functools.partial(jax.jit, static_argnames=("aff_threshold",))
def collinearity_matrix(segs, mask, coll_sigma_sq, aff_threshold: float = 0.5):
    """Dense [S, S] collinearity scores for one view (0 where not collinear).

    Args:
      segs: [S, 4] float32; mask: [S] bool; coll_sigma_sq: sigma^2 scalar.
      aff_threshold: keep gate (L3D_COLLIN_AFF_T_G = 0.5, cudawrapper.h:44).
    """
    p1, p2 = g.seg_endpoints(segs)
    line = g.line_through(p1, p2)                   # [S, 3]

    # mutual max endpoint-to-line distances (cudawrapper.cu:509-511)
    d_p_on_q = jnp.maximum(
        g.dist_point_line_2d(line[None, :, :], p1[:, None, :]),
        g.dist_point_line_2d(line[None, :, :], p2[:, None, :]))  # [i, j]: i's pts on j's line
    d = jnp.maximum(d_p_on_q, d_p_on_q.T)
    aff = jnp.exp(-d * d / (2.0 * coll_sigma_sq))

    # no-overlap check (cudawrapper.cu:518-528): all mutual dot products
    # positive -> segments lie outside one another along the line
    a1 = p1[:, None, 0:2]
    a2 = p2[:, None, 0:2]
    b1 = p1[None, :, 0:2]
    b2 = p2[None, :, 0:2]
    dot = lambda u, v: jnp.sum(u * v, axis=-1)
    pos1 = dot(b1 - a1, b2 - a1)
    pos2 = dot(b1 - a2, b2 - a2)
    pos3 = dot(a1 - b1, a2 - b1)
    pos4 = dot(a1 - b2, a2 - b2)
    eps = g.EPS
    no_overlap = (pos1 > -eps) & (pos2 > -eps) & (pos3 > -eps) & (pos4 > -eps)

    keep = (aff > aff_threshold) & no_overlap & mask[:, None] & mask[None, :]
    keep = keep & ~jnp.eye(segs.shape[0], dtype=bool)
    return jnp.where(keep, aff, 0.0)


def collinearity_maps(scene_segments, scene_mask, coll_sigma: float):
    """Sparse per-view collinearity maps for all views.

    Returns a list (len V) of dicts {seg_i: {seg_j: weight}}, matching
    L3DSegments::collinearities (segments.h:115-117).
    """
    V = scene_segments.shape[0]
    out = []
    sig2 = np.float32(coll_sigma * coll_sigma)
    for v in range(V):
        m = np.asarray(collinearity_matrix(
            jnp.asarray(scene_segments[v]), jnp.asarray(scene_mask[v]), sig2))
        ii, jj = np.nonzero(m > 0.0)
        d: dict = {}
        for i, j in zip(ii.tolist(), jj.tolist()):
            d.setdefault(i, {})[j] = float(m[i, j])
        out.append(d)
    return out


def _pair_aff(si, sj, mask_i, mask_j, not_self, coll_sigma_sq,
              aff_threshold: float = 0.5):
    """Collinearity affinity for explicit segment pairs.

    si: [S, 4] (row segment, broadcast over K); sj: [S, K, 4] partners.
    Same math as collinearity_matrix, evaluated only at the given pairs.
    Returns [S, K] weights (0 where gated out).
    """
    p1x, p1y = si[:, 0:1], si[:, 1:2]
    p2x, p2y = si[:, 2:3], si[:, 3:4]
    q1x, q1y = sj[..., 0], sj[..., 1]
    q2x, q2y = sj[..., 2], sj[..., 3]

    # supporting lines (cross of homogeneous endpoints), elementwise
    lia = p1y - p2y; lib = p2x - p1x; lic = p1x * p2y - p1y * p2x  # [S, 1]
    lja = q1y - q2y; ljb = q2x - q1x; ljc = q1x * q2y - q1y * q2x  # [S, K]

    def dist(a, b, c, x, y):
        den = jnp.sqrt(jnp.maximum(a * a + b * b, g.EPS))
        return jnp.abs(a * x + b * y + c) / den

    d = jnp.maximum(
        jnp.maximum(dist(lja, ljb, ljc, p1x, p1y),
                    dist(lja, ljb, ljc, p2x, p2y)),
        jnp.maximum(dist(lia, lib, lic, q1x, q1y),
                    dist(lia, lib, lic, q2x, q2y)))
    aff = jnp.exp(-d * d / (2.0 * coll_sigma_sq))

    dot = lambda ux, uy, vx, vy: ux * vx + uy * vy
    pos1 = dot(q1x - p1x, q1y - p1y, q2x - p1x, q2y - p1y)
    pos2 = dot(q1x - p2x, q1y - p2y, q2x - p2x, q2y - p2y)
    pos3 = dot(p1x - q1x, p1y - q1y, p2x - q1x, p2y - q1y)
    pos4 = dot(p1x - q2x, p1y - q2y, p2x - q2x, p2y - q2y)
    eps = g.EPS
    no_overlap = (pos1 > -eps) & (pos2 > -eps) & \
                 (pos3 > -eps) & (pos4 > -eps)

    keep = (aff > aff_threshold) & no_overlap & mask_i & mask_j & not_self
    return jnp.where(keep, aff, 0.0)


def _pairs_cap(S: int, K: int, quota: int, pairs_per_seg: int = 4) -> int:
    """Static per-view cap on exported collinear pairs (shape-derived)."""
    return min(S * K, max(8192, pairs_per_seg * S))


@functools.partial(jax.jit, static_argnames=("quota", "pairs_per_seg",
                                              "aff_threshold"))
def collinearity_compact_all(segments, masks, coll_sigma_sq, quota=8,
                             pairs_per_seg: int = 4,
                             aff_threshold: float = 0.5):
    """All views' collinearity maps, compacted ON DEVICE to flat pair lists.

    Transferring the dense [S, S] maps to host costs ~37 MB/view over the
    device link, and even per-row [S, 64] partner tables cost
    ~25 MB/scene.  Instead: the [S, S]
    keep-plane is compacted per 128-partner block
    (pairwise.compact_rows_blockq), the affinity recomputed at the kept
    pairs, and each view's surviving (i, j) pairs packed as i*S+j keys and
    merged by one batched int32 sort (payload = f32 weight; the sort axis
    is ~1M long, where a single payload operand is cheap) into a flat
    [C] list — ~0.2 MB/view exported at production shape.

    Returns (pairs [V, C] int32 packed i*S+j (-1 pads),
             w [V, C] f32 (0 pads),
             count [V] int32 true pre-quota pair count (> number exported
             means the block quota or the cap dropped pairs)).
    """
    from .pairwise import compact_rows_blockq

    def per_view(args):
        segs, mask = args

        def live(_):
            keep = collinearity_matrix(
                segs, mask, coll_sigma_sq,
                aff_threshold=aff_threshold) > 0.0
            tgt, kept, n_valid = compact_rows_blockq(keep, quota)
            sj = segs[jnp.maximum(tgt, 0)]              # [S, K, 4]
            iota = jax.lax.broadcasted_iota(jnp.int32, tgt.shape, 0)
            # kept slots come from the keep plane, which already gated on
            # mask_i & mask_j — re-gathering mask[tgt] here is redundant
            # (a pred[S] gather at S*K indices)
            w = _pair_aff(segs, sj, mask[:, None], kept,
                          tgt != iota, coll_sigma_sq,
                          aff_threshold=aff_threshold)
            return tgt, w, jnp.sum(n_valid)

        # fully-masked views (view-axis padding slots) skip the whole
        # plane; w = 0 rows vanish in the merge sort below
        def dead(_):
            shapes = jax.eval_shape(live, 0)
            return jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), shapes)

        return jax.lax.cond(jnp.any(mask), live, dead, 0)

    # [V, S, K] intermediates stay on device; the merge sort runs batched
    # over the flattened pair axis OUTSIDE the map (one batched 2-D sort
    # instead of one sort per scan/map step).
    tgt, w, count = jax.lax.map(per_view, (segments, masks))
    V, S, K = w.shape
    C = _pairs_cap(S, K, quota, pairs_per_seg)
    row = jax.lax.broadcasted_iota(jnp.int32, (V, S, K), 1)
    key = jnp.where(w > 0.0, row * S + tgt, jnp.int32(S) * S)
    skey, sw = jax.lax.sort(
        (key.reshape(V, S * K), w.reshape(V, S * K)), dimension=1,
        num_keys=1)
    skey, sw = skey[:, :C], sw[:, :C]
    valid = skey < S * S
    return (jnp.where(valid, skey, -1), jnp.where(valid, sw, 0.0), count)


def collinearity_dispatch(scene_segments, scene_mask, coll_sigma: float,
                          quota: int = 8,
                          num_pad_views: int | None = None,
                          pairs_per_seg: int = 4,
                          aff_threshold: float = 0.5):
    """Launch the device-compacted collinearity program WITHOUT blocking.

    Returns lazy device arrays (pairs, w, count); pass them to
    collinearity_finalize to read back.  Splitting dispatch from readback
    lets the pipeline overlap this program's first-execution compile with
    the matching program's.

    `num_pad_views` pads the view axis (extra views fully masked) so the
    compiled program shape is bucket-stable across scenes.
    """
    segs = np.asarray(scene_segments, np.float32)
    mask = np.asarray(scene_mask, bool)
    V = segs.shape[0]
    if num_pad_views is not None and num_pad_views > V:
        pad = num_pad_views - V
        segs = np.pad(segs, [(0, pad), (0, 0), (0, 0)])
        mask = np.pad(mask, [(0, pad), (0, 0)])
    sig2 = np.float32(coll_sigma * coll_sigma)
    return collinearity_compact_all(
        jnp.asarray(segs), jnp.asarray(mask), sig2, quota=quota,
        pairs_per_seg=pairs_per_seg, aff_threshold=float(aff_threshold))


def collinearity_dispatch_chunked(scene_segments, scene_mask,
                                  coll_sigma: float, chunk: int,
                                  quota: int = 8,
                                  num_pad_views: int | None = None,
                                  pairs_per_seg: int = 4,
                                  aff_threshold: float = 0.5):
    """Launch the collinearity program in `chunk`-view pieces.

    Same math as collinearity_dispatch, but every scene size executes the
    SAME [chunk, S, ...]-shaped executable (the whole-scene program's view
    axis bakes Vp into the executable, so each new scene size paid a fresh
    compile), and each chunk's
    device->host copy (queued here) overlaps the later chunks' — and the
    matching program's — execution.  Collinearity is per-view work
    (K_collinearity runs one view at a time in the reference,
    segments.h:73-101), so chunking changes nothing semantically.

    Returns a list of (pairs [chunk, C], w [chunk, C], count [chunk])
    lazy device triples; pass to collinearity_finalize_chunked.
    """
    segs = np.asarray(scene_segments, np.float32)
    mask = np.asarray(scene_mask, bool)
    V = segs.shape[0]
    Vp = num_pad_views if num_pad_views and num_pad_views > V else V
    Vp = -(-Vp // chunk) * chunk
    if Vp > V:
        segs = np.pad(segs, [(0, Vp - V), (0, 0), (0, 0)])
        mask = np.pad(mask, [(0, Vp - V), (0, 0)])
    sig2 = np.float32(coll_sigma * coll_sigma)
    out = []
    for c0 in range(0, Vp, chunk):
        triple = collinearity_compact_all(
            jnp.asarray(segs[c0:c0 + chunk]),
            jnp.asarray(mask[c0:c0 + chunk]), sig2, quota=quota,
            pairs_per_seg=pairs_per_seg,
            aff_threshold=float(aff_threshold))
        for arr in triple:
            if hasattr(arr, "copy_to_host_async"):
                arr.copy_to_host_async()
        out.append(triple)
    return out


def collinearity_finalize_chunked(chunks, max_segments: int,
                                  num_views: int | None = None,
                                  verbose=False):
    """Read back collinearity_dispatch_chunked results (blocks)."""
    pairs = np.concatenate([np.asarray(c[0]) for c in chunks])
    w = np.concatenate([np.asarray(c[1]) for c in chunks])
    count = np.concatenate([np.asarray(c[2]) for c in chunks])
    return collinearity_finalize(pairs, w, count, max_segments=max_segments,
                                 num_views=num_views, verbose=verbose)


class CollinMaps(list):
    """Per-view sparse collinearity maps: a list of {seg_i: {seg_j: w}}
    dicts (the L3DSegments::collinearities shape, segments.h:115-117) that
    ALSO carries the flat sorted pair arrays it was decoded from, so bulk
    consumers (cluster/affinity.py) can build CSR indices with numpy
    instead of iterating millions of dict entries.

    flat_view [P] int32, flat_i / flat_j [P] int32, flat_w [P] f32 —
    sorted by (view, i, j) ascending (the device export order).

    dropped_per_view [V] int64 counts pairs the export quota/cap dropped
    in each view (0 everywhere proves the compacted export equals the
    reference's unbounded sparse map, segments.h:76-100);
    dropped_total is its sum.
    """
    flat_view: np.ndarray = None
    flat_i: np.ndarray = None
    flat_j: np.ndarray = None
    flat_w: np.ndarray = None
    dropped_per_view: np.ndarray = None
    dropped_total: int = 0


def collinearity_finalize(pairs, w, count, max_segments: int,
                          num_views: int | None = None, verbose=False):
    """Read back a collinearity_dispatch result and build the per-view
    sparse maps ({seg_i: {seg_j: weight}} per view, segments.h:115-117)."""
    pairs = np.asarray(pairs)
    w = np.asarray(w)
    count = np.asarray(count)
    S = max_segments
    V = pairs.shape[0] if num_views is None else num_views
    exported = (pairs[:V] >= 0).sum(axis=1)
    dropped_pv = np.maximum(count[:V].astype(np.int64) - exported, 0)
    dropped = int(dropped_pv.sum())
    if dropped:
        # unconditional: a result-affecting drop must never be silent (the
        # reference keeps every pair, segments.h:76-100); the pipeline's
        # collinearity_exact_fallback guard repairs the affected views
        print(f"[L3D] WARNING: collinearity quota/cap dropped up to "
              f"{dropped} pairs across "
              f"{int((dropped_pv > 0).sum())} view(s) (raise "
              f"collinearity_pairs_per_seg, or rely on "
              f"collinearity_exact_fallback)")
    out = CollinMaps()
    out.dropped_per_view = dropped_pv
    out.dropped_total = dropped
    fv, fi, fj, fw = [], [], [], []
    for v in range(V):
        d: dict = {}
        pv = pairs[v]
        sel = pv >= 0
        kept_p = pv[sel]
        kept_w = w[v][sel]
        fv.append(np.full(len(kept_p), v, np.int32))
        fi.append((kept_p // S).astype(np.int32))
        fj.append((kept_p % S).astype(np.int32))
        fw.append(kept_w.astype(np.float32))
        for p, wij in zip(kept_p.tolist(), kept_w.tolist()):
            d.setdefault(p // S, {})[p % S] = wij
        out.append(d)
    out.flat_view = np.concatenate(fv) if fv else np.zeros(0, np.int32)
    out.flat_i = np.concatenate(fi) if fi else np.zeros(0, np.int32)
    out.flat_j = np.concatenate(fj) if fj else np.zeros(0, np.int32)
    out.flat_w = np.concatenate(fw) if fw else np.zeros(0, np.float32)
    return out


def apply_collinearity_exact_fallback(coll: CollinMaps, scene_segments,
                                      scene_mask, coll_sigma: float,
                                      aff_threshold: float = 0.5,
                                      verbose: bool = False):
    """Re-derive overflowed views' collinearity maps EXACTLY.

    Reference-exactness guard mirroring engine.apply_uncapped_fallback:
    the reference keeps every collinear pair (segments.h:76-100), while the
    device export path bounds the per-view pair list by a block quota and a
    flat cap.  Collinearity is strictly view-local (K_collinearity runs one
    view at a time, cudawrapper.cu:833-855), so recomputing only the views
    whose drop counter is nonzero from the dense [S, S] matrix — which by
    construction holds ALL pairs — yields maps equal to a fully uncapped
    run.  Returns (patched CollinMaps, number of views recomputed).
    """
    if coll.dropped_per_view is None or coll.dropped_total == 0:
        return coll, 0
    views = np.nonzero(coll.dropped_per_view > 0)[0]
    S = scene_segments.shape[1]
    sig2 = np.float32(coll_sigma * coll_sigma)
    # per-view boundaries in the (view-sorted) flat arrays
    starts = np.searchsorted(coll.flat_view, np.arange(len(coll) + 1))
    fv, fi, fj, fw = [], [], [], []
    prev = 0
    for v in views.tolist():
        m = np.asarray(collinearity_matrix(
            jnp.asarray(scene_segments[v]), jnp.asarray(scene_mask[v]),
            sig2, aff_threshold=float(aff_threshold)))
        ii, jj = np.nonzero(m > 0.0)          # row-major == (i, j) ascending
        d: dict = {}
        for i, j in zip(ii.tolist(), jj.tolist()):
            d.setdefault(i, {})[j] = float(m[i, j])
        coll[v] = d
        # untouched views [prev, v) keep their flat slices; view v is rebuilt
        sl = slice(starts[prev], starts[v])
        fv.append(coll.flat_view[sl]); fi.append(coll.flat_i[sl])
        fj.append(coll.flat_j[sl]);    fw.append(coll.flat_w[sl])
        fv.append(np.full(len(ii), v, np.int32))
        fi.append(ii.astype(np.int32)); fj.append(jj.astype(np.int32))
        fw.append(m[ii, jj].astype(np.float32))
        prev = v + 1
        if verbose:
            print(f"[L3D] view {v}: collinearity re-derived exactly "
                  f"({len(ii)} pairs)")
    sl = slice(starts[prev], starts[len(coll)])
    fv.append(coll.flat_view[sl]); fi.append(coll.flat_i[sl])
    fj.append(coll.flat_j[sl]);    fw.append(coll.flat_w[sl])
    coll.flat_view = np.concatenate(fv)
    coll.flat_i = np.concatenate(fi)
    coll.flat_j = np.concatenate(fj)
    coll.flat_w = np.concatenate(fw)
    # the patched maps are exact: zero the drop counters (capture
    # dropped_total BEFORE calling if the pre-fallback count is wanted)
    coll.dropped_per_view = np.zeros_like(coll.dropped_per_view)
    coll.dropped_total = 0
    return coll, int(len(views))


def collinearity_maps_fast(scene_segments, scene_mask, coll_sigma: float,
                           quota: int = 8,
                           num_pad_views: int | None = None,
                           pairs_per_seg: int = 4,
                           aff_threshold: float = 0.5):
    """Drop-in replacement for collinearity_maps using the device-compacted
    path (one dispatch for the whole scene)."""
    pairs, w, count = collinearity_dispatch(
        scene_segments, scene_mask, coll_sigma, quota=quota,
        num_pad_views=num_pad_views, pairs_per_seg=pairs_per_seg,
        aff_threshold=aff_threshold)
    return collinearity_finalize(pairs, w, count,
                                 max_segments=scene_segments.shape[1],
                                 num_views=len(scene_segments))
