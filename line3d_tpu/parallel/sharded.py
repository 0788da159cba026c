"""Sharded (multi-chip) matching: all views matched in one pjit'd program
over a 1-D "views" mesh.

Layout: per-view camera/neighbor metadata is stacked on a leading V axis and
sharded over the mesh; the segment tensor [V, S, 4] stays REPLICATED (a
1000-view scene at 3072 segments is ~48 MB) and each view's neighbor
segments are gathered on device — the analogue of the reference's
texture broadcast + per-view loop (SURVEY.md §2 parallelism inventory).
Host<->device traffic is one dispatch for the whole scene instead of one per
view (the reference pays a kernel launch + download per neighbor,
cudawrapper.cu:897-944), so batching matters even on one card.

Inside each shard the views run through jax.lax.map (bounded memory), each
view reusing the same fused pairwise-match + scoring step as the single-chip
engine.  Outputs are compacted on device: per-segment best-match fields plus
a fixed-capacity export of verified matches (the clustering input), so
device->host traffic is O(verified matches), not O(S x M).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..scene import Scene
from ..match import pairwise, scoring


def export_bits(max_segments: int, n_slots: int):
    """Bit layout of the packed verified-match export word.

    Each exported match is one int32: src_seg | cam_slot | tgt_seg
    (high→low).  Identities travel packed and everything recomputable
    travels not at all, keeping device→host bytes O(verified matches).
    """
    sbits = max((max_segments - 1).bit_length(), 1)
    cbits = max((n_slots - 1).bit_length(), 1)
    if 2 * sbits + cbits > 31:
        raise ValueError(
            f"packed export needs {2 * sbits + cbits} bits "
            f"(S={max_segments}, neighbor slots={n_slots}) — exceeds int32")
    return sbits, cbits


def unpack_export(packed: np.ndarray, max_segments: int, n_slots: int):
    """Host-side unpack: packed [K] int32 (≥0) → (src, cam_slot, tgt)."""
    sbits, cbits = export_bits(max_segments, n_slots)
    src = (packed >> (cbits + sbits)).astype(np.int32)
    cam = ((packed >> sbits) & ((1 << cbits) - 1)).astype(np.int32)
    tgt = (packed & ((1 << sbits) - 1)).astype(np.int32)
    return src, cam, tgt


def _single_view_step(segments, seg_mask, args, quota, m_total, row_chunk,
                      conf_t, sigma_p, sigma_a, k_export, support_t=0.5,
                      per_nb_cap=None):
    (view_idx, RtKinv_src, C_src,
     nb_ids, F_nb, RtKinv_nb, C_nb, P_nb, nb_mask,
     spatial_k, view_active) = args

    # device-side gathers from the replicated segment tensor — the view's
    # own segments ride a [Vp] index instead of a second (sharded) copy of
    # the scene's largest tensor, halving the host->device upload
    segs_src = segments[view_idx]                     # [S, 4]
    mask_src = seg_mask[view_idx]
    nb_clip = jnp.maximum(nb_ids, 0)
    segs_nb = segments[nb_clip]                       # [N, S, 4]
    mask_nb = seg_mask[nb_clip] & (nb_ids >= 0)[:, None]

    res = pairwise.match_view_against_neighbors(
        segs_src, mask_src & view_active, RtKinv_src, C_src,
        segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, nb_mask, quota,
        min_capacity=m_total, per_nb_cap=per_nb_cap)

    cam, tgt, valid = pairwise.merge_neighbor_tables(
        res, m_total, segs_nb.shape[1])
    depths = pairwise.depths_for_matches(
        segs_src, segs_nb, cam, tgt, valid,
        F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb)

    conf = scoring.score_matches_best(
        segs_src, mask_src, RtKinv_src, C_src,
        cam, tgt, depths, valid, P_nb, segs_nb,
        sigma_p, sigma_a, spatial_k, row_chunk=row_chunk,
        support_threshold=support_t)

    out = device_select(cam, tgt, depths, valid, conf, conf_t, k_export,
                        nb_ids.shape[0])

    # capacity diagnostics: per-block quota drops + matches dropped when a
    # source segment's kept count exceeds the merge capacity m_total
    # (mirrors the per-view engine, engine.py _match_and_score_view) +
    # export-cap drops
    n_kept = jnp.sum(res["valid"], axis=(0, 2))       # per src seg
    merge_drop = jnp.sum(jnp.maximum(n_kept - cam.shape[1], 0))
    out["overflow"] = (res["overflow"].sum() + merge_drop
                       + out.pop("export_drop"))
    # exact capacity this view would need uncapped (raw gate-passing
    # counts, pre-quota): rides out so the uncapped fallback needs NO
    # separate counting dispatch (engine.rematch_views_exact_sharded)
    n_raw = res["n_valid"].sum(axis=0)                # [S]
    out["need_capacity"] = jnp.max(n_raw).astype(jnp.int32)
    out["total_candidates"] = jnp.sum(n_raw).astype(jnp.int32)
    return out


def device_select(cam, tgt, depths, valid, conf, conf_t, k_export,
                  n_slots):
    """Device-side selection over one view's scored match table: best match
    per segment, on-device median depth, and a fixed-capacity packed export
    of the verified matches (the per-view twin of the host selection in
    engine._select_view_outputs; shared by the sharded engine and the
    uncapped-exact rematch so the parity-critical selection has exactly one
    device formulation)."""
    keep = valid & (conf > conf_t)
    conf_keyed = jnp.where(keep, conf, -jnp.inf)
    best_m = jnp.argmax(conf_keyed, axis=1)
    take = lambda a: jnp.take_along_axis(a, best_m[:, None], axis=1)[:, 0]
    best_conf = take(conf)
    best_cam = take(cam)
    best_tgt = take(tgt)
    best_has = take(keep)
    best_d = jnp.take_along_axis(depths, best_m[:, None, None], axis=1)[:, 0]

    # median depth ON DEVICE (cudawrapper.cu:1025-1076): per-seg raw argmax,
    # then the median of the (d1, d2) pairs of segments whose best raw
    # confidence clears conf_t/2.  Host equivalent: np.sort(dall)[len//2]
    # with len = 2*nh — i.e. ascending-order element nh.  Invalid slots sort
    # to +inf past every real (finite, positive) depth.
    raw_keyed = jnp.where(valid, conf, -jnp.inf)
    raw_m = jnp.argmax(raw_keyed, axis=1)
    raw_max = jnp.take_along_axis(raw_keyed, raw_m[:, None], axis=1)[:, 0]
    raw_d = jnp.take_along_axis(depths, raw_m[:, None, None], axis=1)[:, 0, :2]
    has_raw = raw_max > conf_t * 0.5
    nh = jnp.sum(has_raw)
    dsorted = jnp.sort(jnp.where(has_raw[:, None], raw_d, jnp.inf).reshape(-1))
    median_depth = dsorted[jnp.minimum(nh, dsorted.size - 1)]

    # fixed-capacity export of verified matches for clustering — identities
    # only, packed one int32 each (depths/confidence are not consumed by
    # affinity construction, line3D.cc:861-865 fills the correspondence
    # lists from match identities; recomputables never cross the link)
    S_, M_ = keep.shape
    sbits, cbits = export_bits(S_, n_slots)
    flat_keep = keep.reshape(S_ * M_)
    k_export = min(k_export, S_ * M_)
    # ascending single-operand key sort of the PACKED VALUES replaces
    # lax.top_k-over-indices + two flat gathers: the merged table is
    # camera-major ascending within each row (merge_neighbor_tables' key
    # is cam*St + tgt), so ascending packed order == ascending flat-index
    # order and the sorted prefix IS the export — same entries, same
    # order, bit-identical.  No top_k at k ~ S*M/3 and no index gathers:
    # the packed build is a handful of [S, M] elementwise ops
    src_plane = jax.lax.broadcasted_iota(jnp.int32, (S_, M_), 0)
    packed_plane = ((src_plane << (cbits + sbits)) | (cam << sbits) | tgt)
    # validity threshold: every real packed value < S << (cbits+sbits);
    # int32 max as the pad key can never fall below it (2*sbits+cbits<=31)
    BIGT = jnp.int32(S_) << (cbits + sbits)
    keys = jnp.where(keep, packed_plane,
                     jnp.int32(0x7fffffff)).reshape(S_ * M_)
    sorted_packed = jax.lax.sort(keys)[:k_export]
    exp_valid = sorted_packed < BIGT
    packed = sorted_packed
    n_verified = jnp.sum(flat_keep)

    return dict(best_conf=best_conf, best_cam=best_cam,
                best_tgt=best_tgt, best_has=best_has,
                best_depths=best_d[:, :2],
                median_depth=median_depth,
                median_has=nh > 0,
                exp_packed=jnp.where(exp_valid, packed, -1),
                n_verified=n_verified,
                export_drop=jnp.maximum(n_verified - k_export, 0))


def _pack_view_outputs(o, k_export, defer_export=False):
    """Concat one view's outputs into a single f32 row (int32 planes ride
    as bitcasts).  Every device->host transfer pays a fixed overhead, so
    the engine ships ONE [Vp, D] array instead of the 10-array dict.

    With defer_export the packed-export plane is returned SEPARATELY (it
    stays device-resident; the engine later slices it to the actual
    verified size before transfer — see finalize_matching_sharded)."""
    f32 = jnp.float32
    bc = lambda a: jax.lax.bitcast_convert_type(a.astype(jnp.int32), f32)
    row = jnp.concatenate([
        *([] if defer_export else [bc(o["exp_packed"])]),  # [k_export] i32
        bc(o["best_cam"]), bc(o["best_tgt"]),     # [S] i32 each
        bc(o["best_has"]),                        # [S] i32 (0/1)
        o["best_conf"],                           # [S] f32
        o["best_depths"][:, 0], o["best_depths"][:, 1],   # [S] f32 each
        o["median_depth"][None], bc(o["median_has"][None]),
        bc(o["n_verified"][None]), bc(o["overflow"][None]),
        bc(o["need_capacity"][None]), bc(o["total_candidates"][None]),
    ])
    if defer_export:
        return row, o["exp_packed"]
    return row


def unpack_view_outputs(buf: np.ndarray, S: int, k_export: int,
                        exp_packed: np.ndarray | None = None):
    """Host-side inverse of _pack_view_outputs: [Vp, D] f32 -> dict with
    the same keys/dtypes sharded_match_all_views(packed=False) returns.
    `exp_packed` supplies the deferred-export plane when the row buffer
    was packed with defer_export (k_export then describes that plane's
    width, not a slice of `buf`)."""
    i32 = buf.view(np.int32)
    c = [0]

    def take(view, n):
        a = view[:, c[0]:c[0] + n]
        c[0] += n
        return a

    out = dict(exp_packed=exp_packed if exp_packed is not None
               else take(i32, k_export),
               best_cam=take(i32, S), best_tgt=take(i32, S),
               best_has=take(i32, S).astype(bool),
               best_conf=take(buf, S))
    d1 = take(buf, S)
    d2 = take(buf, S)
    out["best_depths"] = np.stack([d1, d2], axis=-1)
    out["median_depth"] = take(buf, 1)[:, 0]
    out["median_has"] = take(i32, 1)[:, 0].astype(bool)
    out["n_verified"] = take(i32, 1)[:, 0]
    out["overflow"] = take(i32, 1)[:, 0]
    out["need_capacity"] = take(i32, 1)[:, 0]
    out["total_candidates"] = take(i32, 1)[:, 0]
    assert c[0] == buf.shape[1], (c[0], buf.shape)
    return out


@functools.partial(jax.jit,
                   static_argnames=("quota", "m_total", "row_chunk",
                                    "k_export", "mesh", "axis", "packed",
                                    "support_t", "defer_export",
                                    "per_nb_cap"))
def sharded_match_all_views(segments, seg_mask, stacks,
                            sigma_p, sigma_a, conf_t,
                            quota, m_total, row_chunk, k_export,
                            mesh, axis="views", packed=False,
                            support_t: float = 0.5,
                            defer_export: bool = False,
                            per_nb_cap: int | None = None):
    """Match every view against its neighbors, sharded over `mesh`.

    segments [V, S, 4] / seg_mask [V, S] are replicated; `stacks` is a dict
    of per-view [Vp, ...] arrays (see build_stacks) sharded on the view
    axis.  Vp must be a multiple of the mesh size.  With packed=True the
    result is one [Vp, D] f32 array (see _pack_view_outputs) instead of the
    dict — the engine's transfer-friendly form.

    The view loop runs as a per-shard jax.lax.map INSIDE shard_map: each
    device scans only its own Vp/n views against the replicated segment
    tensor (zero communication).  A bare lax.map over the sharded axis
    would NOT partition — XLA cannot split a scan over its scanned
    dimension, so every device would execute all Vp steps on gathered
    data and multi-chip scaling would be silently zero.
    """
    from jax import shard_map

    spec_of = lambda v: P(axis, *([None] * (v.ndim - 1)))
    stack_specs = {k: spec_of(v) for k, v in stacks.items()}

    def local_views(segments, seg_mask, stacks_l, sigma_p, sigma_a, conf_t):
        def per_view(args):
            ordered = (args["view_idx"], args["RtKinv"], args["C"],
                       args["nb_ids"], args["F_nb"], args["RtKinv_nb"],
                       args["C_nb"], args["P_nb"], args["nb_mask"],
                       args["spatial_k"], args["view_active"])

            def live(_):
                o = _single_view_step(segments, seg_mask, ordered,
                                      quota, m_total, row_chunk,
                                      conf_t, sigma_p, sigma_a, k_export,
                                      support_t=support_t,
                                      per_nb_cap=per_nb_cap)
                if packed:
                    return _pack_view_outputs(o, k_export,
                                              defer_export=defer_export)
                return o

            # inactive views (padding slots and views without visual
            # neighbors) are skipped entirely — their outputs are never
            # read by engine.finalize_matching_sharded, so the dead branch
            # returns zeros.  Keeps the executable shape-stable
            # (view_active is a runtime array) while saving the full
            # per-view step for padded slots.
            def dead(_):
                shapes = jax.eval_shape(live, 0)
                return jax.tree_util.tree_map(
                    lambda s: jnp.zeros(s.shape, s.dtype), shapes)

            return jax.lax.cond(args["view_active"], live, dead, 0)

        return jax.lax.map(per_view, stacks_l)

    out_shapes = jax.eval_shape(local_views, segments, seg_mask, stacks,
                                sigma_p, sigma_a, conf_t)
    out_specs = jax.tree_util.tree_map(
        lambda s: P(axis, *([None] * (len(s.shape) - 1))), out_shapes)
    fn = shard_map(local_views, mesh=mesh,
                   in_specs=(P(), P(), stack_specs, P(), P(), P()),
                   out_specs=out_specs, check_vma=False)
    return fn(segments, seg_mask, stacks, sigma_p, sigma_a, conf_t)


def _single_view_probe(segments, seg_mask, args):
    """Capacity probe for one view: the pair gates only (the cheap ~1/3 of
    the per-view match step — no compaction, merge, depth or scoring work),
    reduced on device to the four counters the one-pass exact launch
    needs.  Returns [4] int32: (need, total, blockmax, nbmax) where
      need     = max over src segments of the cross-neighbor gate-passing
                 count — the exact uncapped per-segment merge capacity
                 (the reference's unbounded list length,
                 cudawrapper.cu:923-944),
      total    = sum of gate-passing counts — a strict upper bound on the
                 view's verified-match export size,
      blockmax = max per-(src segment, 128-target-lane block) count — the
                 exact per-block compaction quota (compact_rows_blockq),
      nbmax    = max per-(src segment, neighbor) count — the exact
                 per-neighbor second-compaction width (the cross-neighbor
                 merge sort then runs over N*pow2(nbmax) keys instead of
                 N*(S/128)*quota; at the facade's exact capacities that
                 would be a [S, 3840] merge sort).
    """
    (view_idx, RtKinv_src, C_src,
     nb_ids, F_nb, RtKinv_nb, C_nb, nb_mask, view_active) = args

    segs_src = segments[view_idx]
    mask_src = seg_mask[view_idx] & view_active
    nb_clip = jnp.maximum(nb_ids, 0)
    segs_nb = segments[nb_clip]
    mask_nb = seg_mask[nb_clip] & (nb_ids >= 0)[:, None]

    S = segs_src.shape[0]
    St = segs_nb.shape[1]
    blk = 128                     # same block size rule as compact_rows_blockq
    while St % blk:
        blk //= 2
    B = St // blk

    def step(carry, nb):
        n_acc, bmax, nmax = carry
        segs_t, mask_t, F, RtKinv_t, C_t = nb
        valid = pairwise.match_pair_valid(
            segs_src, segs_t, mask_src, mask_t,
            F, RtKinv_src, RtKinv_t, C_src, C_t,
            pairwise.MIN_OVERLAP_LOWER, pairwise.MIN_OVERLAP_UPPER)
        ncnt = jnp.sum(valid, axis=1).astype(jnp.int32)
        n_acc = n_acc + ncnt
        bcnt = jnp.sum(valid.reshape(S, B, blk), axis=2)
        bmax = jnp.maximum(bmax, jnp.max(bcnt).astype(jnp.int32))
        nmax = jnp.maximum(nmax, jnp.max(ncnt))
        return (n_acc, bmax, nmax), None

    (n_raw, bmax, nmax), _ = jax.lax.scan(
        step, (jnp.zeros(S, jnp.int32), jnp.int32(0), jnp.int32(0)),
        (segs_nb, mask_nb & nb_mask[:, None], F_nb, RtKinv_nb, C_nb))
    return jnp.stack([jnp.max(n_raw), jnp.sum(n_raw), bmax, nmax])


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def sharded_probe_all_views(segments, seg_mask, stacks, mesh, axis="views"):
    """Chunked/sharded capacity probe: [Vc, 4] int32 per chunk (see
    _single_view_probe).  Same shard_map/lax.map structure as
    sharded_match_all_views — each device probes only its own view shard
    against the replicated segment tensor, zero communication; inactive
    (padding) views take the dead branch and contribute zeros."""
    from jax import shard_map

    spec_of = lambda v: P(axis, *([None] * (v.ndim - 1)))
    stack_specs = {k: spec_of(v) for k, v in stacks.items()}

    def local_views(segments, seg_mask, stacks_l):
        def per_view(args):
            ordered = (args["view_idx"], args["RtKinv"], args["C"],
                       args["nb_ids"], args["F_nb"], args["RtKinv_nb"],
                       args["C_nb"], args["nb_mask"], args["view_active"])
            return jax.lax.cond(
                args["view_active"],
                lambda _: _single_view_probe(segments, seg_mask, ordered),
                lambda _: jnp.zeros(4, jnp.int32), 0)

        return jax.lax.map(per_view, stacks_l)

    fn = shard_map(local_views, mesh=mesh,
                   in_specs=(P(), P(), stack_specs),
                   out_specs=P(axis, None), check_vma=False)
    return fn(segments, seg_mask, stacks)


@functools.partial(jax.jit, static_argnames=("k",))
def slice_export(exp, k: int):
    """Slice a device-resident deferred-export plane [Vc, K] to [Vc, k]
    before transfer (valid entries are packed to the front by the top_k in
    device_select, so any k >= the max per-view verified count is
    lossless)."""
    return exp[:, :k]


@functools.partial(jax.jit, static_argnames=("k_flat",))
def flatpack_export(nver, *exps, k_flat: int):
    """Ragged-concat the valid prefixes of the deferred-export planes
    (one [Vc, K] per chunk) into ONE flat [k_flat] buffer in global view
    order.

    Each plane row is front-packed by device_select's top_k, and
    n_verified (from the already-transferred row buffers) gives the exact
    valid prefix length per view — so the flat buffer carries exactly the
    verified entries (k_flat = pow2 bucket of their sum), instead of
    Vp * pow2(max-per-view) under the per-view rectangular slice.  One
    program + one device->host copy also replaces one slice + copy per
    chunk (each transfer pays a fixed overhead).
    Entries beyond the real total are -1 (the host slices them off)."""
    exp = exps[0] if len(exps) == 1 else jnp.concatenate(exps, axis=0)
    Vp, K = exp.shape
    cnt = jnp.minimum(nver, K)
    off = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(cnt).astype(jnp.int32)])
    i = jnp.arange(k_flat, dtype=jnp.int32)
    # view of flat position i = #{v : off[v+1] <= i} (a [Vp, k_flat]
    # compare-reduce; off is tiny, and this avoids a scan-lowered binary
    # search)
    v = jnp.clip(jnp.sum((off[1:, None] <= i[None, :]).astype(jnp.int32),
                         axis=0), 0, Vp - 1)
    j = i - off[v]
    ok = i < off[Vp]
    idx = v * K + jnp.minimum(j, K - 1)
    return jnp.where(ok, exp.reshape(-1)[idx], jnp.int32(-1))


def build_stacks(scene: Scene, cameras: CameraSet, neighbors: list,
                 config: L3DConfig, num_pad_views: int | None = None,
                 num_pad_neighbors: int | None = None):
    """Host-side assembly of the per-view metadata stacks.

    Returns (segments [Vp, S, 4] — the single replicated copy; the view's
    own segments are gathered on device via stacks["view_idx"], so the
    scene's largest tensor crosses the host->device link exactly once,
    seg_mask, stacks dict, nb_ids [Vp, N]).  `num_pad_neighbors` pads the
    neighbor axis beyond the scene's actual maximum (shape stability,
    L3DConfig.stable_shapes).
    """
    V = scene.num_views
    Vp = num_pad_views or V
    S = scene.max_segments
    n_max = max((len(n) for n in neighbors), default=1)
    n_max = max(n_max, 1, num_pad_neighbors or 0)

    segments = np.zeros((Vp, S, 4), np.float32)
    seg_mask = np.zeros((Vp, S), bool)
    segments[:V] = scene.segments
    seg_mask[:V] = scene.seg_mask

    RtKinv = np.zeros((Vp, 3, 3), np.float32)
    C = np.zeros((Vp, 3), np.float32)
    RtKinv[:V] = cameras.f32("RtKinv")
    C[:V] = cameras.f32("C")

    F_nb = np.zeros((Vp, n_max, 3, 3), np.float32)
    RtKinv_nb = np.zeros((Vp, n_max, 3, 3), np.float32)
    C_nb = np.zeros((Vp, n_max, 3), np.float32)
    P_nb = np.zeros((Vp, n_max, 3, 4), np.float32)
    nb_mask = np.zeros((Vp, n_max), bool)
    nb_ids = np.full((Vp, n_max), -1, np.int32)
    view_active = np.zeros(Vp, bool)
    spatial_k = np.zeros(Vp, np.float32)

    P32 = cameras.f32("P")
    sk = cameras.spatial_uncertainty_k(2.0 * config.sigma_p)

    for v in range(V):
        nb = np.asarray(neighbors[v], np.int64)
        if len(nb) == 0:
            continue
        view_active[v] = True
        spatial_k[v] = sk[v]
        k = len(nb)
        nb_ids[v, :k] = nb
        nb_mask[v, :k] = True
        F_nb[v, :k] = cameras.fundamentals_for_pairs(
            np.stack([np.full(k, v), nb], axis=1)).astype(np.float32)
        RtKinv_nb[v, :k] = cameras.RtKinv[nb].astype(np.float32)
        C_nb[v, :k] = cameras.C[nb].astype(np.float32)
        P_nb[v, :k] = P32[nb]

    stacks = dict(view_idx=np.arange(Vp, dtype=np.int32),
                  RtKinv=RtKinv, C=C, nb_ids=nb_ids,
                  F_nb=F_nb, RtKinv_nb=RtKinv_nb, C_nb=C_nb, P_nb=P_nb,
                  nb_mask=nb_mask, spatial_k=spatial_k,
                  view_active=view_active)
    return segments, seg_mask, stacks, nb_ids
