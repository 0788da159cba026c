"""Batched pairwise line-segment matching between a source view and a stack of
neighbor views.

Device equivalent of K_pairwise_matches (reference: cudawrapper.cu:538-611)
and its host driver loop (cudawrapper.cu:897-944): instead of one CUDA grid
per neighbor plus a host download/sort, the whole [N, S_src, S_tgt] pair
volume is evaluated in one fused XLA program and compacted on-device into a
fixed-width per-source-segment match table.

Semantics per (src segment p, tgt segment q):
  1. epipolar lines of p's endpoints in the target view (l = F p) and of q's
     endpoints in the source view (l = F^T q),
  2. intersect with the opposite segment's supporting line,
  3. 2D overlap gate: min(overlap) > 0.10 and max(overlap) > 0.30
     (cudawrapper.h:45-46),
  4. two-ray triangulation of all four endpoint correspondences; a match is
     kept iff all four depths are positive (cudawrapper.cu:931).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import geometry as g

# epipolar-overlap gate defaults (cudawrapper.cu:512-520: at least 10% on
# both segments, 30% on one).  The capacity probe and the benchmarks gate
# with the SAME constants — the probe's exactness guarantee ("same pair
# kernel, same inputs as the mainline") holds only if these never drift.
MIN_OVERLAP_LOWER = 0.10
MIN_OVERLAP_UPPER = 0.30


def match_pair_dense_reference(segs_src, segs_tgt, mask_src, mask_tgt,
                               F, RtKinv_src, RtKinv_tgt, C_src, C_tgt,
                               min_overlap_lower=MIN_OVERLAP_LOWER,
                               min_overlap_upper=MIN_OVERLAP_UPPER):
    """Readable array-of-structs formulation built from core.geometry.

    Used as the semantic reference in tests; the production formulation
    below is the structure-of-arrays rewrite (identical math; component
    planes instead of [S, S, 3] tensors with a minor dim of 3).
    """
    p1, p2 = g.seg_endpoints(segs_src)            # [Ss, 3]
    q1, q2 = g.seg_endpoints(segs_tgt)            # [St, 3]

    line1 = g.line_through(p1, p2)[:, None, :]    # src lines   [Ss, 1, 3]
    line2 = g.line_through(q1, q2)[None, :, :]    # tgt lines   [1, St, 3]

    epi_p1 = g.epipolar_line(F, p1)[:, None, :]   # [Ss, 1, 3]
    epi_p2 = g.epipolar_line(F, p2)[:, None, :]
    Ft = F.T
    epi_q1 = g.epipolar_line(Ft, q1)[None, :, :]  # [1, St, 3]
    epi_q2 = g.epipolar_line(Ft, q2)[None, :, :]

    # intersections (cudawrapper.cu:570-573)
    l2_p1, v1 = g.normalize_hom(jnp.cross(line2, epi_p1))
    l2_p2, v2 = g.normalize_hom(jnp.cross(line2, epi_p2))
    l1_q1, v3 = g.normalize_hom(jnp.cross(line1, epi_q1))
    l1_q2, v4 = g.normalize_hom(jnp.cross(line1, epi_q2))
    inter_ok = v1 & v2 & v3 & v4                   # [Ss, St]

    # overlap gate (cudawrapper.cu:584-588)
    p1b = p1[:, None, :]
    p2b = p2[:, None, :]
    q1b = q1[None, :, :]
    q2b = q2[None, :, :]
    overlap1 = g.segment_overlap_2d(p1b, p2b, l1_q1, l1_q2)
    overlap2 = g.segment_overlap_2d(q1b, q2b, l2_p1, l2_p2)
    ov_ok = (jnp.minimum(overlap1, overlap2) > min_overlap_lower) & \
            (jnp.maximum(overlap1, overlap2) > min_overlap_upper)

    # triangulation (cudawrapper.cu:594-601)
    d_p1, _, t1 = g.triangulation_depths(p1b, l2_p1, C_src, C_tgt,
                                         RtKinv_src, RtKinv_tgt)
    d_p2, _, t2 = g.triangulation_depths(p2b, l2_p2, C_src, C_tgt,
                                         RtKinv_src, RtKinv_tgt)
    _, d_q1, t3 = g.triangulation_depths(l1_q1, q1b, C_src, C_tgt,
                                         RtKinv_src, RtKinv_tgt)
    _, d_q2, t4 = g.triangulation_depths(l1_q2, q2b, C_src, C_tgt,
                                         RtKinv_src, RtKinv_tgt)

    depths = jnp.stack([d_p1, d_p2, d_q1, d_q2], axis=-1)
    pos = jnp.all(depths > 0.0, axis=-1)
    valid = (inter_ok & ov_ok & pos & t1 & t2 & t3 & t4 &
             mask_src[:, None] & mask_tgt[None, :])
    return depths, valid


EPS = g.EPS


def _overlap_soa(ax, ay, bx, by, cx, cy, dx, dy):
    """segment_overlap_2d on component planes: overlap of segment (c,d) with
    segment (a,b), all collinear.  Every operand broadcasts to [Ss, St]."""
    len_ab = jnp.sqrt((ax - bx) ** 2 + (ay - by) ** 2)
    len_cd = jnp.sqrt((cx - dx) ** 2 + (cy - dy) ** 2)

    on = lambda px, py, qx, qy, rx, ry: \
        (px - rx) * (qx - rx) + (py - ry) * (qy - ry) < EPS
    c_in = on(ax, ay, bx, by, cx, cy)
    d_in = on(ax, ay, bx, by, dx, dy)
    a_in = on(cx, cy, dx, dy, ax, ay)
    b_in = on(cx, cy, dx, dy, bx, by)

    dist = lambda ux, uy, vx, vy: jnp.sqrt((ux - vx) ** 2 + (uy - vy) ** 2)
    safe = lambda x: jnp.maximum(x, EPS)

    c1 = len_cd / safe(len_ab)
    c2 = len_ab / safe(len_cd)
    l31 = dist(bx, by, dx, dy)
    l32 = dist(ax, ay, dx, dy)
    c3 = jnp.where(a_in & (l31 > EPS), dist(cx, cy, ax, ay) / safe(l31),
                   jnp.where(l32 > EPS, dist(cx, cy, bx, by) / safe(l32), 0.0))
    l41 = dist(ax, ay, cx, cy)
    l42 = dist(bx, by, cx, cy)
    c4 = jnp.where(b_in & (l41 > EPS), dist(dx, dy, bx, by) / safe(l41),
                   jnp.where(l42 > EPS, dist(dx, dy, ax, ay) / safe(l42), 0.0))

    ov = jnp.where(c_in & d_in, c1,
                   jnp.where(a_in & b_in, c2,
                             jnp.where(c_in, c3,
                                       jnp.where(d_in, c4, 0.0))))
    return jnp.where((len_ab < 1.0) | (len_cd < 1.0), 0.0, ov)


def match_pair_dense(segs_src, segs_tgt, mask_src, mask_tgt,
                     F, RtKinv_src, RtKinv_tgt, C_src, C_tgt,
                     min_overlap_lower=MIN_OVERLAP_LOWER,
                     min_overlap_upper=MIN_OVERLAP_UPPER):
    """Dense pair matching for one (src, tgt) view pair — SoA layout.

    Args:
      segs_src: [Ss, 4], segs_tgt: [St, 4] float32 segment endpoints.
      mask_src: [Ss], mask_tgt: [St] bool validity.
      F: [3, 3] fundamental (src -> tgt epipolar lines).
      RtKinv_src / RtKinv_tgt: [3, 3]; C_src / C_tgt: [3].

    Returns:
      depths: tuple of 4 planes [Ss, St] float32
              (d_src_p1, d_src_p2, d_tgt_q1, d_tgt_q2)
      valid:  [Ss, St] bool
    """
    f32 = jnp.float32
    # per-src-segment scalars, broadcast down columns: [Ss, 1]
    p1x = segs_src[:, 0:1]; p1y = segs_src[:, 1:2]
    p2x = segs_src[:, 2:3]; p2y = segs_src[:, 3:4]
    # per-tgt-segment scalars, broadcast across rows: [1, St]
    q1x = segs_tgt[None, :, 0]; q1y = segs_tgt[None, :, 1]
    q2x = segs_tgt[None, :, 2]; q2y = segs_tgt[None, :, 3]

    # 2D supporting lines: cross((x1,y1,1),(x2,y2,1))
    l1a = p1y - p2y; l1b = p2x - p1x; l1c = p1x * p2y - p1y * p2x  # [Ss,1]
    l2a = q1y - q2y; l2b = q2x - q1x; l2c = q1x * q2y - q1y * q2x  # [1,St]

    # epipolar lines: F @ (x, y, 1) per src endpoint; F^T @ q per tgt
    def Fline(M, x, y):
        return (M[0, 0] * x + M[0, 1] * y + M[0, 2],
                M[1, 0] * x + M[1, 1] * y + M[1, 2],
                M[2, 0] * x + M[2, 1] * y + M[2, 2])
    e1a, e1b, e1c = Fline(F, p1x, p1y)       # epi of p1 in tgt view [Ss,1]
    e2a, e2b, e2c = Fline(F, p2x, p2y)
    Ft = F.T
    f1a, f1b, f1c = Fline(Ft, q1x, q1y)      # epi of q1 in src view [1,St]
    f2a, f2b, f2c = Fline(Ft, q2x, q2y)

    def intersect(la, lb, lc, ma, mb, mc):
        """cross(line l, line m) -> homogeneous point, normalized to z=1."""
        ix = lb * mc - lc * mb
        iy = lc * ma - la * mc
        iz = la * mb - lb * ma
        ok = jnp.abs(iz) > EPS
        zs = jnp.where(ok, iz, 1.0)
        return jnp.where(ok, ix / zs, 0.0), jnp.where(ok, iy / zs, 0.0), ok

    # epipolar transfer points (cudawrapper.cu:570-573): [Ss, St] planes
    a1x, a1y, ok1 = intersect(l2a, l2b, l2c, e1a, e1b, e1c)  # l2_p1
    a2x, a2y, ok2 = intersect(l2a, l2b, l2c, e2a, e2b, e2c)  # l2_p2
    b1x, b1y, ok3 = intersect(l1a, l1b, l1c, f1a, f1b, f1c)  # l1_q1
    b2x, b2y, ok4 = intersect(l1a, l1b, l1c, f2a, f2b, f2c)  # l1_q2
    inter_ok = ok1 & ok2 & ok3 & ok4

    # overlap gate (cudawrapper.cu:584-588)
    ov1 = _overlap_soa(p1x, p1y, p2x, p2y, b1x, b1y, b2x, b2y)
    ov2 = _overlap_soa(q1x, q1y, q2x, q2y, a1x, a1y, a2x, a2y)
    ov_ok = (jnp.minimum(ov1, ov2) > min_overlap_lower) & \
            (jnp.maximum(ov1, ov2) > min_overlap_upper)

    # viewing rays.  src endpoints: per-row 3-vectors; transfer points:
    # component planes through the OTHER view's RtKinv.
    def ray_fixed(M, x, y):
        rx = M[0, 0] * x + M[0, 1] * y + M[0, 2]
        ry = M[1, 0] * x + M[1, 1] * y + M[1, 2]
        rz = M[2, 0] * x + M[2, 1] * y + M[2, 2]
        inv = jax.lax.rsqrt(jnp.maximum(rx * rx + ry * ry + rz * rz, EPS))
        return rx * inv, ry * inv, rz * inv

    def tri(r1, r2, w0):
        """two-ray depths (cudawrapper.cu:306-335); rays normalized."""
        a = r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]
        b = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2]
        c = r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2]
        d = r1[0] * w0[0] + r1[1] * w0[1] + r1[2] * w0[2]
        e = r2[0] * w0[0] + r2[1] * w0[1] + r2[2] * w0[2]
        denom = a * c - b * b
        ok = jnp.abs(denom) > EPS
        zs = jnp.where(ok, denom, 1.0)
        d1 = jnp.where(ok, (b * e - c * d) / zs, -1.0)
        d2 = jnp.where(ok, (a * e - b * d) / zs, -1.0)
        return d1, d2, ok

    w0 = (C_src[0] - C_tgt[0], C_src[1] - C_tgt[1], C_src[2] - C_tgt[2])

    ray_p1 = ray_fixed(RtKinv_src, p1x, p1y)     # [Ss,1] components
    ray_p2 = ray_fixed(RtKinv_src, p2x, p2y)
    ray_q1 = ray_fixed(RtKinv_tgt, q1x, q1y)     # [1,St]
    ray_q2 = ray_fixed(RtKinv_tgt, q2x, q2y)
    ray_a1 = ray_fixed(RtKinv_tgt, a1x, a1y)     # [Ss,St]
    ray_a2 = ray_fixed(RtKinv_tgt, a2x, a2y)
    ray_b1 = ray_fixed(RtKinv_src, b1x, b1y)
    ray_b2 = ray_fixed(RtKinv_src, b2x, b2y)

    d_p1, _, t1 = tri(ray_p1, ray_a1, w0)        # src depth at p1
    d_p2, _, t2 = tri(ray_p2, ray_a2, w0)
    _, d_q1, t3 = tri(ray_b1, ray_q1, w0)        # tgt depth at q1
    _, d_q2, t4 = tri(ray_b2, ray_q2, w0)

    pos = (d_p1 > 0.0) & (d_p2 > 0.0) & (d_q1 > 0.0) & (d_q2 > 0.0)
    valid = (inter_ok & ov_ok & pos & t1 & t2 & t3 & t4 &
             mask_src[:, None] & mask_tgt[None, :])
    return (d_p1, d_p2, d_q1, d_q2), valid


def compact_rows(depths, valid, m_cap):
    """Compact a dense [Ss, St] match grid into per-row fixed-width tables.

    Replaces the host-side sort + offset-table build of the reference
    (cudawrapper.cu:926-1007).  Valid matches are kept in ascending target
    index order, matching the reference's (segID1, camID2, segID2) sort.

    Implemented as ONE multi-operand lax.sort carrying the depth planes
    alongside the key instead of a top_k + take_along_axis gather:
    sorting permutes the payload in the same pass.

    Returns (tgt_idx [Ss, m_cap] int32 (-1 pad), depths_g [Ss, m_cap, 4],
             kept_valid [Ss, m_cap] bool, n_valid [Ss] int32).
    """
    St = valid.shape[1]
    m_cap = min(m_cap, St)
    n_valid = jnp.sum(valid, axis=1).astype(jnp.int32)
    j = jax.lax.broadcasted_iota(jnp.int32, valid.shape, 1)
    key = jnp.where(valid, j, St + j)    # valid entries first, ascending j
    if isinstance(depths, tuple):
        planes = depths
    else:
        planes = tuple(depths[..., k] for k in range(depths.shape[-1]))
    sorted_ops = jax.lax.sort((key,) + planes, dimension=1, num_keys=1)
    skey = sorted_ops[0][:, :m_cap]
    depths_g = jnp.stack([p[:, :m_cap] for p in sorted_ops[1:]], axis=-1)
    kept_valid = skey < St
    tgt_idx = jnp.where(kept_valid, skey, -1).astype(jnp.int32)
    return tgt_idx, depths_g, kept_valid, n_valid


def compact_rows_blockq(valid, quota: int, min_capacity: int = 0):
    """Key-only per-128-block compaction (ascending target index).

    Device replacement for the reference's host-side sort + offset-table
    build (cudawrapper.cu:926-1007).  Tightly packing each row's valid
    matches is a payload-heavy [Ss, St] sort; instead keep at most `quota` matches per contiguous 128-target
    lane block — a fixed layout needing only a 1-operand length-128
    segmented sort of an int key, with depths recomputed later at the
    compacted shape (depths_for_matches).  Per-source capacity is
    (St/128)*quota; drops are counted (the reference keeps all matches;
    typical per-row counts are far below capacity).

    Returns (tgt_idx [Ss, (St/128)*quota] int32 (-1 pads),
             kept [Ss, (St/128)*quota] bool, n_valid [Ss] int32).
    """
    Ss, St = valid.shape
    blk = 128
    while St % blk:                       # tiny test shapes pad to 64
        blk //= 2
    B = St // blk
    # guarantee at least min_capacity slots per row regardless of block
    # count (small scenes have few blocks; quota alone would under-cap)
    quota = max(quota, -(-min_capacity // B))
    quota = min(quota, blk)
    j = jax.lax.broadcasted_iota(jnp.int32, (Ss * B, blk), 1)
    key = jnp.where(valid.reshape(Ss * B, blk), j, jnp.int32(blk) + j)
    # 2-D operand: one batched row sort
    skey = jax.lax.sort(key, dimension=1)[:, :quota].reshape(Ss, B, quota)
    kept = skey < blk
    base = jax.lax.broadcasted_iota(jnp.int32, (Ss, B, quota), 1) * blk
    tgt_idx = jnp.where(kept, base + skey, -1).reshape(Ss, B * quota)
    n_valid = jnp.sum(valid, axis=1).astype(jnp.int32)
    return tgt_idx, kept.reshape(Ss, B * quota), n_valid


def merge_neighbor_tables(res: dict, m_total: int, num_targets: int):
    """Merge per-neighbor compacted index tables [N, S, K1] into one
    per-source table [S, M] ordered by (neighbor, target) ascending — the
    reference's sortMatchingPairs order (sparsematrix.h:68-79).

    Key-only: each kept slot is encoded as cam*St + tgt into one int32 and
    a single 1-operand sort merges all neighbors; cam/tgt are recovered by
    divmod and depths are recomputed afterwards (depths_for_matches), so no
    payload planes ride the sort.

    Returns (cam [S, M] int32, tgt [S, M] int32, valid [S, M] bool).
    """
    N, S, K1 = res["tgt_idx"].shape
    K = N * K1
    St = num_targets
    cam_full = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[:, None, None], (N, S, K1))
    cam_full = jnp.transpose(cam_full, (1, 0, 2)).reshape(S, K)
    tgt_full = jnp.transpose(res["tgt_idx"], (1, 0, 2)).reshape(S, K)
    valid_full = jnp.transpose(res["valid"], (1, 0, 2)).reshape(S, K)

    m_total = min(m_total, K)
    big = N * St
    pos = jax.lax.broadcasted_iota(jnp.int32, (S, K), 1)
    key = jnp.where(valid_full, cam_full * St + tgt_full, big + pos)
    skey = jax.lax.sort(key, dimension=1)[:, :m_total]
    valid = skey < big
    cam = jnp.where(valid, skey // St, -1)
    tgt = jnp.where(valid, skey % St, -1)
    return cam, tgt, valid


def gather_target_coords(segs_nb, cam, tgt):
    """[S, M, 4] target-segment coordinates per match slot — ONE flat row
    gather of the 4-wide rows (not four 1-D gathers); the caller gathers
    ONCE and shares the result between the depth recompute and the
    scoring prep."""
    N, St, _ = segs_nb.shape
    S, M = cam.shape
    flat = jnp.maximum(cam, 0) * St + jnp.maximum(tgt, 0)
    return segs_nb.reshape(N * St, 4)[flat.reshape(-1)].reshape(S, M, 4)


def depths_for_matches(segs_src, segs_nb, cam, tgt, valid,
                       F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb,
                       tcoords=None):
    """Recompute the 4 triangulated depths for a merged match table.

    Same math as match_pair_dense (two-ray triangulation
    of the epipolar transfer points, cudawrapper.cu:306-335, 594-601), but
    evaluated only at the kept [S, M] pairs — the dense [Ss, St] depth
    planes are never written to HBM.  Per-match camera constants are
    resolved by an unrolled select over the small neighbor axis (exact; a
    one-hot contraction could round the values at reduced matmul
    precision).

    Returns depths [S, M, 4] float32 (0 in invalid slots).
    """
    S, M = cam.shape
    N, St, _ = segs_nb.shape
    cam_s = jnp.maximum(cam, 0)
    if tcoords is None:
        tcoords = gather_target_coords(segs_nb, cam, tgt)

    def sel_entry(vals):
        """[S, M] plane of the per-camera scalar vals[cam[s, m]].

        One SEPARATE plane per matrix entry: flat [S, M] planes instead of
        [S, M, 3, 3] / [S, M, 3] arrays with a minor dim of 3."""
        out = jnp.zeros((S, M), jnp.float32)
        for n in range(N):
            out = jnp.where(cam_s == n, vals[n].astype(jnp.float32), out)
        return out

    F_e = {(r, c): sel_entry(F_nb[:, r, c])
           for r in range(3) for c in range(3)}
    M_e = {(r, c): sel_entry(RtKinv_nb[:, r, c])
           for r in range(3) for c in range(3)}
    Ct_pm = [sel_entry(C_nb[:, k]) for k in range(3)]

    p1x = segs_src[:, 0:1]; p1y = segs_src[:, 1:2]
    p2x = segs_src[:, 2:3]; p2y = segs_src[:, 3:4]
    q1x = tcoords[..., 0]; q1y = tcoords[..., 1]
    q2x = tcoords[..., 2]; q2y = tcoords[..., 3]

    l1a = p1y - p2y; l1b = p2x - p1x; l1c = p1x * p2y - p1y * p2x  # [S,1]
    l2a = q1y - q2y; l2b = q2x - q1x; l2c = q1x * q2y - q1y * q2x  # [S,M]

    Fc = lambda r, c: F_e[(r, c)]                    # noqa: E731
    e1a = Fc(0, 0) * p1x + Fc(0, 1) * p1y + Fc(0, 2)
    e1b = Fc(1, 0) * p1x + Fc(1, 1) * p1y + Fc(1, 2)
    e1c = Fc(2, 0) * p1x + Fc(2, 1) * p1y + Fc(2, 2)
    e2a = Fc(0, 0) * p2x + Fc(0, 1) * p2y + Fc(0, 2)
    e2b = Fc(1, 0) * p2x + Fc(1, 1) * p2y + Fc(1, 2)
    e2c = Fc(2, 0) * p2x + Fc(2, 1) * p2y + Fc(2, 2)
    f1a = Fc(0, 0) * q1x + Fc(1, 0) * q1y + Fc(2, 0)
    f1b = Fc(0, 1) * q1x + Fc(1, 1) * q1y + Fc(2, 1)
    f1c = Fc(0, 2) * q1x + Fc(1, 2) * q1y + Fc(2, 2)
    f2a = Fc(0, 0) * q2x + Fc(1, 0) * q2y + Fc(2, 0)
    f2b = Fc(0, 1) * q2x + Fc(1, 1) * q2y + Fc(2, 1)
    f2c = Fc(0, 2) * q2x + Fc(1, 2) * q2y + Fc(2, 2)

    def intersect(la, lb, lc, ma, mb, mc):
        ix = lb * mc - lc * mb
        iy = lc * ma - la * mc
        iz = la * mb - lb * ma
        ok = jnp.abs(iz) > EPS
        zs = jnp.where(ok, iz, 1.0)
        return jnp.where(ok, ix / zs, 0.0), jnp.where(ok, iy / zs, 0.0)

    a1x, a1y = intersect(l2a, l2b, l2c, e1a, e1b, e1c)
    a2x, a2y = intersect(l2a, l2b, l2c, e2a, e2b, e2c)
    b1x, b1y = intersect(l1a, l1b, l1c, f1a, f1b, f1c)
    b2x, b2y = intersect(l1a, l1b, l1c, f2a, f2b, f2c)

    def ray_fixed(Mx, x, y):
        rx = Mx[0, 0] * x + Mx[0, 1] * y + Mx[0, 2]
        ry = Mx[1, 0] * x + Mx[1, 1] * y + Mx[1, 2]
        rz = Mx[2, 0] * x + Mx[2, 1] * y + Mx[2, 2]
        inv = jax.lax.rsqrt(jnp.maximum(rx * rx + ry * ry + rz * rz, EPS))
        return rx * inv, ry * inv, rz * inv

    Mc = lambda r, c: M_e[(r, c)]                    # noqa: E731

    def ray_pm(x, y):
        rx = Mc(0, 0) * x + Mc(0, 1) * y + Mc(0, 2)
        ry = Mc(1, 0) * x + Mc(1, 1) * y + Mc(1, 2)
        rz = Mc(2, 0) * x + Mc(2, 1) * y + Mc(2, 2)
        inv = jax.lax.rsqrt(jnp.maximum(rx * rx + ry * ry + rz * rz, EPS))
        return rx * inv, ry * inv, rz * inv

    def tri(r1, r2, w0, want_first):
        a = r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]
        b = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2]
        c = r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2]
        d = r1[0] * w0[0] + r1[1] * w0[1] + r1[2] * w0[2]
        e = r2[0] * w0[0] + r2[1] * w0[1] + r2[2] * w0[2]
        denom = a * c - b * b
        ok = jnp.abs(denom) > EPS
        zs = jnp.where(ok, denom, 1.0)
        num = (b * e - c * d) if want_first else (a * e - b * d)
        return jnp.where(ok, num / zs, -1.0)

    w0 = tuple(C_src[k] - Ct_pm[k] for k in range(3))

    ray_p1 = ray_fixed(RtKinv_src, p1x, p1y)
    ray_p2 = ray_fixed(RtKinv_src, p2x, p2y)
    ray_q1 = ray_pm(q1x, q1y)
    ray_q2 = ray_pm(q2x, q2y)
    ray_a1 = ray_pm(a1x, a1y)
    ray_a2 = ray_pm(a2x, a2y)
    ray_b1 = ray_fixed(RtKinv_src, b1x, b1y)
    ray_b2 = ray_fixed(RtKinv_src, b2x, b2y)

    d_p1 = tri(ray_p1, ray_a1, w0, True)
    d_p2 = tri(ray_p2, ray_a2, w0, True)
    d_q1 = tri(ray_b1, ray_q1, w0, False)
    d_q2 = tri(ray_b2, ray_q2, w0, False)

    depths = jnp.stack([jnp.broadcast_to(d, (S, M))
                        for d in (d_p1, d_p2, d_q1, d_q2)], axis=-1)
    return jnp.where(valid[..., None], depths, 0.0)


def match_pair_valid(segs_src, segs_tgt, mask_src, mask_tgt,
                     F, RtKinv_src, RtKinv_tgt, C_src, C_tgt,
                     min_overlap_lower=MIN_OVERLAP_LOWER,
                     min_overlap_upper=MIN_OVERLAP_UPPER):
    """The pair gates alone: match_pair_dense's valid plane [Ss, St].  XLA
    fuses the whole broadcast map into one loop kernel (the depth planes
    it does not return are never materialized)."""
    return match_pair_dense(segs_src, segs_tgt, mask_src, mask_tgt,
                            F, RtKinv_src, RtKinv_tgt, C_src, C_tgt,
                            min_overlap_lower, min_overlap_upper)[1]


def match_view_against_neighbors(segs_src, mask_src, RtKinv_src, C_src,
                                 segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb,
                                 nb_mask, quota,
                                 min_overlap_lower=MIN_OVERLAP_LOWER,
                                 min_overlap_upper=MIN_OVERLAP_UPPER,
                                 min_capacity: int = 0,
                                 per_nb_cap: int | None = None):
    """Match one source view against a padded stack of N neighbor views.

    Scans over the neighbor axis (keeps peak memory at one [Ss, St] grid);
    each neighbor's valid plane is compacted key-only per 128-target block
    (compact_rows_blockq) — depths are recomputed after the merge
    (depths_for_matches), so no payload planes ride any sort.

    Args:
      segs_nb: [N, St, 4]; mask_nb: [N, St]; F_nb: [N, 3, 3];
      RtKinv_nb: [N, 3, 3]; C_nb: [N, 3]; nb_mask: [N] bool (padding slots).
      quota: per-(source segment, 128-target-block) match quota; per-neighbor
        capacity is (St/128)*quota.
      per_nb_cap: optional second key-only compaction of each neighbor's
        table from (St/128)*quota down to this many slots (the capacity
        probe's exact per-(segment, neighbor) bound, pow2-bucketed).  The
        cross-neighbor merge sort then runs over N*per_nb_cap keys instead
        of N*(St/128)*quota (at the facade's exact capacities, quota=32
        and S=1536, the merge would sort 3840 keys per row); the short
        per-neighbor re-sort is cheap.
        Drops (count > per_nb_cap) are counted in overflow.

    Returns dict with
      tgt_idx [N, Ss, K1], valid [N, Ss, K1], n_valid [N, Ss],
      overflow [N] (int32 count of matches dropped by the quota — the
      reference keeps all, cudawrapper.cu:926).
    """
    St = segs_nb.shape[1]

    def step(carry, nb):
        segs_t, mask_t, F, RtKinv_t, C_t = nb
        valid = match_pair_valid(
            segs_src, segs_t, mask_src, mask_t,
            F, RtKinv_src, RtKinv_t, C_src, C_t,
            min_overlap_lower, min_overlap_upper)
        tgt_idx, kept, n_valid = compact_rows_blockq(valid, quota,
                                                     min_capacity)
        if per_nb_cap is not None and per_nb_cap < tgt_idx.shape[1]:
            # second compaction: target-ascending key sort of the (short)
            # block-compacted table, keeping the first per_nb_cap —
            # lossless whenever every row's per-neighbor count fits
            # (probe-guaranteed; drops land in overflow otherwise)
            pos = jax.lax.broadcasted_iota(jnp.int32, tgt_idx.shape, 1)
            key2 = jnp.where(kept, tgt_idx, St + pos)
            skey2 = jax.lax.sort(key2, dimension=1)[:, :per_nb_cap]
            kept = skey2 < St
            tgt_idx = jnp.where(kept, skey2, -1)
        overflow = jnp.sum(n_valid) - jnp.sum(kept)
        return carry, (tgt_idx, kept, n_valid, overflow)

    _, (tgt_idx, kept, n_valid, overflow) = jax.lax.scan(
        step, None,
        (segs_nb, mask_nb & nb_mask[:, None], F_nb, RtKinv_nb, C_nb))
    return dict(tgt_idx=tgt_idx, valid=kept,
                n_valid=n_valid, overflow=overflow)
