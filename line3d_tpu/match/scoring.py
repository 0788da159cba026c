"""Match verification: multi-view support scoring of raw matches.

Device equivalent of K_verify_matches (reference: cudawrapper.cu:614-714)
plus the host-side confidence filter / median-depth pass
(cudawrapper.cu:1021-1110).

For every raw match m = (src segment s, neighbor cam c, tgt segment j) with
triangulated depths (d1, d2):
  * unproject s's endpoints at (d1, d2) -> 3D hypothesis (P1, P2),
  * for every OTHER raw match m2 of the same source segment in a DIFFERENT
    camera c2: reproject (P1, P2) into c2, compare against m2's target
    segment's 2D line (mutual max point-line distance), and compare the 3D
    direction of m with m2's hypothesis (both lie on s's viewing rays, so the
    3D spatial gate |Pk - Qk| <= spatial_k * depth reduces to a depth-delta
    test),
  * support(m, m2) = min(exp(-dist^2 / 2 sigma_p^2),
                          exp(-angle^2 / 2 sigma_a^2)), kept if > 0.5,
  * confidence(m) = sum over cameras c2 != c of max_{m2 in c2} support(m, m2).

The reference runs one CUDA thread per match, serially looping over the
segment's other matches (cudawrapper.cu:656-706).  score_matches below is
the plain XLA twin: the [M x M] support matrix per source segment is
evaluated densely over row-chunks of the segment axis.  It is the CPU path
and the reference for the GPU kernel (scoring_triton), which keeps the
reference's O(sum R^2) cost and no plane in device memory.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import geometry as g

EPS = g.EPS

# the twin materializes about a dozen [row_chunk, M, M] f32 planes per
# chunk; capping one plane at 2^25 elements (128 MiB) keeps a chunk within
# a few GiB at the exact capacities (M = 1024, 2048)
_TWIN_PLANE_ELEMS = 1 << 25


def twin_row_chunk(row_chunk: int, M: int) -> int:
    """Row chunk of the XLA twin: the caller's, halved until one
    [rows, M, M] plane fits _TWIN_PLANE_ELEMS."""
    rows = row_chunk
    while rows > 1 and rows * M * M > _TWIN_PLANE_ELEMS:
        rows //= 2
    return rows


def _gather_m2(T, onehot):
    """out[s, m, m2] = T[s, m, cam[s, m2]] for T [Sc, M, N].

    Expressed as a one-hot contraction over the tiny camera axis (N ~ 10).
    onehot: [Sc, M2, N] float32 with onehot[s, k, cam[s, k]] = 1.
    HIGHEST precision: a lower-precision product (bf16, or TF32 on a GPU)
    would round the gathered values.
    """
    return jnp.einsum("smn,skn->smk", T, onehot,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def score_matches(segs_src, mask_src, RtKinv_src, C_src,
                  cam, tgt, depths, valid,
                  P_nb, segs_nb,
                  sigma_p, sigma_a, spatial_k,
                  support_threshold=0.5,
                  row_chunk=128, tcoords=None):
    """Score all matches of one source view.  See module docstring.

    Returns confidence [S, M] float32 (0 for invalid slots).
    """
    S, M = cam.shape
    row_chunk = twin_row_chunk(row_chunk, M)
    N = P_nb.shape[0]
    St = segs_nb.shape[1]

    p1, p2 = g.seg_endpoints(segs_src)              # [S, 3]
    ray1 = g.ray_dir(RtKinv_src, p1)
    ray2 = g.ray_dir(RtKinv_src, p2)

    # target segment coords per match: [S, M, 4] (shared with the depth
    # recompute when the caller provides it, pairwise.gather_target_coords)
    if tcoords is None:
        from .pairwise import gather_target_coords
        tcoords = gather_target_coords(segs_nb, cam, tgt)
    tq1 = g.hom(tcoords[..., 0:2])                  # [S, M, 3]
    tq2 = g.hom(tcoords[..., 2:4])
    tline = jnp.cross(tq1, tq2)
    tline_den = jnp.sqrt(tline[..., 0] ** 2 + tline[..., 1] ** 2)
    tline_den = jnp.maximum(tline_den, EPS)

    sig_p2 = 2.0 * sigma_p * sigma_p
    sig_a2 = 2.0 * sigma_a * sigma_a

    def chunk_fn(args):
        (ray1c, ray2c, camc, depthsc, validc,
         tlinec, tline_denc, tq1c, tq2c) = args
        Sc = ray1c.shape[0]
        d1c = depthsc[..., 0]
        d2c = depthsc[..., 1]

        # absolute 3D endpoints [Sc, M, 3]
        P1 = C_src + d1c[..., None] * ray1c[:, None, :]
        P2 = C_src + d2c[..., None] * ray2c[:, None, :]

        dir3 = P2 - P1
        dirn = dir3 / jnp.maximum(
            jnp.linalg.norm(dir3, axis=-1, keepdims=True), EPS)

        # project into all neighbors: [Sc, M, N, 3]
        def proj_all(P):
            Ph = jnp.concatenate([P, jnp.ones_like(P[..., :1])], axis=-1)
            # HIGHEST: a bf16/TF32 product would round the 3D points,
            # which shifts reprojections by whole pixels at image scale
            q = jnp.einsum("smk,nik->smni", Ph, P_nb,
                           precision=jax.lax.Precision.HIGHEST)
            z = q[..., 2]
            ok = jnp.abs(z) > EPS
            zs = jnp.where(ok, z, 1.0)
            return q[..., 0] / zs, q[..., 1] / zs, ok

        px1, py1, ok1 = proj_all(P1)
        px2, py2, ok2 = proj_all(P2)
        pok = ok1 & ok2                              # [Sc, M, N]

        # projected 2D line in each neighbor: cross((px1,py1,1),(px2,py2,1))
        plx = py1 - py2
        ply = px2 - px1
        plz = px1 * py2 - py1 * px2
        pl_den = jnp.maximum(jnp.sqrt(plx ** 2 + ply ** 2), EPS)

        # "gathers" to [Sc, M, M]: value index m, camera index cam[m2] —
        # one-hot contractions over the camera axis
        onehot = (camc[:, :, None] ==
                  jnp.arange(N, dtype=jnp.int32)[None, None, :]
                  ).astype(jnp.float32)              # [Sc, M2, N]
        px1g = _gather_m2(px1, onehot)
        py1g = _gather_m2(py1, onehot)
        px2g = _gather_m2(px2, onehot)
        py2g = _gather_m2(py2, onehot)
        plxg = _gather_m2(plx, onehot)
        plyg = _gather_m2(ply, onehot)
        plzg = _gather_m2(plz, onehot)
        pldg = _gather_m2(pl_den, onehot)
        # invalid cam slots (-1) produce all-zero one-hot rows -> pldg 0;
        # guard the division
        pldg = jnp.maximum(pldg, EPS)
        pokg = _gather_m2(pok.astype(jnp.float32), onehot) > 0.5

        # distance: projected endpoints of m vs m2's target line (broadcast
        # m2 quantities along the m axis)
        tlx = tlinec[:, None, :, 0]
        tly = tlinec[:, None, :, 1]
        tlz = tlinec[:, None, :, 2]
        tden = tline_denc[:, None, :]
        da1 = jnp.abs(tlx * px1g + tly * py1g + tlz) / tden
        da2 = jnp.abs(tlx * px2g + tly * py2g + tlz) / tden

        # distance: m2's target endpoints vs m's projected line
        qx1 = tq1c[:, None, :, 0]
        qy1 = tq1c[:, None, :, 1]
        qx2 = tq2c[:, None, :, 0]
        qy2 = tq2c[:, None, :, 1]
        db1 = jnp.abs(plxg * qx1 + plyg * qy1 + plzg) / pldg
        db2 = jnp.abs(plxg * qx2 + plyg * qy2 + plzg) / pldg

        dist = jnp.maximum(jnp.maximum(da1, da2), jnp.maximum(db1, db2))
        conf_pos = jnp.exp(-dist * dist / sig_p2)

        # 3D angle via dot of normalized directions (exact f32 product)
        dots = jnp.einsum("smk,snk->smn", dirn, dirn,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        ang = jnp.degrees(jnp.arccos(jnp.clip(dots, -1.0, 1.0)))
        ang = jnp.where(ang > 90.0, 180.0 - ang, ang)
        conf_ang = jnp.exp(-ang * ang / sig_a2)

        # spatial gate: hypotheses share the src rays =>
        # |P1 - Q1| = |d1_m - d1_m2| etc. (cudawrapper.cu:387-401)
        dd1 = jnp.abs(d1c[:, :, None] - d1c[:, None, :])
        dd2 = jnp.abs(d2c[:, :, None] - d2c[:, None, :])
        gate = (dd1 <= spatial_k * d1c[:, :, None]) & \
               (dd2 <= spatial_k * d2c[:, :, None])

        conf = jnp.minimum(conf_pos, conf_ang)
        pair_ok = (validc[:, :, None] & validc[:, None, :] & gate & pokg)
        # exclude self-pairing (same match slot)
        eye = jnp.eye(M, dtype=bool)[None]
        pair_ok = pair_ok & (~eye)
        conf = jnp.where(pair_ok & (conf > support_threshold), conf, 0.0)

        # per-camera max, summed over cameras != own camera
        total = jnp.zeros((Sc, M), jnp.float32)
        for n in range(N):
            in_cam = (camc == n)[:, None, :]        # m2 in camera n
            cmax = jnp.max(jnp.where(in_cam, conf, 0.0), axis=2)
            total = total + jnp.where(camc == n, 0.0, cmax)
        return jnp.where(validc, total, 0.0)

    # pad S to a multiple of row_chunk and map over chunks
    pad = (-S) % row_chunk
    def padded(x, fill=0):
        if pad == 0:
            return x
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg, constant_values=fill)

    args = (padded(ray1), padded(ray2), padded(cam, -1), padded(depths),
            padded(valid), padded(tline), padded(tline_den, 1.0),
            padded(tq1), padded(tq2))
    n_chunks = (S + pad) // row_chunk
    args = jax.tree.map(
        lambda x: x.reshape((n_chunks, row_chunk) + x.shape[1:]), args)
    conf = jax.lax.map(chunk_fn, args)
    conf = conf.reshape(n_chunks * row_chunk, M)[:S]
    return conf


def score_matches_best(segs_src, mask_src, RtKinv_src, C_src,
                       cam, tgt, depths, valid, P_nb, segs_nb,
                       sigma_p, sigma_a, spatial_k,
                       support_threshold=0.5, row_chunk=128, tcoords=None):
    """Kernel choice (utils.backend): the fused Pallas-Triton kernel on the
    GPU (scoring_triton, any M), the XLA twin elsewhere (CPU tests)."""
    from ..utils import backend
    if backend.use_kernels():
        from .scoring_triton import score_matches_triton
        return score_matches_triton(
            segs_src, mask_src, RtKinv_src, C_src, cam, tgt, depths, valid,
            P_nb, segs_nb, sigma_p, sigma_a, spatial_k,
            support_threshold=support_threshold, tcoords=tcoords)
    return score_matches(
        segs_src, mask_src, RtKinv_src, C_src, cam, tgt, depths, valid,
        P_nb, segs_nb, sigma_p, sigma_a, spatial_k,
        support_threshold=support_threshold, row_chunk=row_chunk,
        tcoords=tcoords)
