"""Pure, jittable geometry primitives (float32).

These are the array equivalents of the reference's CUDA device library
(reference: cudawrapper.cu:46-427).  All functions are shape-polymorphic and
broadcast over leading batch dimensions, so the matching kernels can evaluate
them over [S_src, S_tgt] pair grids in one fused XLA program.

Conventions:
  * 2D points are homogeneous float32 [..., 3] with z == 1 after
    `normalize_hom`.
  * Segments are float32 [..., 4] = (x1, y1, x2, y2), as in the reference's
    float4 layout (segments.h:60-71).
  * 2D lines are homogeneous [..., 3] (a, b, c) with a·x + b·y + c = 0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

EPS = 1e-12  # L3D_EPS_G (cudawrapper.h:43)


def hom(p2: jnp.ndarray) -> jnp.ndarray:
    """Lift [..., 2] points to homogeneous [..., 3] with z=1."""
    return jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)


def seg_endpoints(seg: jnp.ndarray):
    """Split a segment [..., 4] into homogeneous endpoints p1, p2 [..., 3]."""
    return hom(seg[..., 0:2]), hom(seg[..., 2:4])


def cross3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product over the last axis (3-vectors)."""
    return jnp.cross(a, b)


def line_through(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Homogeneous 2D line through two homogeneous points."""
    return jnp.cross(p1, p2)


def normalize_hom(p: jnp.ndarray):
    """Normalize homogeneous 2D coords to z=1.

    Returns (point, valid) where invalid points (|z| <= eps) are zeroed, as in
    D_normalize_hom_coords_2D (cudawrapper.cu:255-267).
    """
    z = p[..., 2:3]
    valid = jnp.abs(z[..., 0]) > EPS
    safe = jnp.where(jnp.abs(z) > EPS, z, 1.0)
    out = p / safe
    out = jnp.where(valid[..., None], out.at[..., 2].set(1.0), 0.0)
    return out, valid


def dist_point_line_2d(line: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Perpendicular distance of homogeneous point (z=1) to 2D line.

    Mirrors D_distance_p2l_2D_f3 (cudawrapper.cu:58-61).
    """
    num = jnp.abs(line[..., 0] * p[..., 0] + line[..., 1] * p[..., 1] + line[..., 2])
    den = jnp.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
    return num / jnp.maximum(den, EPS)


def segment_length_2d(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """2D length between homogeneous (z=1) points (cudawrapper.cu:95-99)."""
    d = p1[..., 0:2] - p2[..., 0:2]
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def angle_between_dirs_deg(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """Acute angle (degrees) between two (unnormalized) 3D directions.

    Mirrors D_angle_between_lines_deg_3D_f3 (cudawrapper.cu:118-130).
    """
    n1 = v1 / jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), EPS)
    n2 = v2 / jnp.maximum(jnp.linalg.norm(v2, axis=-1, keepdims=True), EPS)
    d = jnp.clip(jnp.sum(n1 * n2, axis=-1), -1.0, 1.0)
    ang = jnp.degrees(jnp.arccos(d))
    return jnp.where(ang > 90.0, 180.0 - ang, ang)


def point_on_segment_2d(p1: jnp.ndarray, p2: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """True iff collinear q lies between p1 and p2 (cudawrapper.cu:135-141)."""
    v1 = p1[..., 0:2] - q[..., 0:2]
    v2 = p2[..., 0:2] - q[..., 0:2]
    return jnp.sum(v1 * v2, axis=-1) < EPS


def segment_overlap_2d(src_p1, src_p2, q1, q2) -> jnp.ndarray:
    """Relative overlap of segment (q1,q2) with (src_p1,src_p2); all four
    points collinear (q's are epipolar-clipped onto the src line).

    Branch-free re-formulation of D_segment_overlap_2D
    (cudawrapper.cu:209-252): the same case analysis expressed with
    jnp.where so it vectorizes over pair grids.
    """
    len_src = segment_length_2d(src_p1, src_p2)
    len_tgt = segment_length_2d(q1, q2)

    q1_in = point_on_segment_2d(src_p1, src_p2, q1)
    q2_in = point_on_segment_2d(src_p1, src_p2, q2)
    p1_in = point_on_segment_2d(q1, q2, src_p1)
    p2_in = point_on_segment_2d(q1, q2, src_p2)

    safe = lambda x: jnp.maximum(x, EPS)

    # case 1: both target points inside source segment
    c1 = len_tgt / safe(len_src)
    # case 2: both source points inside target segment
    c2 = len_src / safe(len_tgt)
    # case 3: only q1 inside src
    len31 = segment_length_2d(src_p2, q2)
    len32 = segment_length_2d(src_p1, q2)
    c3a = segment_length_2d(q1, src_p1) / safe(len31)
    c3b = segment_length_2d(q1, src_p2) / safe(len32)
    c3 = jnp.where(p1_in & (len31 > EPS), c3a, jnp.where(len32 > EPS, c3b, 0.0))
    # case 4: only q2 inside src
    len41 = segment_length_2d(src_p1, q1)
    len42 = segment_length_2d(src_p2, q1)
    c4a = segment_length_2d(q2, src_p2) / safe(len41)
    c4b = segment_length_2d(q2, src_p1) / safe(len42)
    c4 = jnp.where(p2_in & (len41 > EPS), c4a, jnp.where(len42 > EPS, c4b, 0.0))

    overlap = jnp.where(
        q1_in & q2_in, c1,
        jnp.where(p1_in & p2_in, c2,
                  jnp.where(q1_in, c3,
                            jnp.where(q2_in, c4, 0.0))))
    return jnp.where((len_src < 1.0) | (len_tgt < 1.0), 0.0, overlap)


def apply_mat3(M: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] @ [..., 3] -> [..., 3] with broadcasting.

    HIGHEST precision: geometry einsums must not run at a reduced matmul
    precision (TF32 on a GPU, bf16 elsewhere) — viewing rays feed 3D
    endpoints whose reprojection error is compared against sigma_p (a few
    pixels), and rounded rays shift reprojections by whole pixels at image
    scale."""
    return jnp.einsum("...ij,...j->...i", M, p,
                      precision=jax.lax.Precision.HIGHEST)


def epipolar_line(F: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Epipolar line l = F p (cudawrapper.cu:144-163, transpose=False).

    For the reverse direction pass F.T (transpose=True in the reference).
    """
    return apply_mat3(F, p)


def ray_dir(RtKinv: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Normalized viewing-ray direction through homogeneous pixel p.

    Mirrors D_get_ray_src / D_get_ray_tgt (cudawrapper.cu:270-303) followed by
    the normalize() each caller applies.
    """
    r = apply_mat3(RtKinv, p)
    return r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), EPS)


def triangulation_depths(p1, p2, C1, C2, RtKinv1, RtKinv2):
    """Two-ray closest-point depths for a pixel correspondence (p1 in cam 1,
    p2 in cam 2).  Returns (depth_for_cam1, depth_for_cam2, valid).

    Mirrors D_get_triangulation_depth (cudawrapper.cu:306-335) but returns
    both depths in one evaluation (the reference calls it twice).
    """
    ray1 = ray_dir(RtKinv1, p1)
    ray2 = ray_dir(RtKinv2, p2)
    w0 = C1 - C2

    a = jnp.sum(ray1 * ray1, axis=-1)
    b = jnp.sum(ray1 * ray2, axis=-1)
    c = jnp.sum(ray2 * ray2, axis=-1)
    d = jnp.sum(ray1 * w0, axis=-1)
    e = jnp.sum(ray2 * w0, axis=-1)

    denom = a * c - b * b
    valid = jnp.abs(denom) > EPS
    safe_denom = jnp.where(valid, denom, 1.0)
    d1 = (b * e - c * d) / safe_denom
    d2 = (a * e - b * d) / safe_denom
    d1 = jnp.where(valid, d1, -1.0)
    d2 = jnp.where(valid, d2, -1.0)
    return d1, d2, valid


def unproject(p: jnp.ndarray, C: jnp.ndarray, depth: jnp.ndarray,
              RtKinv: jnp.ndarray) -> jnp.ndarray:
    """3D point at `depth` along the normalized ray through pixel p.

    Mirrors D_unproject_point_src (cudawrapper.cu:338-344).
    """
    return C + depth[..., None] * ray_dir(RtKinv, p)


def project(P3: jnp.ndarray, Pmat: jnp.ndarray):
    """Project 3D point with [..., 3, 4] camera matrix; returns (pix, valid)
    with pix homogeneous z=1 (D_project_point_tgt, cudawrapper.cu:355-377)."""
    Ph = jnp.concatenate([P3, jnp.ones_like(P3[..., :1])], axis=-1)
    q = jnp.einsum("...ij,...j->...i", Pmat, Ph,
                   precision=jax.lax.Precision.HIGHEST)
    z = q[..., 2:3]
    valid = jnp.abs(z[..., 0]) > EPS
    safe = jnp.where(jnp.abs(z) > EPS, z, 1.0)
    out = q / safe
    out = jnp.where(valid[..., None], out.at[..., 2].set(1.0), 0.0)
    return out, valid


def fundamental_from_rt(K1, R1, t1, K2, R2, t2):
    """Fundamental matrix mapping cam-1 points to cam-2 epipolar lines.

    Mirrors Line3D::fundamental (line3D.cc:1968-1993): F = K2^-T [t]x R K1^-1
    with R = R2 R1^T, t = t2 - R t1.

    Dtype contract: pure-host (numpy) inputs run entirely in numpy and
    preserve float64 — the reference computes F in Eigen doubles, and with
    JAX x64 disabled a jnp path would silently truncate to float32.  Traced
    or device inputs use jnp at HIGHEST matmul precision in the device dtype
    (float32); production camera math lives in `core.cameras.CameraSet`
    (numpy f64) either way.
    """
    args = (K1, R1, t1, K2, R2, t2)
    if not any(isinstance(a, jax.Array) for a in args):
        K1, R1, t1, K2, R2, t2 = (np.asarray(a) for a in args)
        R = R2 @ np.swapaxes(R1, -1, -2)
        t = t2 - np.einsum("...ij,...j->...i", R, t1)
        zeros = np.zeros_like(t[..., 0])
        Tx = np.stack([
            np.stack([zeros, -t[..., 2], t[..., 1]], axis=-1),
            np.stack([t[..., 2], zeros, -t[..., 0]], axis=-1),
            np.stack([-t[..., 1], t[..., 0], zeros], axis=-1),
        ], axis=-2)
        E = Tx @ R
        K2invT = np.swapaxes(np.linalg.inv(K2), -1, -2)
        return K2invT @ E @ np.linalg.inv(K1)

    hi = jax.lax.Precision.HIGHEST
    R = jnp.einsum("...ij,...kj->...ik", R2, R1, precision=hi)
    t = t2 - jnp.einsum("...ij,...j->...i", R, t1, precision=hi)
    zeros = jnp.zeros_like(t[..., 0])
    Tx = jnp.stack([
        jnp.stack([zeros, -t[..., 2], t[..., 1]], axis=-1),
        jnp.stack([t[..., 2], zeros, -t[..., 0]], axis=-1),
        jnp.stack([-t[..., 1], t[..., 0], zeros], axis=-1),
    ], axis=-2)
    E = jnp.einsum("...ij,...jk->...ik", Tx, R, precision=hi)
    K2invT = jnp.swapaxes(jnp.linalg.inv(K2), -1, -2)
    return jnp.einsum("...ij,...jk,...kl->...il", K2invT, E,
                      jnp.linalg.inv(K1), precision=hi)
