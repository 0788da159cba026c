"""Pallas-Triton kernel for multi-view support scoring (match verification).

Same semantics as scoring.score_matches (the XLA formulation of the
reference's K_verify_matches, cudawrapper.cu:614-714), fused into one GPU
program that keeps no [M, M] plane in device memory.

Grid: one program per (source segment s, tile of TM scored matches m).
Each program loads its row's live bound need[s] (1 + the last valid slot;
merge_neighbor_tables packs valid slots first) and loops over tiles of T
supporting matches m2 up to cdiv(need[s], T), so the work is
sum_s need_s^2 — the reference's own O(R^2) per-segment verify cost (one
thread per match walking its segment's other matches,
cudawrapper.cu:656-706).  The per-camera maxima stay in registers across
the loop.

The hypothesis projection of C_src + d*ray into camera n is affine in the
depth d: q = a_n + d * b_{s,n} with a_n = P_n [C_src; 1] and
b_{s,n} = P_n[:,:3] ray.  The camera of a supporting match m2 is cam[m2],
so every projected quantity is one FMA from per-m2 coefficient columns
(a_{cam[m2]}, b_{s,cam[m2]}), gathered once per match slot by XLA before
the kernel into the [S, _NT, M] table below.

Host-visible API: score_matches_triton, a drop-in replacement for
scoring.score_matches (equivalence-tested in tests/test_pallas.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import geometry as g

EPS = g.EPS

# table slots: quantities of a match slot, read as the scored match (row,
# first 7) and as the supporting match (column, all)
_D1, _D2, _CAM, _VALID, _DIRX, _DIRY, _DIRZ = range(7)
_Q1X, _Q1Y, _Q2X, _Q2Y = range(7, 11)
_AX, _AY, _AZ, _BX1, _BY1, _BZ1, _BX2, _BY2, _BZ2 = range(11, 20)
_U0, _U1, _U2 = range(20, 23)
_NT = 23

# (180/pi)^2 — folds the radians->degrees conversion of the angle into the
# squared-angle Gaussian exponent
_DEG2 = (180.0 / 3.14159265358979323846) ** 2

# (m tile, m2 tile, num_warps, num_stages), picked by the sweep recorded in
# PERF.md (H100 SXM, scripts/scoring_sweep.py): small m2 tiles keep the
# ~15 live [T, TM] planes in registers
DEFAULT_TILES = (64, 8, 4, 1)


def _conf_tile(row, col, params, m_off, m2_off, TM, T):
    """Support-confidence plane conf[m2, m] for one (m2 tile, m tile);
    returns (conf [T, TM], cam_col [T, 1]).

    The 2D point-line distances follow the reference
    (cudawrapper.cu:668-683) with two algebraic reassociations:
      * point-to-target-line: tl . (qx/qz, qy/qz, 1) =
        ((tl . a) + d (tl . b)) / qz — the numerator coefficients
        (tl . a), (tl . b) are per-m2 columns (U0/U1/U2);
      * target-point-to-projected-line: the projected line through the
        two divided endpoints equals (q1 x q2) / (q1z q2z), and the qz
        products cancel between the numerator and the |(plx, ply)|
        normalizer, so the undivided homogeneous cross product is used.
    conf = min(exp(-dist^2/2sp^2), exp(-ang^2/2sa^2)) is computed as one
    exp(-max(...)): exp is monotone, so the min of the exps is the exp of
    the max exponent.
    """
    f32 = jnp.float32
    inv_sig_p2, inv_sig_a2, spatial_k, support_threshold = params

    d1_row, d2_row = row(_D1), row(_D2)
    d1_col, d2_col = col(_D1), col(_D2)
    az, bz1, bz2 = col(_AZ), col(_BZ1), col(_BZ2)

    # homogeneous depths of the projected endpoints + projection-ok gate
    Z1 = az + d1_row * bz1
    Z2 = az + d2_row * bz2
    ok = (jnp.abs(Z1) > EPS) & (jnp.abs(Z2) > EPS)

    # point-to-target-line distances: numerator affine in depth
    U0 = col(_U0)
    da1 = jnp.abs((U0 + d1_row * col(_U1)) / Z1)
    da2 = jnp.abs((U0 + d2_row * col(_U2)) / Z2)

    # target-point-to-projected-line distances via the undivided
    # homogeneous cross product
    ax, ay = col(_AX), col(_AY)
    q1x = ax + d1_row * col(_BX1)
    q1y = ay + d1_row * col(_BY1)
    q2x = ax + d2_row * col(_BX2)
    q2y = ay + d2_row * col(_BY2)
    PLx = q1y * Z2 - q2y * Z1
    PLy = q2x * Z1 - q1x * Z2
    PLz = q1x * q2y - q1y * q2x
    rden = jax.lax.rsqrt(jnp.maximum(PLx * PLx + PLy * PLy,
                                     f32(EPS) * f32(EPS)))
    db1 = jnp.abs(PLx * col(_Q1X) + PLy * col(_Q1Y) + PLz) * rden
    db2 = jnp.abs(PLx * col(_Q2X) + PLy * col(_Q2Y) + PLz) * rden

    dist = jnp.maximum(jnp.maximum(da1, da2), jnp.maximum(db1, db2))
    y_pos = dist * dist * inv_sig_p2

    # 3D angle term (cudawrapper.cu:405-415).  The >90-degree fold is
    # acos(|dot|), evaluated with the Abramowitz & Stegun 4.4.46
    # polynomial on [0, 1] (|err| ~ 2e-8 rad); only ang^2 is needed, so
    # acos = sqrt(1-x) P(x) enters squared as (1-x) P(x)^2.
    dots = (col(_DIRX) * row(_DIRX) + col(_DIRY) * row(_DIRY)
            + col(_DIRZ) * row(_DIRZ))
    xa = jnp.clip(jnp.abs(dots), 0.0, 1.0)
    poly = f32(-0.0012624911)
    for c in (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
              0.0889789874, -0.2145988016, 1.5707963050):
        poly = poly * xa + f32(c)
    y_ang = (1.0 - xa) * poly * poly * (f32(_DEG2) * inv_sig_a2)

    conf = jnp.exp(-jnp.maximum(y_pos, y_ang))

    # spatial gate: hypotheses share the src rays => depth-delta test
    # (cudawrapper.cu:387-401)
    gate = ((jnp.abs(d1_row - d1_col) <= spatial_k * d1_row)
            & (jnp.abs(d2_row - d2_col) <= spatial_k * d2_row))

    iota_m2 = jax.lax.broadcasted_iota(jnp.int32, (T, 1), 0) + m2_off
    iota_m = jax.lax.broadcasted_iota(jnp.int32, (1, TM), 1) + m_off
    pair_ok = ((row(_VALID) > 0.5) & (col(_VALID) > 0.5) & gate & ok
               & (iota_m2 != iota_m))
    conf = jnp.where(pair_ok & (conf > support_threshold), conf, f32(0))
    return conf, col(_CAM)


def _kernel(need_ref, params_ref, tab_ref, out_ref, *, num_cams, m_tile,
            m2_tile):
    TM, T = m_tile, m2_tile
    f32 = jnp.float32
    s = pl.program_id(0)
    m_off = pl.program_id(1) * TM
    need = need_ref[s]
    params = tuple(params_ref[k] for k in range(4))

    def row(k):                       # [1, TM] — scored-match quantities
        return tab_ref[s, k, pl.ds(m_off, TM)][None, :]

    # tiles past need hold no valid slot (the row's outputs are 0)
    n_live = jnp.where(m_off < need, pl.cdiv(need, T), 0)

    def body(t, acc):
        m2_off = t * T

        def col(k):                   # [T, 1] — supporting-match quantities
            return tab_ref[s, k, pl.ds(m2_off, T)][:, None]

        conf, cam_col = _conf_tile(row, col, params, m_off, m2_off, TM, T)
        # the merge orders a row's slots by camera, so one m2 tile spans a
        # narrow camera range: reduce only over the cameras present
        live = col(_VALID) > 0.5
        cam_lo = jnp.min(jnp.where(live, cam_col, f32(num_cams)))
        cam_hi = jnp.max(jnp.where(live, cam_col, f32(-1)))

        def update(n, a):
            return jnp.maximum(a, jnp.max(
                jnp.where(cam_col == f32(n), conf, f32(0)), axis=0))

        return tuple(
            jax.lax.cond((cam_lo <= n) & (n <= cam_hi),
                         functools.partial(update, n), lambda a: a, a)
            for n, a in enumerate(acc))

    acc = jax.lax.fori_loop(
        0, n_live, body,
        tuple(jnp.zeros((TM,), f32) for _ in range(num_cams)))

    # sum of per-camera maxima over cameras other than the match's own
    cam_row = tab_ref[s, _CAM, pl.ds(m_off, TM)]
    valid_row = tab_ref[s, _VALID, pl.ds(m_off, TM)]
    total = jnp.zeros((TM,), f32)
    for n, a in enumerate(acc):
        total = total + jnp.where(cam_row == f32(n), f32(0), a)
    out_ref[s, pl.ds(m_off, TM)] = jnp.where(valid_row > 0.5, total,
                                             f32(0))


def _slot_table(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid,
                P_nb, segs_nb, tcoords=None):
    """[S, _NT, M] per-slot table the kernel reads (slot order above):
    the slot's own scalars plus its camera's projection coefficients
    (a_{cam}, b_{s,cam}) and the affine point-to-line numerators U."""
    S, M = cam.shape
    f32 = jnp.float32
    p1, p2 = g.seg_endpoints(segs_src)              # [S, 3]
    ray1 = g.ray_dir(RtKinv_src, p1)
    ray2 = g.ray_dir(RtKinv_src, p2)
    cam_s = jnp.maximum(cam, 0)
    if tcoords is None:
        from .pairwise import gather_target_coords
        tcoords = gather_target_coords(segs_nb, cam, tgt)
    q1x, q1y = tcoords[..., 0], tcoords[..., 1]
    q2x, q2y = tcoords[..., 2], tcoords[..., 3]
    tlx = q1y - q2y
    tly = q2x - q1x
    tlz = q1x * q2y - q1y * q2x
    itden = 1.0 / jnp.maximum(jnp.sqrt(tlx * tlx + tly * tly), EPS)

    d1 = depths[..., 0]
    d2 = depths[..., 1]
    # hypothesis direction: (C + d2 ray2) - (C + d1 ray1), per component
    dirc = [d2 * ray2[:, i:i + 1] - d1 * ray1[:, i:i + 1] for i in range(3)]
    dnorm = jnp.maximum(jnp.sqrt(dirc[0] ** 2 + dirc[1] ** 2
                                 + dirc[2] ** 2), EPS)
    dirn = [c / dnorm for c in dirc]

    # projection coefficients as explicit elementwise sums (an f32 einsum
    # may run in TF32 on the GPU)
    Pr = P_nb.astype(f32)                            # [N, 3, 4]
    a_cam = (Pr[:, :, 0] * C_src[0] + Pr[:, :, 1] * C_src[1]
             + Pr[:, :, 2] * C_src[2] + Pr[:, :, 3])           # [N, 3]
    a = [a_cam[:, r][cam_s] for r in range(3)]                 # [S, M]
    b = []
    for ray in (ray1, ray2):
        for r in range(3):
            b_sn = (Pr[None, :, r, 0] * ray[:, None, 0]
                    + Pr[None, :, r, 1] * ray[:, None, 1]
                    + Pr[None, :, r, 2] * ray[:, None, 2])     # [S, N]
            b.append(jnp.take_along_axis(b_sn, cam_s, axis=1))
    U = [(tlx * a[0] + tly * a[1] + tlz * a[2]) * itden,
         (tlx * b[0] + tly * b[1] + tlz * b[2]) * itden,
         (tlx * b[3] + tly * b[4] + tlz * b[5]) * itden]

    planes = [d1, d2, cam.astype(f32), valid.astype(f32), *dirn,
              q1x, q1y, q2x, q2y, *a, *b, *U]
    return jnp.stack(planes, axis=1)                 # [S, _NT, M]


@functools.partial(jax.jit, static_argnames=("support_threshold",
                                             "interpret", "tiles"))
def score_matches_triton(segs_src, mask_src, RtKinv_src, C_src,
                         cam, tgt, depths, valid,
                         P_nb, segs_nb,
                         sigma_p, sigma_a, spatial_k,
                         support_threshold=0.5,
                         interpret: bool = False, tcoords=None,
                         tiles: tuple = DEFAULT_TILES):
    """Drop-in Pallas-Triton replacement for scoring.score_matches.

    Takes any M: the match-slot axis is padded with invalid slots to a
    multiple of the tiles.  `tiles` = (m tile, m2 tile, num_warps,
    num_stages); tile sizes are powers of two.
    """
    S, M = cam.shape
    N = P_nb.shape[0]
    TM, T, num_warps, num_stages = tiles
    f32 = jnp.float32

    tab = _slot_table(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid,
                      P_nb, segs_nb, tcoords=tcoords)
    step = max(TM, T)
    Mp = -(-M // step) * step
    if Mp != M:
        fill = jnp.zeros((S, _NT, Mp - M), f32).at[:, _CAM].set(-1.0)
        tab = jnp.concatenate([tab, fill], axis=2)

    idx = jax.lax.broadcasted_iota(jnp.int32, (S, M), 1)
    need = jnp.max(jnp.where(valid, idx + 1, 0), axis=1).astype(jnp.int32)
    params = jnp.stack([
        1.0 / (2.0 * sigma_p * sigma_p),
        1.0 / (2.0 * sigma_a * sigma_a),
        spatial_k,
        jnp.float32(support_threshold),
    ]).astype(f32)

    kernel = functools.partial(_kernel, num_cams=N, m_tile=TM, m2_tile=T)
    conf = pl.pallas_call(
        kernel,
        grid=(S, Mp // TM),
        out_shape=jax.ShapeDtypeStruct((S, Mp), f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="score_matches",
    )(need, params, tab)
    return conf[:, :M]
