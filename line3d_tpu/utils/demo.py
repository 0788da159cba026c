"""Self-contained demo scene builder (no image data needed).

Produces a posed multi-view scene of a 3D wireframe with exact 2D segment
projections — used by the compile-check entry point, the benchmark driver,
and examples.  Random extra segments can be added to reach production-scale
segment counts for benchmarking.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.cameras import CameraSet
from ..scene import Scene
from ..config import L3DConfig, DEFAULT_CONFIG


def wireframe(jitter: float = 0.18, seed: int = 7) -> np.ndarray:
    c = np.array([
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        [0.5, 0.5, 1.6],
    ], float) - np.array([0.5, 0.5, 0.5])
    rng = np.random.default_rng(seed)
    c = c + rng.uniform(-jitter, jitter, c.shape)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7), (4, 8), (5, 8), (6, 8), (7, 8)]
    return np.stack([np.stack([c[a], c[b]]) for a, b in edges])


def look_at(C, target, up=(0, 0, 1.0)):
    fwd = target - C
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, float)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-8:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ C


def facade_lines(n_cols: int = 30, n_rows: int = 16, cell: float = 1.0,
                 wing_depth: float = 8.0, seed: int = 11) -> np.ndarray:
    """[L, 2, 3] 3D segments of a windowed building facade with two
    perpendicular wings — structured geometry with realistic match density
    (a Herz-Jesu-like courtyard wall), unlike the uniform random clutter of
    make_demo_scene whose segments saturate the match caps by construction.

    Main wall spans the x-z plane at y=0 (x in [0, n_cols*cell], z in
    [0, n_rows*cell]); wings extend toward -y at both ends.  Each grid cell
    holds one randomly sized/offset window (4 frame segments + 2 mullions);
    every few rows a full-width floor line is added.  Window geometry is
    jittered per cell so no two segments are identical (symmetric repeats
    admit multi-view-consistent wrong matches, tests/synthetic.py).
    """
    rng = np.random.default_rng(seed)
    segs = []

    def window(org, ux, uz, w, h, cx, cz):
        """One window of size (w, h) at cell-local center (cx, cz): frame +
        cross mullions, in the wall plane spanned by (ux, uz) at org."""
        x0, x1 = cx - w / 2, cx + w / 2
        z0, z1 = cz - h / 2, cz + h / 2
        pts = lambda x, z: org + x * ux + z * uz  # noqa: E731
        segs.append([pts(x0, z0), pts(x1, z0)])
        segs.append([pts(x0, z1), pts(x1, z1)])
        segs.append([pts(x0, z0), pts(x0, z1)])
        segs.append([pts(x1, z0), pts(x1, z1)])
        xm = rng.uniform(0.4, 0.6) * (x1 - x0) + x0
        zm = rng.uniform(0.4, 0.6) * (z1 - z0) + z0
        segs.append([pts(x0, zm), pts(x1, zm)])
        segs.append([pts(xm, z0), pts(xm, z1)])

    def wall(org, ux, uz, cols, rows):
        for i in range(cols):
            for j in range(rows):
                w = rng.uniform(0.45, 0.7) * cell
                h = rng.uniform(0.5, 0.75) * cell
                cx = (i + rng.uniform(0.42, 0.58)) * cell
                cz = (j + rng.uniform(0.42, 0.58)) * cell
                window(org, ux, uz, w, h, cx, cz)
        # floor/cornice lines, broken into window-scale pieces the way a
        # real detector fragments long facade edges (and so no segment's
        # epipolar band sweeps the whole wall)
        for j in range(0, rows + 1, 4):
            z = j * cell
            for i in range(0, cols, 2):
                a = org + (i + rng.uniform(0.0, 0.2)) * cell * ux + z * uz
                b = org + (i + rng.uniform(1.6, 2.0)) * cell * ux + z * uz
                segs.append([a, b])

    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    wall(np.zeros(3), ex, ez, n_cols, n_rows)
    wing_cols = max(int(wing_depth / cell), 1)
    wall(np.zeros(3), -ey, ez, wing_cols, n_rows)
    wall(np.array([n_cols * cell, 0, 0]), -ey, ez, wing_cols, n_rows)
    return np.asarray(segs)


def make_facade_scene(num_views: int = 25, width: int = 1920,
                      height: int = 1440, focal: float = 1800.0,
                      seed: int = 0, config: L3DConfig = DEFAULT_CONFIG,
                      n_cols: int = 12, n_rows: int = 10,
                      distance: float = 13.0):
    """Structured-geometry benchmark scene at realistic match density.

    Cameras sweep an arc in front of the facade (like the Herz-Jesu-P25
    capture), each looking at the wall center; segment endpoints are exact
    projections.  Unlike make_demo_scene's uniform random clutter (whose
    epipolar gate-passing counts saturate the match caps by construction,
    mean 233/256), per-segment candidate counts here resemble real imagery,
    so a capped run is provably reference-exact (overflow == 0).
    """
    rng = np.random.default_rng(seed)
    lines = facade_lines(n_cols=n_cols, n_rows=n_rows, seed=seed + 11)
    V = num_views
    cx, cz = n_cols / 2.0, n_rows / 2.0
    target = np.array([cx, 0.0, cz])

    Ks, Rs, ts = [], [], []
    for v in range(V):
        # arc of +/-60 deg around the wall normal, slight distance/height
        # variation like a hand-held capture; the wide arc keeps neighbor
        # baselines large so the epipolar gate stays selective
        ang = np.deg2rad(-60.0 + 120.0 * v / max(V - 1, 1))
        dist = distance * (1.0 + 0.08 * np.sin(3.1 * v))
        C = target + dist * np.array([np.sin(ang), -np.cos(ang), 0.0])
        C[2] = cz * rng.uniform(0.55, 0.75)
        R, t = look_at(C, target)
        K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0],
                      [0, 0, 1.0]])
        Ks.append(K); Rs.append(R); ts.append(t)

    cams = CameraSet(K=np.stack(Ks), R=np.stack(Rs), t=np.stack(ts),
                     width=np.full(V, width), height=np.full(V, height),
                     uncertainty_lower_px=config.uncertainty_lower_px,
                     uncertainty_upper_px=config.uncertainty_upper_px)

    A = lines[:, 0]                                  # [L, 3]
    B = lines[:, 1]
    seg_lists = []
    vis = np.zeros((V, len(lines)), bool)
    for v in range(V):
        pa, za = _project_batch(cams, v, A)
        pb, zb = _project_batch(cams, v, B)
        ok = (za > 0.1) & (zb > 0.1) & \
            _inside(pa, width, height) & _inside(pb, width, height)
        vis[v] = ok
        segs = np.concatenate([pa[ok], pb[ok]], axis=1).astype(np.float32)
        # decorrelate segment index from image position (the detector
        # orders by length): the per-128-block match quota assumes
        # spatially mixed blocks
        segs = segs[rng.permutation(len(segs))]
        seg_lists.append(segs)

    # worldpoints at window corners: one per 3D segment midpoint, visible
    # where the segment projects in-view — drives the view-similarity graph
    wp_lists = [np.flatnonzero(vis[v]).tolist() for v in range(V)]

    scene = Scene.from_ragged(seg_lists, cams, wp_lists=wp_lists,
                              config=config)
    return scene, cams


def _project_batch(cams: CameraSet, v: int, X: np.ndarray):
    x = (cams.K[v] @ (cams.R[v] @ X.T + cams.t[v][:, None])).T
    return x[:, :2] / x[:, 2:3], x[:, 2]


def _inside(p: np.ndarray, width: int, height: int) -> np.ndarray:
    return (p[:, 0] >= 0) & (p[:, 0] < width) & \
           (p[:, 1] >= 0) & (p[:, 1] < height)


def make_demo_scene(num_views: int = 10, width: int = 1920, height: int = 1440,
                    focal: float = 1800.0, radius: float = 4.0,
                    num_random_segments: int = 0, seed: int = 0,
                    config: L3DConfig = DEFAULT_CONFIG):
    """Scene with wireframe projections plus `num_random_segments` clutter
    segments per view (for realistic benchmark shapes)."""
    rng = np.random.default_rng(seed)
    lines = wireframe()
    V = num_views

    Ks, Rs, ts = [], [], []
    for v in range(V):
        ang = 2 * np.pi * v / V
        C = np.array([radius * np.cos(ang), radius * np.sin(ang),
                      radius * 0.35])
        R, t = look_at(C, np.zeros(3))
        K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0],
                      [0, 0, 1.0]])
        Ks.append(K); Rs.append(R); ts.append(t)

    cams = CameraSet(K=np.stack(Ks), R=np.stack(Rs), t=np.stack(ts),
                     width=np.full(V, width), height=np.full(V, height),
                     uncertainty_lower_px=config.uncertainty_lower_px,
                     uncertainty_upper_px=config.uncertainty_upper_px)

    seg_lists = []
    for v in range(V):
        segs = []
        for A, B in lines:
            def proj(X):
                x = cams.K[v] @ (cams.R[v] @ X + cams.t[v])
                return x[:2] / x[2], x[2]
            pa, za = proj(A)
            pb, zb = proj(B)
            if za <= 0.1 or zb <= 0.1:
                continue
            if not (0 <= pa[0] < width and 0 <= pa[1] < height and
                    0 <= pb[0] < width and 0 <= pb[1] < height):
                continue
            segs.append(np.concatenate([pa, pb]))
        for _ in range(num_random_segments):
            p = rng.uniform([0, 0], [width, height])
            ang = rng.uniform(0, np.pi)
            ln = rng.uniform(20, 200)
            d = np.array([np.cos(ang), np.sin(ang)]) * ln
            segs.append(np.concatenate([p, p + d]))
        seg_lists.append(np.asarray(segs, np.float32).reshape(-1, 4))

    # worldpoints from line samples
    wp_lists = [[] for _ in range(V)]
    wp = 0
    for A, B in lines:
        for s in np.linspace(0.1, 0.9, 6):
            X = A + s * (B - A)
            for v in range(V):
                x = cams.K[v] @ (cams.R[v] @ X + cams.t[v])
                if x[2] > 0.1 and 0 <= x[0] / x[2] < width and \
                        0 <= x[1] / x[2] < height:
                    wp_lists[v].append(wp)
            wp += 1

    scene = Scene.from_ragged(seg_lists, cams, wp_lists=wp_lists,
                              config=config)
    return scene, cams


def view_match_inputs(scene: Scene, cams: CameraSet, config: L3DConfig,
                      num_neighbors: int = 10, view: int | None = None):
    """Device inputs of one view's matching step, as the pipeline builds
    them: conditions `cams` in place, picks the visual neighbors, and pads
    the neighbor axis to `num_neighbors`.  `view=None` takes the view with
    the largest exact per-segment match count (the view that sets the
    exact launch capacity).

    Returns (view, src (segs, mask, RtKinv, C), nb (segs, mask, F, RtKinv,
    C, P, nb_mask), spatial_k, need) — need is that view's exact
    per-segment capacity."""
    from ..core.conditioning import compute_conditioning
    from ..match import engine
    from ..scene import view_similarities_from_worldpoints, \
        find_visual_neighbors

    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    sim, _ = view_similarities_from_worldpoints(scene.wp_lists,
                                                scene.num_views)
    neighbors = find_visual_neighbors(sim, cams.baselines(),
                                      config.min_baseline, num_neighbors)
    ctx = engine._ViewContext(scene, cams, config, num_neighbors)

    def inputs(v):
        nb = np.asarray(neighbors[v], np.int64)
        (segs_nb, mask_nb, F_nb, R_nb, C_nb, P_nb), nb_mask = \
            ctx.neighbor_arrays(v, nb)
        src = (ctx.segs_f32[v], ctx.mask[v], ctx.RtKinv32[v], ctx.C32[v])
        nbd = (segs_nb, mask_nb, F_nb, R_nb, C_nb, P_nb, nb_mask)
        counts = np.asarray(engine._count_view_matches(
            *src, *nbd[:5], nb_mask))
        need = int(counts.sum(axis=0).max())
        return (tuple(jnp.asarray(x) for x in src),
                tuple(jnp.asarray(x) for x in nbd), need)

    if view is None:
        needs = [inputs(v)[2] if len(neighbors[v]) else -1
                 for v in range(scene.num_views)]
        view = int(np.argmax(needs))
    src, nbd, need = inputs(view)
    return view, src, nbd, float(ctx.spatial_ks[view]), need


@functools.partial(jax.jit, static_argnames=("quota", "m_total"))
def match_table(src, nbd, quota: int, m_total: int):
    """One view's merged match table at the given capacities, as the
    matching step builds it before scoring: (cam, tgt, depths, valid,
    tcoords, overflow)."""
    from ..match import pairwise
    segs_src, mask_src, RtKinv_src, C_src = src
    segs_nb, mask_nb, F_nb, R_nb, C_nb, _P_nb, nb_mask = nbd
    res = pairwise.match_view_against_neighbors(
        segs_src, mask_src, RtKinv_src, C_src, segs_nb, mask_nb, F_nb,
        R_nb, C_nb, nb_mask, quota, min_capacity=m_total)
    cam, tgt, valid = pairwise.merge_neighbor_tables(
        res, m_total, segs_nb.shape[1])
    tcoords = pairwise.gather_target_coords(segs_nb, cam, tgt)
    depths = pairwise.depths_for_matches(
        segs_src, segs_nb, cam, tgt, valid, F_nb, RtKinv_src, R_nb, C_src,
        C_nb, tcoords=tcoords)
    n_kept = jnp.sum(res["valid"], axis=(0, 2))
    overflow = jnp.sum(res["overflow"]) + \
        jnp.sum(jnp.maximum(n_kept - m_total, 0))
    return cam, tgt, depths, valid, tcoords, overflow
