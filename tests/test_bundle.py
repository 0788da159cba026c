"""Camera-coupled bundle adjustment (fit/bundle.py): joint line + pose
Gauss-Newton with Schur elimination of the line blocks.

The north-star capability (BASELINE.json: "final line bundle adjustment …
distributed via Schur-complement reduction", across the device mesh).  Pinned here:

  * on a synthetic scene with PERTURBED camera poses, joint refinement
    reaches a reprojection rms that line-only refinement cannot (the lines
    can't absorb a pose error that's inconsistent across views),
  * the recovered poses move toward the truth (up to the fixed gauge),
  * sharded ≡ unsharded over the 8-device CPU mesh (the reduced camera
    system is psum'd over the shards),
  * the gauge camera stays pinned.
"""
import numpy as np
import pytest

import jax

from line3d_tpu.fit import bundle, refine
from line3d_tpu.fit.lines import fit_line_direction
from line3d_tpu.parallel import mesh as mesh_mod
from synthetic import make_scene


def _bundle_fixture(seed=3, rot_noise=0.008, t_noise=0.01):
    """Clustered member data from a synthetic scene whose cameras are
    perturbed AFTER projecting (so the 2D observations are consistent with
    the TRUE poses, and the perturbed poses carry a recoverable error)."""
    syn = make_scene(num_views=10, noise_px=0.0, seed=seed)
    cams = syn.cameras
    rng = np.random.default_rng(seed)

    # ground-truth 3D lines -> member lists per line (same recipe as
    # tests/test_refine.py)
    mviews, msegs, P0s, ds = [], [], [], []
    for li, (A, B) in enumerate(syn.lines3d):
        mv, ms = [], []
        for v in range(syn.scene.num_views):
            hits = np.nonzero(syn.seg_line_id[v] == li)[0]
            for s in hits:
                mv.append(v)
                ms.append(s)
        if len(mv) < 4:
            continue
        mviews.append(np.array(mv))
        msegs.append(np.array(ms))
        d_true = (B - A) / np.linalg.norm(B - A)
        P0s.append((A + B) / 2 + rng.normal(0, 0.02, 3))
        d0 = d_true + rng.normal(0, 0.02, 3)
        ds.append(d0 / np.linalg.norm(d0))

    vidx, p1, p2, mask = bundle.build_bundle_member_data(
        mviews, msegs, syn.scene.segments)

    # perturb every pose except the gauge camera (index 0)
    V = syn.scene.num_views
    R_true, t_true = cams.R.copy(), cams.t.copy()
    R_pert, t_pert = R_true.copy(), t_true.copy()
    for v in range(1, V):
        w = rng.normal(0, rot_noise, 3)
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
        R_pert[v] = dR @ R_true[v]
        t_pert[v] = t_true[v] + rng.normal(0, t_noise, 3)

    return dict(K=cams.K, R_true=R_true, t_true=t_true,
                R_pert=R_pert, t_pert=t_pert,
                P0=np.stack(P0s), d=np.stack(ds),
                vidx=vidx, p1=p1, p2=p2, mask=mask,
                mviews=mviews, msegs=msegs, scene=syn.scene)


def test_bundle_beats_line_only_under_pose_error():
    fx = _bundle_fixture()

    # line-only refinement with the WRONG poses frozen
    Pm = fx["K"] @ np.concatenate(
        [fx["R_pert"], fx["t_pert"][..., None]], axis=-1)
    Pm_m, p1_m, p2_m, mask_m = refine.build_cluster_member_data(
        fx["mviews"], fx["msegs"], fx["scene"].segments, Pm)
    _, _, rms_b, rms_line = refine.refine_lines(
        fx["P0"], fx["d"], Pm_m, p1_m, p2_m, mask_m, iterations=8)
    n_res = np.maximum(mask_m.sum(axis=1) * 2, 1)
    line_only = np.sqrt((rms_line ** 2 * n_res).sum() / n_res.sum())

    P0f, df, Rf, tf, rb, ra = bundle.bundle_adjust(
        fx["P0"], fx["d"], fx["K"], fx["R_pert"], fx["t_pert"],
        fx["vidx"], fx["p1"], fx["p2"], fx["mask"], iterations=8)

    # the joint solve must reach a DISTINCTLY lower reprojection rms than
    # line-only refinement under pose error (pose error is inconsistent
    # across views, so lines alone cannot absorb it)
    assert ra < rb, (rb, ra)
    assert ra < 0.5 * line_only, (ra, line_only)

    # and the poses must move toward the truth
    def pose_err(R, t):
        dr = sum(np.linalg.norm(R[v] - fx["R_true"][v]) for v in range(1, 10))
        dt = sum(np.linalg.norm(t[v] - fx["t_true"][v]) for v in range(1, 10))
        return dr + dt
    assert pose_err(Rf, tf) < pose_err(fx["R_pert"], fx["t_pert"])


def test_bundle_gauge_camera_pinned():
    fx = _bundle_fixture()
    _, _, Rf, tf, _, _ = bundle.bundle_adjust(
        fx["P0"], fx["d"], fx["K"], fx["R_pert"], fx["t_pert"],
        fx["vidx"], fx["p1"], fx["p2"], fx["mask"], iterations=4)
    np.testing.assert_allclose(Rf[0], fx["R_pert"][0], atol=1e-6)
    np.testing.assert_allclose(tf[0], fx["t_pert"][0], atol=1e-6)


def test_bundle_sharded_matches_unsharded():
    """The cluster axis shards over the mesh; the reduced camera system is
    psum'd — results must match the single-device run to f32 tolerance."""
    fx = _bundle_fixture(seed=5)
    mesh = mesh_mod.make_view_mesh(jax.devices()[:8])

    un = bundle.bundle_adjust(
        fx["P0"], fx["d"], fx["K"], fx["R_pert"], fx["t_pert"],
        fx["vidx"], fx["p1"], fx["p2"], fx["mask"], iterations=5)
    sh = bundle.bundle_adjust(
        fx["P0"], fx["d"], fx["K"], fx["R_pert"], fx["t_pert"],
        fx["vidx"], fx["p1"], fx["p2"], fx["mask"], iterations=5,
        mesh=mesh)

    # the padded-shard einsum order differs from the unsharded one, so
    # allow tight f32 tolerance rather than bit equality
    np.testing.assert_allclose(sh[0], un[0], rtol=0, atol=5e-4)   # P0
    np.testing.assert_allclose(sh[1], un[1], rtol=0, atol=5e-4)   # d
    np.testing.assert_allclose(sh[2], un[2], rtol=0, atol=5e-4)   # R
    np.testing.assert_allclose(sh[3], un[3], rtol=0, atol=5e-4)   # t
    assert abs(sh[5] - un[5]) < 1e-3


def test_pipeline_bundle_adjust_end_to_end():
    """config.bundle_adjust_cameras drives the joint BA inside the
    pipeline: refined poses surface on Line3D.refined_poses (original
    frame), rms lands in stats, and lines still come out."""
    from line3d_tpu import Line3D
    from line3d_tpu.config import L3DConfig

    syn = make_scene(num_views=10, noise_px=0.4, seed=7)
    cfg = L3DConfig(use_collinearity=False, bundle_adjust_cameras=True,
                    bundle_iterations=3)
    l3d = Line3D(config=cfg)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v], width=640, height=480)
    res = l3d.compute_3d_model(perform_diffusion=False)
    assert len(res) >= 10
    assert l3d.refined_poses is not None
    Rf, tf = l3d.refined_poses
    assert Rf.shape == (10, 3, 3) and tf.shape == (10, 3)
    # orthonormal rotations out of the un-conditioning
    for v in range(10):
        np.testing.assert_allclose(Rf[v] @ Rf[v].T, np.eye(3), atol=1e-5)
    assert l3d.stats["ba_rms_after"] <= l3d.stats["ba_rms_before"] + 1e-6


def test_bundle_noop_on_clean_scene():
    """With exact poses and near-exact lines the solve must not wander off
    (accept gate rejects non-improving steps)."""
    fx = _bundle_fixture(rot_noise=0.0, t_noise=0.0)
    P0f, df, Rf, tf, rb, ra = bundle.bundle_adjust(
        fx["P0"], fx["d"], fx["K"], fx["R_true"], fx["t_true"],
        fx["vidx"], fx["p1"], fx["p2"], fx["mask"], iterations=4)
    assert ra <= rb + 1e-6
    assert ra < 0.35, ra      # sub-pixel optimum on a clean scene
