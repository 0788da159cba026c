"""Multi-device sharded matching must reproduce the single-chip engine.

Runs on the virtual 8-device CPU mesh (conftest.py)."""
import numpy as np
import jax
import pytest

from line3d_tpu.config import L3DConfig
from line3d_tpu.core.conditioning import compute_conditioning
from line3d_tpu.match import engine
from line3d_tpu.parallel import mesh as mesh_mod, sharded
from line3d_tpu.scene import view_similarities_from_worldpoints, \
    find_visual_neighbors
from synthetic import make_scene


@pytest.fixture(scope="module")
def setup():
    syn = make_scene(num_views=8)
    cams = syn.cameras
    cfg = L3DConfig()
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists,
                                                syn.scene.num_views)
    neighbors = find_visual_neighbors(sim, cams.baselines(),
                                      cfg.min_baseline, 4)
    return syn, cams, cfg, neighbors


def test_mesh_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_chip(setup):
    syn, cams, cfg, neighbors = setup
    scene = syn.scene
    S = scene.max_segments

    matches, best, med = engine.run_matching(scene, cams, neighbors, cfg)

    mesh = mesh_mod.make_view_mesh()
    Vp = mesh_mod.pad_views_to_mesh(scene.num_views, mesh)
    segments, seg_mask, stacks, nb_ids = sharded.build_stacks(
        scene, cams, neighbors, cfg, num_pad_views=Vp)
    out = sharded.sharded_match_all_views(
        segments, seg_mask, stacks,
        np.float32(cfg.sigma_p), np.float32(cfg.sigma_a),
        np.float32(cfg.confidence_threshold),
        quota=cfg.match_block_quota,
        m_total=min(cfg.max_matches_per_segment, S),
        row_chunk=min(128, S), k_export=S * 8, mesh=mesh)
    out = {k: np.asarray(v) for k, v in out.items()}

    # verified-match counts agree per view
    single_counts = {vm.view: len(vm.src_seg) for vm in matches}
    for v in range(scene.num_views):
        assert out["n_verified"][v] == single_counts.get(v, 0), v

    # per-segment best matches agree (cam/tgt ids + confidence)
    V = scene.num_views
    best_map = {}
    for k in range(best.view.size):
        best_map[(int(best.view[k]), int(best.seg[k]))] = (
            int(best.tgt_view[k]), int(best.tgt_seg[k]),
            float(best.score[k]))
    n_checked = 0
    for v in range(V):
        for s in range(S):
            if not out["best_has"][v, s]:
                assert (v, s) not in best_map
                continue
            cam_slot = int(out["best_cam"][v, s])
            tgt_global = int(nb_ids[v, cam_slot])
            tv, ts, score = best_map[(v, s)]
            assert tv == tgt_global and ts == int(out["best_tgt"][v, s])
            sharded_score = min(out["best_conf"][v, s] /
                                cfg.confidence_norm, 1.0)
            np.testing.assert_allclose(score, sharded_score, rtol=1e-5)
            n_checked += 1
    assert n_checked > 20

    # exported verified matches = the single-chip filtered match lists
    for vm in matches:
        v = vm.view
        packed = out["exp_packed"][v]
        src, camslot, tgt = sharded.unpack_export(
            packed[packed >= 0], S, nb_ids.shape[1])
        got = set(zip(src.tolist(),
                      [int(nb_ids[v, c]) for c in camslot],
                      tgt.tolist()))
        want = set(zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                       vm.tgt_seg.tolist()))
        assert got == want


def test_run_matching_sharded_engine_equivalence(setup):
    """The high-level sharded engine must reproduce run_matching outputs."""
    from line3d_tpu.match.engine import run_matching_sharded
    syn, cams, cfg, neighbors = setup
    scene = syn.scene

    m1, b1, med1 = engine.run_matching(scene, cams, neighbors, cfg)
    m2, b2, med2 = run_matching_sharded(scene, cams, neighbors, cfg)

    np.testing.assert_allclose(med1, med2, rtol=1e-6)
    assert b1.view.size == b2.view.size
    k1 = {(int(v), int(s)): (int(tv), int(ts), float(sc))
          for v, s, tv, ts, sc in
          zip(b1.view, b1.seg, b1.tgt_view, b1.tgt_seg, b1.score)}
    k2 = {(int(v), int(s)): (int(tv), int(ts), float(sc))
          for v, s, tv, ts, sc in
          zip(b2.view, b2.seg, b2.tgt_view, b2.tgt_seg, b2.score)}
    assert k1.keys() == k2.keys()
    for k in k1:
        assert k1[k][:2] == k2[k][:2], k
        np.testing.assert_allclose(k1[k][2], k2[k][2], rtol=1e-5)

    for vm1, vm2 in zip(m1, m2):
        assert vm1.view == vm2.view
        s1 = set(zip(vm1.src_seg.tolist(), vm1.tgt_view.tolist(),
                     vm1.tgt_seg.tolist()))
        s2 = set(zip(vm2.src_seg.tolist(), vm2.tgt_view.tolist(),
                     vm2.tgt_seg.tolist()))
        assert s1 == s2


def test_sharded_diffusion_matches_host():
    """Edge-sharded device diffusion over the 8-device mesh reproduces the
    host float64 reference-mode RDD."""
    from line3d_tpu.cluster import diffusion, diffusion_device
    rng = np.random.default_rng(7)
    n, e_und = 300, 2000
    a = rng.integers(0, n, e_und * 2)
    b = rng.integers(0, n, e_und * 2)
    keep = a < b
    pairs = np.unique(np.stack([a[keep], b[keep]], axis=1), axis=0)[:e_und]
    w_und = rng.uniform(0.05, 1.0, len(pairs))
    i = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)
    j = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)
    w = np.concatenate([w_und, w_und]).astype(np.float64)

    hi, hj, hw = diffusion.diffuse_reference(i, j, w, n, iterations=10)
    mesh = mesh_mod.make_view_mesh()
    di, dj, dw = diffusion_device.diffuse_reference_device(
        i, j, w, n, iterations=10, mesh=mesh)
    np.testing.assert_array_equal(hi, di)
    np.testing.assert_array_equal(hj, dj)
    np.testing.assert_allclose(hw, dw, rtol=5e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# Partitioning regression guard: the view scan must live INSIDE shard_map.
#
# A bare lax.map/scan OVER a mesh-sharded axis does NOT partition — XLA
# cannot split a scan over its scanned dimension, so every device would run
# all Vp iterations on gathered data: results stay correct and CPU-mesh
# equivalence tests (above) pass, but multi-chip scaling is silently zero.
# The only observable is the compiled/lowered program itself, so this test
# lowers sharded_match_all_views and pins the per-shard local shapes
# (leading dim Vp/n) inside the manual-computation region.
# ---------------------------------------------------------------------------

def _lowered_text(setup, n_dev, Vp):
    import jax.numpy as jnp
    from jax.sharding import Mesh
    syn, cams, cfg, neighbors = setup
    scene = syn.scene
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("views",))
    segments, seg_mask, stacks, nb_ids = sharded.build_stacks(
        scene, cams, neighbors, cfg, num_pad_views=Vp)
    lowered = sharded.sharded_match_all_views.lower(
        jnp.asarray(segments), jnp.asarray(seg_mask),
        {k: jnp.asarray(v) for k, v in stacks.items()},
        jnp.float32(cfg.sigma_p), jnp.float32(cfg.sigma_a),
        jnp.float32(cfg.confidence_threshold),
        quota=cfg.match_block_quota, m_total=32, row_chunk=32, k_export=64,
        mesh=mesh, packed=True)
    return lowered.as_text(), nb_ids.shape[1]


@pytest.mark.parametrize("n_dev", [8, 4])
def test_view_scan_partitions_over_mesh(setup, n_dev):
    Vp = 16
    txt, n_max = _lowered_text(setup, n_dev, Vp)

    # the program must contain a manual (per-shard) computation at all
    markers = [m for m in ("sdy.manual_computation", "SPMDFullToShardShape")
               if m in txt]
    assert markers, "no shard_map region in the lowered program"

    # the per-view metadata stacks must appear at their LOCAL shape
    # (leading dim Vp/n) — the scan trip count each device actually runs
    local = f"tensor<{Vp // n_dev}x{n_max}x3x3xf32"
    assert local in txt, (
        f"local F_nb stack {local} absent — the view scan is not "
        f"partitioned over the {n_dev}-device mesh")

    # and the manual region must NOT scan the full-shape stack: that is
    # exactly the every-device-runs-all-views failure mode
    if "sdy.manual_computation" in txt:
        start = txt.index("sdy.manual_computation")
        end = txt.index("sdy.return", start)
        body = txt[start:end]
        full = f"tensor<{Vp}x{n_max}x3x3xf32"
        assert full not in body, (
            "full-shape neighbor stack inside the shard_map body — the "
            "scan runs all Vp views on every device")


def test_chunked_dispatch_executable_is_scene_size_independent():
    """Two different scene sizes must reuse the SAME chunk-shaped
    executables for matching and collinearity (the whole point of chunked
    dispatch: each new scene size would otherwise pay a fresh scene-scale
    compile)."""
    from line3d_tpu.match.collinearity import collinearity_compact_all

    cfg = L3DConfig(pad_multiple=64)
    results = {}
    # 17 and 25 views land in the same power-of-two chunk-count bucket
    # (Vp = 32); a bucket boundary crossing MAY compile one more size —
    # the guarantee is O(log V) executables, not one
    for V in (17, 25):
        syn = make_scene(num_views=V)
        cams = syn.cameras
        tr = compute_conditioning(cams.C)
        cams.transform(tr.Qinv, tr.scale)
        sim, _ = view_similarities_from_worldpoints(syn.wp_lists, V)
        neighbors = find_visual_neighbors(sim, cams.baselines(),
                                          cfg.min_baseline, 4)
        syn.scene.config = cfg
        bufs, ctx = engine.dispatch_matching_sharded(
            syn.scene, cams, neighbors, cfg)
        from line3d_tpu.match.collinearity import \
            collinearity_dispatch_chunked
        chunks = collinearity_dispatch_chunked(
            syn.scene.segments, syn.scene.seg_mask,
            cfg.collinearity_sigma, chunk=8)
        matches, best, med = engine.finalize_matching_sharded(
            bufs, ctx, syn.scene, cams, cfg)
        results[V] = (sharded.sharded_match_all_views._cache_size(),
                      collinearity_compact_all._cache_size(),
                      sum(len(vm.src_seg) for vm in matches))
        assert results[V][2] > 0, f"no matches at V={V}"

        # pow2 bucketing pads V=17 to Vp=32, which makes the final chunks
        # all-padding and exercises the trailing-dead-chunk skip — the
        # chunked result must still equal the per-view reference engine
        m_ref, b_ref, _ = engine.run_matching(syn.scene, cams, neighbors,
                                              cfg)
        ref = {vm.view: set(zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                                vm.tgt_seg.tolist())) for vm in m_ref}
        got = {vm.view: set(zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                                vm.tgt_seg.tolist())) for vm in matches}
        assert got == ref, f"chunked != per-view engine at V={V}"

    # the second scene size must not have added executables
    assert results[25][0] == results[17][0], \
        "matching executable recompiled for a second scene size"
    assert results[25][1] == results[17][1], \
        "collinearity executable recompiled for a second scene size"
