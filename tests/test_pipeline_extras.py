"""Pipeline extras: fixed view similarity path, larger view counts, stats."""
import numpy as np

from line3d_tpu import Line3D, L3DConfig
from line3d_tpu.scene import view_similarities_from_worldpoints
from synthetic import make_scene


def test_fixed_view_similarity_path():
    """addImage_fixed_sim equivalent (line3D.cc:220-342): the pipeline runs
    from externally supplied view similarities instead of worldpoints."""
    syn = make_scene(num_views=8)
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists,
                                                syn.scene.num_views)
    l3d = Line3D(config=L3DConfig(use_collinearity=False))
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
            syn.cameras.t[v].copy(), worldpoint_ids=None,
            width=640, height=480)
        l3d.set_view_similarity(
            v, {n: float(sim[v, n]) for n in range(syn.scene.num_views)
                if n != v})
    res = l3d.compute_3d_model(perform_diffusion=False)
    assert len(res) >= 8
    errs = []
    for line in res:
        pts = line.segments3d.reshape(-1, 3)
        best = min(np.linalg.norm(
            np.cross(pts - A, (B - A) / np.linalg.norm(B - A)),
            axis=1).mean() for A, B in syn.lines3d)
        errs.append(best)
    assert np.median(errs) < 0.01


def test_many_views_scale():
    """64 views on the 8-device mesh — exercises view padding + sharding at
    a size that does not divide anything conveniently (64 = 8x8 here, but
    neighbor counts vary per view)."""
    syn = make_scene(num_views=64, radius=5.0)
    l3d = Line3D(config=L3DConfig(use_collinearity=False,
                                  matching_neighbors=6))
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
            syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
            width=640, height=480)
    res = l3d.compute_3d_model(perform_diffusion=False)
    assert len(res) >= 8
    assert l3d.stats["num_views"] == 64
    # every line is seen from >= 4 distinct cameras
    for line in res:
        assert len(np.unique(line.views2d)) >= 4


def test_determinism():
    """Identical inputs -> byte-identical TXT output (the reference gets
    reproducibility only via its segment cache, SURVEY.md §4)."""
    import io as _io
    from line3d_tpu.io import writers

    def run():
        syn = make_scene(num_views=8)
        l3d = Line3D(config=L3DConfig(use_collinearity=True))
        for v in range(syn.scene.num_views):
            l3d.add_view_segments(
                v, syn.scene.segments[v][syn.scene.seg_mask[v]],
                syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
                syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
                width=640, height=480)
        res = l3d.compute_3d_model()
        import tempfile, os
        fd, path = tempfile.mkstemp(suffix=".txt")
        os.close(fd)
        l3d.save_3d_lines_as_txt(res, path)
        data = open(path, "rb").read()
        os.unlink(path)
        return data

    assert run() == run()


def test_stats_populated():
    syn = make_scene(num_views=6)
    l3d = Line3D(config=L3DConfig(use_collinearity=False))
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
            syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
            width=640, height=480)
    l3d.compute_3d_model()
    for key in ("num_views", "num_best", "num_edges", "num_lines",
                "t_match", "t_cluster", "t_total"):
        assert key in l3d.stats


def _run_scale(num_views):
    syn = make_scene(num_views=num_views, radius=6.0)
    l3d = Line3D(config=L3DConfig(use_collinearity=False,
                                  matching_neighbors=4,
                                  perform_diffusion=True))
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
            syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
            width=640, height=480)
    num_views = syn.scene.num_views
    res = l3d.compute_3d_model()
    assert l3d.stats["num_views"] == num_views
    assert len(res) >= 8
    for line in res:
        assert len(np.unique(line.views2d)) >= 4


def test_hundreds_of_views_scale():
    """256 views end-to-end with diffusion ON — far past the reference's
    comfortable range (GPU-memory-bound, README.txt:129-130); cost here is
    dominated by the one-time XLA compile of the sharded program."""
    _run_scale(256)


def test_thousand_views_scale():
    """1000 views (the reference documents diffusion as unusable >1000
    images, README.txt:144-146).  ~6 min cold compile on CPU, so opt-in:
    RUN_SCALE_1000=1 python -m pytest -k thousand.  Verified passing.
    The default-suite stand-ins are test_hundreds_of_views_scale above
    (256-view e2e) and test_cluster_stage_production_density below (the
    HOST stages at true production density, reduced view count)."""
    import os
    import pytest
    if os.environ.get("RUN_SCALE_1000") != "1":
        pytest.skip("set RUN_SCALE_1000=1 to run the 1000-view scale test")
    _run_scale(1000)


def test_cluster_stage_production_density():
    """The host cluster stages (affinity enumeration + F-H + fit) at TRUE
    production density — ~2500 best rows/view, 8 correspondences/segment,
    collinearity on — at a reduced view count (the default-suite
    promotion of the RUN_SCALE_1000 measurement; scripts/
    host_stage_scaling.py runs the same machinery at V=1000, measured
    ~11 s affinity + ~6 s F-H + ~7 s fit on a 4-core host).
    Pins that the native fused path recovers the planted 3D-line clusters."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from host_stage_scaling import synthesize
    from line3d_tpu.cluster import affinity, fh
    from line3d_tpu.fit import lines as fit_lines

    V = 120
    cams, cfg, tr, best, matches, cm, S = synthesize(V)
    graph = affinity.build_affinity_graph(best, matches, cm, cams, cfg, S)
    assert graph.num_nodes > 0.9 * best.view.size   # density as designed
    assert len(graph.edges_w) > 10 * graph.num_nodes
    labels = fh.fh_cluster(graph.edges_i, graph.edges_j, graph.edges_w,
                           graph.num_nodes, cfg.fh_c)
    result = fit_lines.process_clusters(
        graph, labels, best, tr, cfg, S,
        scene_segments=np.zeros((V, 1, 4), np.float32), P_cond=cams.P)
    # every planted line is seen by ~20 views at ~2500 segs/view; the
    # clusters must recover a line count of the right order
    n_planted = V * 2500 // 20
    assert 0.5 * n_planted < len(result) < 1.5 * n_planted


def _run_scene(syn, cfg, warmup=False, warmup_estimate=None):
    l3d = Line3D(config=cfg)
    if warmup:
        l3d.warmup_async(syn.scene.num_views, warmup_estimate)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
            syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
            width=640, height=480)
    res = l3d.compute_3d_model(perform_diffusion=False)
    return l3d, res


def test_stable_shapes_equivalence():
    """stable_shapes pads the segment axis to a shape bucket (smallest of
    cap/4, cap/2, cap holding the scene); results must be identical to the
    tight-shape run, and warmup_async with a size estimate must
    pre-compile the very executables the real run then uses."""
    syn = make_scene(num_views=6)
    # max_matches_per_segment is pinned at or below either run's S: the
    # capacity min(max_matches_per_segment, S) otherwise DIFFERS between
    # tight and padded shapes (the tight run truncates more, a legitimate
    # capacity effect, not a padding bug)
    base_cfg = L3DConfig(max_num_segments=160, pad_multiple=16,
                         matching_neighbors=4, max_matches_per_segment=16)
    stable_cfg = L3DConfig(max_num_segments=160, pad_multiple=16,
                           matching_neighbors=4, max_matches_per_segment=16,
                           stable_shapes=True)
    _, res_a = _run_scene(syn, base_cfg)
    l3d_b, res_b = _run_scene(syn, stable_cfg, warmup=True,
                              warmup_estimate=40)
    assert l3d_b.scene.max_segments == 48    # bucket: pad_to(160/4, 16)
    assert len(res_a) == len(res_b)
    for a, b in zip(sorted(res_a, key=lambda r: tuple(r.segments3d.ravel())),
                    sorted(res_b, key=lambda r: tuple(r.segments3d.ravel()))):
        np.testing.assert_allclose(a.segments3d, b.segments3d, atol=1e-5)


def test_stable_segment_buckets():
    """Under stable shapes the segment axis snaps to the smallest of
    {cap/4, cap/2, cap} that holds the scene (executable reuse without
    full-cap padding waste on sparse scenes)."""
    from line3d_tpu.scene import Scene, stable_segment_bucket
    from line3d_tpu.config import L3DConfig
    from line3d_tpu.core.cameras import CameraSet

    cfg = L3DConfig(stable_shapes=True)
    assert stable_segment_bucket(20, cfg) == 768
    assert stable_segment_bucket(768, cfg) == 768
    assert stable_segment_bucket(769, cfg) == 1536
    assert stable_segment_bucket(2000, cfg) == 3072
    assert stable_segment_bucket(3000, cfg) == 3072
    assert stable_segment_bucket(5000, cfg) == 5000  # beyond cap: actual

    V = 4
    K = np.tile(np.array([[100., 0, 50], [0, 100., 50], [0, 0, 1]]),
                (V, 1, 1))
    cams = CameraSet(K=K, R=np.tile(np.eye(3), (V, 1, 1)),
                     t=np.random.RandomState(0).randn(V, 3),
                     width=np.full(V, 100), height=np.full(V, 100),
                     uncertainty_lower_px=1.0, uncertainty_upper_px=5.0)
    segs = [np.random.RandomState(v).rand(30, 4).astype(np.float32)
            for v in range(V)]
    sc = Scene.from_ragged(segs, cams, wp_lists=[[0]] * V, config=cfg)
    assert sc.max_segments == 768
    sc2 = Scene.from_ragged(segs, cams, wp_lists=[[0]] * V,
                            config=L3DConfig(stable_shapes=False))
    assert sc2.max_segments == 128


def test_warmed_bucket_preference():
    """Scene building under stable_shapes prefers an already-warm segment
    bucket over a tighter cold one (a scene-scale compile costs far more
    than in-bucket padding), but never a warm bucket that cannot hold the
    data, and never widens past the natural bucket when that one is warm."""
    syn = make_scene(num_views=6)
    cfg = L3DConfig(max_num_segments=640, pad_multiple=16,
                    stable_shapes=True)

    def fresh():
        l3d = Line3D(config=cfg)
        for v in range(syn.scene.num_views):
            l3d.add_view_segments(
                v, syn.scene.segments[v][syn.scene.seg_mask[v]],
                syn.cameras.K[v].copy(), syn.cameras.R[v].copy(),
                syn.cameras.t[v].copy(), worldpoint_ids=syn.wp_lists[v],
                width=640, height=480)
        return l3d

    need = max(int(m.sum()) for m in syn.scene.seg_mask)
    assert need <= 160  # the synthetic house fits the smallest bucket

    l3d = fresh()                       # no warmup: natural bucket
    l3d._build_scene()
    assert l3d.scene.max_segments == 160
    assert 160 in l3d._ready_buckets    # recorded for later scenes

    l3d = fresh()                       # overshot warmup: reuse its bucket
    l3d._ready_buckets.add(320)
    l3d._build_scene()
    assert l3d.scene.max_segments == 320

    l3d = fresh()                       # natural bucket itself is warm
    l3d._ready_buckets.update({160, 320})
    l3d._build_scene()
    assert l3d.scene.max_segments == 160

    l3d = fresh()                       # warm size holding the data is used
    l3d._ready_buckets.add(16)          # (pipeline records any run size)
    l3d._build_scene()
    assert l3d.scene.max_segments == (16 if need <= 16 else 160)

    l3d = fresh()                       # warm bucket too small for the data
    assert need > 4
    l3d._ready_buckets.add(4)
    l3d._build_scene()
    assert l3d.scene.max_segments == 160


def test_zero_segment_views_skipped_and_duplicates_rejected():
    """A view with zero segments is not registered (addImage returns
    without creating the view, line3D.cc:188-198), and duplicate image ids
    are rejected on every registration path (line3D.cc:111-115)."""
    import pytest
    syn = make_scene(num_views=6)
    l3d = Line3D(config=L3DConfig())
    l3d.add_view_segments(0, np.zeros((0, 4), np.float32),
                          syn.cameras.K[0], syn.cameras.R[0],
                          syn.cameras.t[0], worldpoint_ids=syn.wp_lists[0],
                          width=640, height=480)
    assert l3d.num_cameras() == 0
    l3d.add_view_segments(1, syn.scene.segments[1][syn.scene.seg_mask[1]],
                          syn.cameras.K[1], syn.cameras.R[1],
                          syn.cameras.t[1], worldpoint_ids=syn.wp_lists[1],
                          width=640, height=480)
    with pytest.raises(ValueError):
        l3d.add_view_segments(
            1, syn.scene.segments[2][syn.scene.seg_mask[2]],
            syn.cameras.K[2], syn.cameras.R[2], syn.cameras.t[2],
            worldpoint_ids=syn.wp_lists[2], width=640, height=480)


def test_visual_neighbors_external_id_order():
    """Candidate iteration follows ascending EXTERNAL id (the reference's
    std::map order): registering views out of id order must produce the
    neighbor sets of the id-sorted problem."""
    from line3d_tpu.scene import find_visual_neighbors
    rng = np.random.RandomState(3)
    V = 6
    sim = rng.rand(V, V)
    sim = (sim + sim.T) / 2
    np.fill_diagonal(sim, 0)
    # make the greedy accept order matter: near-zero baselines between
    # some pairs so earlier-accepted neighbors block later candidates
    C = rng.randn(V, 3)
    C[3] = C[1] + 1e-6          # views 1 and 3 nearly coincide
    bl = np.linalg.norm(C[:, None] - C[None, :], axis=2)

    perm = np.array([4, 2, 0, 5, 1, 3])   # external ids of internal views
    # ground truth: solve the problem in external-id (sorted) layout
    inv = np.argsort(perm)
    nb_sorted = find_visual_neighbors(sim[np.ix_(inv, inv)],
                                      bl[np.ix_(inv, inv)], 0.25, 3)
    got = find_visual_neighbors(sim, bl, 0.25, 3, ext_ids=perm)
    for v in range(V):
        # internal view v has external id perm[v] = sorted-layout index
        e = np.sort(inv[nb_sorted[int(perm[v])]])
        np.testing.assert_array_equal(np.sort(got[v]), e)
