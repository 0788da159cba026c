"""Match-capacity correctness: the device shape caps must not change results.

The reference keeps every raw match in an unbounded list
(cudawrapper.cu:923-1007); line3d_tpu caps the per-segment match table
(max_matches_per_segment, match_block_quota) for fixed shapes.  The
contract under test:

  * overflow == 0  =>  the capped result is bit-identical to uncapped
    (caps can only drop matches — nothing else in the program depends on
    the capacity),
  * overflow  > 0  =>  the uncapped_fallback re-matches exactly those
    views at true capacity and restores reference semantics end-to-end.

These tests FAIL if a cap silently drops result-changing matches.
"""
import dataclasses

import numpy as np
import pytest

from line3d_tpu import Line3D, L3DConfig
from line3d_tpu.core.conditioning import compute_conditioning
from line3d_tpu.match import engine
from line3d_tpu.scene import Scene, view_similarities_from_worldpoints, \
    find_visual_neighbors
from synthetic import make_scene


def _dense_syn(num_views=8, copies=6, jitter=1.5, seed=11):
    """Synthetic scene with each 2D segment duplicated `copies`x with
    pixel jitter: the duplicates are epipolar-consistent with each other,
    so per-segment gate-passing match counts grow ~copies^2 and saturate
    small caps (the regime CLAUDE.md records for the demo scene: 233/256
    slots used)."""
    syn = make_scene(num_views=num_views)
    rng = np.random.default_rng(seed)
    seg_lists = []
    for v in range(syn.scene.num_views):
        segs = syn.scene.segments[v][syn.scene.seg_mask[v]]
        reps = [segs]
        for _ in range(copies - 1):
            reps.append(segs + rng.normal(0, jitter, segs.shape)
                        .astype(np.float32))
        seg_lists.append(np.concatenate(reps, axis=0))
    dense = dataclasses.replace(
        syn, scene=Scene.from_ragged(seg_lists, syn.cameras,
                                     wp_lists=syn.wp_lists))
    return dense


def _setup(syn, cfg):
    cams = syn.cameras
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists,
                                                syn.scene.num_views)
    neighbors = find_visual_neighbors(sim, cams.baselines(),
                                      cfg.min_baseline, 4)
    return cams, neighbors


def _match_key(vm):
    return (vm.view, sorted(zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                                vm.tgt_seg.tolist())))


def _best_key(best):
    return {(int(v), int(s)): (int(tv), int(ts), round(float(sc), 6))
            for v, s, tv, ts, sc in zip(best.view, best.seg, best.tgt_view,
                                        best.tgt_seg, best.score)}


def test_overflow_zero_implies_uncapped_identity():
    """On a scene where the default caps never overflow, raising them must
    change nothing (the caps-only-drop theorem, checked)."""
    syn = make_scene(num_views=8)
    cfg = L3DConfig()
    cams, neighbors = _setup(syn, cfg)

    m1, b1, med1 = engine.run_matching(syn.scene, cams, neighbors, cfg)
    assert all(vm.overflow == 0 for vm in m1), \
        "scene unexpectedly overflows — pick a sparser fixture"

    big = dataclasses.replace(cfg, match_block_quota=128,
                              max_matches_per_segment=10**6)
    m2, b2, med2 = engine.run_matching(syn.scene, cams, neighbors, big)

    assert [_match_key(a) for a in m1] == [_match_key(a) for a in m2]
    assert _best_key(b1) == _best_key(b2)
    np.testing.assert_array_equal(med1, med2)


def test_dense_scene_saturates_and_fallback_restores_oracle():
    """Tiny caps on the dense scene must overflow; apply_uncapped_fallback
    must then reproduce the uncapped oracle bit-for-bit."""
    syn = _dense_syn()
    cfg = dataclasses.replace(L3DConfig(), match_block_quota=1,
                              max_matches_per_segment=8)
    cams, neighbors = _setup(syn, cfg)

    m_cap, b_cap, med_cap = engine.run_matching(syn.scene, cams, neighbors,
                                                cfg)
    over = [vm.view for vm in m_cap if vm.overflow > 0]
    assert over, "dense scene did not saturate the tiny caps"

    # oracle: every view at exact capacity (reference semantics)
    oracle = engine.rematch_views_exact(
        syn.scene, cams, neighbors, cfg,
        views=[vm.view for vm in m_cap])
    m_or = [oracle[vm.view][0] for vm in m_cap]
    med_or = med_cap.copy()
    rows = []
    for vm in m_cap:
        med_or[vm.view] = oracle[vm.view][2]
        if oracle[vm.view][1] is not None:
            rows.append(oracle[vm.view][1])
    b_or = engine._concat_best(rows)

    # the caps DID change results on this scene (otherwise the guard
    # would be vacuous here)
    assert [_match_key(a) for a in m_cap] != [_match_key(a) for a in m_or]

    # fallback splices the overflowing views back to oracle
    m_fb, b_fb, med_fb, n = engine.apply_uncapped_fallback(
        m_cap, b_cap, med_cap, syn.scene, cams, neighbors, cfg)
    assert n == len(over)
    assert [_match_key(a) for a in m_fb] == [_match_key(a) for a in m_or]
    assert _best_key(b_fb) == _best_key(b_or)
    np.testing.assert_array_equal(med_fb, med_or)


def test_rematch_ragged_neighbor_counts_unpack():
    """Regression: the per-view rematch packs camera slots with the PADDED
    neighbor-slot width (n_max) but used to unpack with the view's actual
    count — corrupting match identities for any view with fewer neighbors
    than the scene max (bit widths differ, e.g. 5 vs 2 slots)."""
    syn = _dense_syn(num_views=6)
    cfg = dataclasses.replace(L3DConfig(), match_block_quota=1,
                              max_matches_per_segment=8)
    cams = syn.cameras
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    # ragged: view 0 gets 5 neighbors (cbits=3), view 1 only 2 (cbits=1)
    neighbors = [[1, 2, 3, 4, 5], [0, 2], [0, 1], [0], [0], [0]]

    got = engine.rematch_views_exact(syn.scene, cams, neighbors, cfg,
                                     views=[0, 1])
    big = dataclasses.replace(cfg, match_block_quota=128,
                              max_matches_per_segment=10**6)
    m_or, b_or, _ = engine.run_matching(syn.scene, cams, neighbors, big)
    oracle = {vm.view: vm for vm in m_or}
    for v in (0, 1):
        vm = got[v][0]
        # every decoded target view must be a real neighbor of v
        assert set(np.unique(vm.tgt_view)) <= set(neighbors[v])
        assert _match_key(vm) == _match_key(oracle[v])


def test_sharded_rematch_matches_per_view_oracle():
    """rematch_views_exact_sharded (the chunked-device fallback the
    pipeline uses) must reproduce the per-view rematch oracle exactly —
    matches, best rows, and medians — including when the deliberately tiny
    export hint undersizes the packed export and triggers the strict
    per-view retry for the dropped views."""
    syn = _dense_syn()
    cfg = dataclasses.replace(L3DConfig(), match_block_quota=1,
                              max_matches_per_segment=8)
    cams, neighbors = _setup(syn, cfg)
    views = [v for v in range(syn.scene.num_views) if len(neighbors[v])]

    oracle = engine.rematch_views_exact(syn.scene, cams, neighbors, cfg,
                                        views)
    got = engine.rematch_views_exact_sharded(syn.scene, cams, neighbors,
                                             cfg, views, verified_hint=1,
                                             k_export_floor=64)
    assert set(got) == set(oracle)
    for v in views:
        vm_o, row_o, med_o = oracle[v]
        vm_g, row_g, med_g = got[v]
        assert _match_key(vm_o) == _match_key(vm_g)
        assert med_o == med_g
        if row_o is None:
            assert row_g is None
        else:
            np.testing.assert_array_equal(row_o["seg"], row_g["seg"])
            np.testing.assert_array_equal(row_o["tgt_view"],
                                          row_g["tgt_view"])
            np.testing.assert_array_equal(row_o["tgt_seg"],
                                          row_g["tgt_seg"])
            np.testing.assert_allclose(row_o["score"], row_g["score"],
                                       rtol=1e-6)


def test_pipeline_fallback_end_to_end_matches_uncapped():
    """Full pipeline: tiny caps + uncapped_fallback must produce the SAME
    final 3D lines as generous caps.  This is the test that fails when a
    cap silently drops result-changing matches."""
    syn = _dense_syn()

    def run(cfg, sharded=True):
        l3d = Line3D(config=cfg, use_sharded_engine=sharded)
        for v in range(syn.scene.num_views):
            l3d.add_view_segments(
                v, syn.scene.segments[v][syn.scene.seg_mask[v]],
                syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
                worldpoint_ids=syn.wp_lists[v], width=640, height=480)
        res = l3d.compute_3d_model(perform_diffusion=False)
        return res, l3d.stats

    # capacity_probe off: this test pins the FALLBACK machinery (capped
    # pass overflows, rematch restores the oracle); the one-pass probe
    # path is pinned separately below
    tiny = dataclasses.replace(L3DConfig(use_collinearity=False),
                               match_block_quota=1,
                               max_matches_per_segment=8,
                               uncapped_fallback=True,
                               capacity_probe=False)
    big = dataclasses.replace(L3DConfig(use_collinearity=False),
                              match_block_quota=128,
                              max_matches_per_segment=10**6)
    res_t, stats_t = run(tiny)
    # the oracle run uses the per-view engine (no export cap) at true
    # uncapped capacity — genuinely independent of the fallback machinery
    res_b, stats_b = run(big, sharded=False)

    assert stats_t["views_rematched_uncapped"] > 0
    assert stats_b["match_overflow"] == 0

    def keysets(res):
        return sorted(frozenset(zip(r.views2d.tolist(), r.segs2d.tolist()))
                      for r in res)
    assert keysets(res_t) == keysets(res_b)
    for rt, rb in zip(sorted(res_t, key=lambda r: len(r.segments3d)),
                      sorted(res_b, key=lambda r: len(r.segments3d))):
        np.testing.assert_allclose(rt.segments3d, rb.segments3d, rtol=1e-6)


def test_pipeline_probe_one_pass_exact_matches_uncapped():
    """One-pass exact matching (capacity_probe, the default): on a scene
    that saturates tiny caps, the probe must size the single mainline pass
    so that NOTHING overflows and NO view is rematched, and the final 3D
    lines must equal the independent per-view uncapped oracle."""
    syn = _dense_syn()

    def run(cfg, sharded=True):
        l3d = Line3D(config=cfg, use_sharded_engine=sharded)
        for v in range(syn.scene.num_views):
            l3d.add_view_segments(
                v, syn.scene.segments[v][syn.scene.seg_mask[v]],
                syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
                worldpoint_ids=syn.wp_lists[v], width=640, height=480)
        res = l3d.compute_3d_model(perform_diffusion=False)
        return res, l3d.stats

    tiny = dataclasses.replace(L3DConfig(use_collinearity=False),
                               match_block_quota=1,
                               max_matches_per_segment=8)
    assert tiny.capacity_probe and tiny.uncapped_fallback   # defaults
    big = dataclasses.replace(L3DConfig(use_collinearity=False),
                              match_block_quota=128,
                              max_matches_per_segment=10**6)
    res_t, stats_t = run(tiny)
    res_b, _ = run(big, sharded=False)

    # the whole point of the probe: exactness in ONE pass
    assert stats_t["views_rematched_uncapped"] == 0
    assert stats_t["match_overflow"] == 0
    assert stats_t["probe_m_total"] > 8          # caps were raised upfront

    def keysets(res):
        return sorted(frozenset(zip(r.views2d.tolist(), r.segs2d.tolist()))
                      for r in res)
    assert keysets(res_t) == keysets(res_b)
    for rt, rb in zip(sorted(res_t, key=lambda r: len(r.segments3d)),
                      sorted(res_b, key=lambda r: len(r.segments3d))):
        np.testing.assert_allclose(rt.segments3d, rb.segments3d, rtol=1e-6)


def test_probe_counters_match_oracle_counts():
    """The probe's (need, total, blockmax) must equal the exact counting
    program's per-view numbers (same pair kernel, same inputs)."""
    syn = _dense_syn(num_views=6)
    cfg = L3DConfig()
    cams, neighbors = _setup(syn, cfg)

    prep = engine.prepare_sharded_matching(syn.scene, cams, neighbors, cfg)
    need, total, bmax, nbmax = engine.finalize_capacity_probe(
        engine.dispatch_capacity_probe(prep))

    ctx = engine._ViewContext(syn.scene, cams, cfg,
                              max(len(n) for n in neighbors))
    for v in range(syn.scene.num_views):
        nb = np.asarray(neighbors[v], np.int64)
        if len(nb) == 0:
            assert need[v] == 0 and total[v] == 0
            continue
        (segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _P), nb_mask = \
            ctx.neighbor_arrays(v, nb)
        nv = np.asarray(engine._count_view_matches(
            ctx.segs_f32[v], ctx.mask[v], ctx.RtKinv32[v], ctx.C32[v],
            segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, nb_mask))
        assert need[v] == nv.sum(axis=0).max()
        assert total[v] == nv.sum()
        assert nbmax[v] == nv.max()


def test_fallback_off_warns(capsys):
    """With uncapped_fallback off, overflow must produce a loud warning
    and be visible in stats."""
    syn = _dense_syn()
    cfg = dataclasses.replace(L3DConfig(use_collinearity=False),
                              match_block_quota=1,
                              max_matches_per_segment=8,
                              uncapped_fallback=False)
    l3d = Line3D(config=cfg)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v], width=640, height=480)
    l3d.compute_3d_model(perform_diffusion=False)
    out = capsys.readouterr().out
    assert "WARNING" in out and "gate-passing" in out
    assert l3d.stats["match_overflow"] > 0
    assert l3d.stats["views_rematched_uncapped"] == 0


def test_decide_exact_capacities_effective_quota():
    """decide_exact_capacities must test losslessness against the EFFECTIVE
    block quota (compact_rows_blockq raises the per-block quota to
    ceil(m_total/B) and caps it at the block width), not the raw config
    quota — otherwise views that already fit the pre-warmed default launch
    trigger an override dispatch and a fresh first-execution remote
    compile."""
    cfg = L3DConfig()            # match_block_quota=8, m=256
    S, n_max = 3072, 10          # B = 24 blocks of 128 -> eff quota 11

    def mk(need, total, bmax, nbmax):
        return engine.decide_exact_capacities(
            np.array([need]), np.array([total]),
            np.array([bmax]), np.array([nbmax]), cfg, n_max, S)

    # bmax 11 fits ceil(256/24)=11 under the default launch: no override
    assert mk(need=256, total=100, bmax=11, nbmax=40) is None
    # bmax 12 exceeds it: override, and the chosen bucket must cover it
    d = mk(need=256, total=100, bmax=12, nbmax=40)
    assert d is not None
    B = S // 128
    eff = min(max(d["quota"], -(-d["m_total"] // B)), 128)
    assert eff >= 12
    # per_nb_cap compares against the LAUNCH capacity.  Quota-dominated
    # launch (quota=32 at m_total=256 -> width 24*32=768): nbmax=600
    # (pow2 1024) offers no shrink, nbmax=300 (pow2 512) does
    d = mk(need=256, total=100, bmax=12, nbmax=600)
    assert d is not None and d["per_nb_cap"] is None
    d = mk(need=256, total=100, bmax=12, nbmax=300)
    assert d is not None and d["per_nb_cap"] == 512
    # min_capacity-dominated launch (need=1024 raises the effective quota
    # to ceil(1024/24)=43 -> width 1032, NOT the raw-quota 24*8=192):
    # nbmax=200 (pow2 256) must still engage the second compaction —
    # the old raw-quota comparison (256 >= 192) wrongly skipped it
    d = mk(need=1024, total=20000, bmax=30, nbmax=200)
    assert d is not None and d["per_nb_cap"] == 256
