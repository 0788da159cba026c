"""Host-stage scaling measurement: affinity + diffusion + F-H + fit at
1000 views with production-density matching outputs.

The cluster-side stages (affinity enumeration, RDD, F-H union-find, line
fit) run on the HOST (numpy/C++), mirroring the reference's CPU stages
(clusterSegments2D line3D.cc:968-1252, performClustering clustering.cc,
processClusteredSegments line3D.cc:1306-1368).  The question (VERDICT r1
item 9): do they stay a small share of end-to-end time at the 1000-view
north star, or does SURVEY §7.6's parallel hook-and-compress clustering
need building?

Inputs are synthesized at production density instead of running the
device matching for 1000 views: G ground-truth 3D lines each visible in ~20
consecutive views of a 1000-camera ring, ~2500 best-match rows per view
(the segment cap is 3000), ~8 verified correspondences per segment (the
k_export = 8*S export budget), ~1 collinear pair per segment (measured
round-1 density).  That reproduces the data SHAPE the host stages see;
their cost does not depend on the values.

Usage: python scripts/host_stage_scaling.py [V]   (default 1000; CPU-only)
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")


def synthesize(V=1000, segs_per_view=2500, span=20, cand_per_seg=8,
               seed=0):
    """Best matches + verified correspondence lists + collinearity for a
    V-view flythrough over G 3D lines."""
    from line3d_tpu.config import L3DConfig
    from line3d_tpu.core.cameras import CameraSet
    from line3d_tpu.core.conditioning import compute_conditioning
    from line3d_tpu.match.engine import BestMatches, ViewMatches
    from line3d_tpu.match.collinearity import CollinMaps

    rng = np.random.default_rng(seed)
    cfg = L3DConfig()
    S = 3072                                  # padded production shape

    # cameras on a ring, conditioned like the pipeline does
    ang = 2 * np.pi * np.arange(V) / V
    C = np.stack([4 * np.cos(ang), 4 * np.sin(ang), np.full(V, 1.4)], 1)
    look = -C / np.linalg.norm(C, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    z = look
    x = np.cross(look, up); x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    t = -np.einsum("vij,vj->vi", R, C)
    K = np.tile(np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1.0]]),
                (V, 1, 1))
    cams = CameraSet(K=K, R=R, t=t, width=np.full(V, 1920),
                     height=np.full(V, 1080))
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    cams.median_depth[:] = np.linalg.norm(cams.C, axis=1).mean()

    # G lines, line g visible in views [g*V/G - span/2, ... + span/2)
    G = V * segs_per_view // span
    A = rng.uniform(-1, 1, (G, 3))
    d = rng.normal(size=(G, 3)); d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = A + d * rng.uniform(0.2, 1.0, (G, 1))

    # per view: which lines it sees (consecutive window), seg index = rank
    first = (np.arange(G) * V // G - span // 2) % V
    view_lines = [[] for _ in range(V)]
    for g in range(G):
        for k in range(span):
            view_lines[(first[g] + k) % V].append(g)
    seg_of = {}                                # (view, line) -> seg idx
    for v in range(V):
        view_lines[v] = np.array(view_lines[v][:segs_per_view])
        for s, g in enumerate(view_lines[v]):
            seg_of[(v, g)] = s

    # best-match rows: every (v, s) pairs with a random other view of g
    rows_view, rows_seg, rows_tv, rows_ts, rows_g = [], [], [], [], []
    for v in range(V):
        for s, g in enumerate(view_lines[v]):
            others = [(first[g] + k) % V for k in range(span)
                      if (first[g] + k) % V != v
                      and ((first[g] + k) % V, g) in seg_of]
            if not others:
                continue
            tv = others[rng.integers(len(others))]
            rows_view.append(v); rows_seg.append(s)
            rows_tv.append(tv); rows_ts.append(seg_of[(tv, g)])
            rows_g.append(g)
    n = len(rows_view)
    gg = np.array(rows_g)
    t1 = rng.uniform(0, 0.4, n); t2 = rng.uniform(0.6, 1.0, n)
    noise = lambda: rng.normal(0, 5e-4, (n, 3))
    P1 = A[gg] + t1[:, None] * (B[gg] - A[gg]) + noise()
    P2 = A[gg] + t2[:, None] * (B[gg] - A[gg]) + noise()
    dirv = P2 - P1; dirv /= np.linalg.norm(dirv, axis=1, keepdims=True)
    vv = np.array(rows_view)
    best = BestMatches(
        view=vv.astype(np.int32), seg=np.array(rows_seg, np.int32),
        tgt_view=np.array(rows_tv, np.int32),
        tgt_seg=np.array(rows_ts, np.int32),
        score=rng.uniform(0.5, 1.0, n).astype(np.float32),
        P1=P1, P2=P2, dir=dirv,
        d1=np.linalg.norm(P1 - cams.C[vv], axis=1).astype(np.float32),
        d2=np.linalg.norm(P2 - cams.C[vv], axis=1).astype(np.float32))

    # verified correspondence lists: per (v, s), cand_per_seg co-views of g
    matches = []
    for v in range(V):
        src, tvs, tss = [], [], []
        for s, g in enumerate(view_lines[v]):
            cnt = 0
            for k in range(span):
                o = (first[g] + k) % V
                if o == v or (o, g) not in seg_of:
                    continue
                src.append(s); tvs.append(o); tss.append(seg_of[(o, g)])
                cnt += 1
                if cnt >= cand_per_seg:
                    break
        matches.append(ViewMatches(
            view=v, src_seg=np.array(src, np.int32),
            tgt_view=np.array(tvs, np.int32),
            tgt_seg=np.array(tss, np.int32)))

    # collinearity: ~1 partner/segment (measured round-1 density)
    cm = CollinMaps([{} for _ in range(V)])
    fv, fi, fj, fw = [], [], [], []
    for v in range(V):
        nseg = len(view_lines[v])
        i = np.arange(0, nseg - 1, 2)
        fv.append(np.full(2 * len(i), v)); fi.append(np.ravel([i, i + 1]))
        fj.append(np.ravel([i + 1, i]))
        fw.append(np.full(2 * len(i), 0.7))
    cm.flat_view = np.concatenate(fv).astype(np.int32)
    cm.flat_i = np.concatenate(fi).astype(np.int32)
    cm.flat_j = np.concatenate(fj).astype(np.int32)
    cm.flat_w = np.concatenate(fw).astype(np.float32)
    order = np.lexsort((cm.flat_j, cm.flat_i, cm.flat_view))
    for k in ("flat_view", "flat_i", "flat_j", "flat_w"):
        setattr(cm, k, getattr(cm, k)[order])
    for v, i, j, w in zip(cm.flat_view, cm.flat_i, cm.flat_j, cm.flat_w):
        cm[v].setdefault(int(i), {})[int(j)] = float(w)

    return cams, cfg, tr, best, matches, cm, S


def main():
    V = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    from line3d_tpu.cluster import affinity, fh, diffusion as diffusion_mod
    from line3d_tpu.fit import lines as fit_lines

    t0 = time.time()
    cams, cfg, tr, best, matches, cm, S = synthesize(V)
    print(f"[scale] synthesized V={V}: {best.view.size} best rows, "
          f"{sum(m.src_seg.size for m in matches)} correspondences, "
          f"{cm.flat_w.size} collinear pairs ({time.time()-t0:.1f}s)")

    t1 = time.time()
    graph = affinity.build_affinity_graph(best, matches, cm, cams, cfg, S)
    t_aff = time.time() - t1
    print(f"[scale] affinity: {len(graph.edges_w)} edges, "
          f"{graph.num_nodes} nodes  ({t_aff:.1f}s)")

    t_diff = 0.0
    if V <= 200:
        t1 = time.time()
        graph_d = diffusion_mod.run_diffusion(graph, cfg)
        t_diff = time.time() - t1
        print(f"[scale] host RDD (10 iter): {t_diff:.1f}s "
              f"(diffusion_backend='device' shards this on the mesh; host f64 "
              f"mode is the parity reference, measured to 200 views)")

    t1 = time.time()
    labels = fh.fh_cluster(graph.edges_i, graph.edges_j, graph.edges_w,
                           graph.num_nodes, cfg.fh_c)
    t_fh = time.time() - t1
    print(f"[scale] F-H clustering: {len(np.unique(labels))} clusters "
          f"({t_fh:.1f}s)")

    t1 = time.time()
    result = fit_lines.process_clusters(
        graph, labels, best, tr, cfg, S,
        scene_segments=np.zeros((V, 1, 4), np.float32),
        P_cond=cams.P)
    t_fit = time.time() - t1
    print(f"[scale] fit: {len(result)} 3D lines ({t_fit:.1f}s)")

    host_total = t_aff + t_fh + t_fit
    print(f"[scale] t_cluster (affinity+FH+fit, diffusion off) = "
          f"{host_total:.1f}s; +host-RDD = {host_total + t_diff:.1f}s")
    print(f"[scale] host cluster stage per view: "
          f"{host_total / V:.4f}s")


if __name__ == "__main__":
    main()
