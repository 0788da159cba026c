#!/usr/bin/env python3
"""Smoke run of line3d_tpu on a GPU: the main path, through the entry points
a user calls, at full width, checked against the plain references.

    python chip_smoke.py             # one card, every phase below
    python chip_smoke.py --cards 4   # the multi-card path and its
                                     # one-card comparison, nothing else

Phases (one JSON line each, with its seconds):
  device     platform, device kind and count, the card's name and power
             limit; no GPU -> exit non-zero (there is no CPU fallback)
  native     build the native host library from its sources and load it
  kernels    the Pallas-Triton scoring kernel at S=3072 and M = 256, 1024,
             2048 on real match tables: compiled memory, agreement with
             the XLA twin, kernel and twin medians
  facade     25-view facade scene, exact, through Line3D
  clutter    25 x 2990-segment clutter scene, exact (M = 2048)
  detection  1920x1440 images drawn with numpy through Line3D.add_image
  backends   10-view house: device diffusion / refinement / camera BA
             against the host float64 references and the golden models

The last line of standard output is {"ok": true, "device": {...}}; any
failure raises, and the script exits non-zero without that line.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

import jax
import jax.numpy as jnp

from line3d_tpu import Line3D, L3DConfig
from line3d_tpu.io import writers
from line3d_tpu.utils import backend, demo
from line3d_tpu.utils.xla_cache import enable_persistent_cache

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tests"))

E2E_VIEWS = 25
CLUTTER_SEGMENTS = 2990
# kernel vs twin, per confidence value: |got - ref| <= ATOL + RTOL |ref|
# (the CPU interpret tests' bound: the kernel reassociates the projection
# and acos arithmetic), except where one support sits on the
# `> support_threshold` edge and flips — bounded as a fraction
RTOL, ATOL, MAX_FLIP_FRAC = 2e-3, 2e-4, 1e-3
# model vs model.  The TXT tokens are compared strictly (integers exactly,
# floats to MODEL_RTOL/ATOL) and reported.  The pass criterion is
# geometric, because a last-bit difference in a confidence can legitimately
# change the model: a support on the `> support_threshold` edge or a
# confidence on the `> confidence_threshold` edge flips, or one of two
# near-tied candidate matches becomes a segment's best match, and the
# clustering carries that into other lines.  Two models agree when their
# line counts differ by at most LINES_REL_TOL and at least ENDPOINT_MIN of
# each model's 3D endpoints lie within ENDPOINT_TOL (relative to the
# model's bounding-box diagonal) of an endpoint of the other.
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-4
LINES_REL_TOL, ENDPOINT_MIN, ENDPOINT_TOL = 0.02, 0.95, 1e-4


def emit(phase, t0, **kw):
    rec = {"phase": phase, "seconds": round(time.perf_counter() - t0, 3)}
    rec.update(kw)
    print(json.dumps(rec, default=lambda o: o.item()
                     if hasattr(o, "item") else str(o)), flush=True)


def median_seconds(fn, n=5):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ------------------------------------------------------------- device
def phase_device(cards):
    t0 = time.perf_counter()
    platform = jax.default_backend()
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX finds no GPU (default backend "
                         f"{platform!r}); nothing was run")
    devs = jax.devices()
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: {cards} cards asked, "
                         f"{len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", t0, platform=devs[0].platform,
         kind=devs[0].device_kind, count=len(devs),
         nvidia_smi=smi.splitlines())
    return devs


# ------------------------------------------------------------- native
def phase_native():
    from line3d_tpu.native import load as native_load
    t0 = time.perf_counter()
    if not native_load.build(force=True):
        raise RuntimeError("native library did not build from its sources")
    lib = native_load.get_lib()
    if lib is None or not hasattr(lib, "lsd_front"):
        raise RuntimeError("native library did not load")
    emit("native", t0, lib=os.path.relpath(native_load._LIB_PATH, HERE))


# ------------------------------------------------------------ kernels
def _memory(compiled):
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(m, k)}


def compare_conf(got, ref):
    """Agreement of two confidence tables [S, M]."""
    d = np.abs(got - ref)
    out = d > ATOL + RTOL * np.abs(ref)
    return dict(max_abs=float(d.max()), frac_out_tol=float(out.mean()),
                n_out_tol=int(out.sum()), n_support=int((ref > 0).sum()))


def scoring_case(name, scene, cams, cfg, quota, m_total, view=None):
    from line3d_tpu.match import scoring, scoring_triton
    t0 = time.perf_counter()
    v, src, nbd, sk, need = demo.view_match_inputs(scene, cams, cfg,
                                                   view=view)
    m_total = m_total or 1 << max(need - 1, 0).bit_length()
    cam, tgt, depths, valid, tco, overflow = demo.match_table(
        src, nbd, quota=quota, m_total=m_total)
    args = (*src, cam, tgt, depths, valid, nbd[5], nbd[0],
            jnp.float32(cfg.sigma_p), jnp.float32(cfg.sigma_a),
            jnp.float32(sk))
    thr = cfg.support_threshold
    kern = jax.jit(lambda *a: scoring_triton.score_matches_triton(
        *a, support_threshold=thr, tcoords=tco))
    twin = jax.jit(lambda *a: scoring.score_matches(
        *a, support_threshold=thr, row_chunk=128, tcoords=tco))
    compiled = kern.lower(*args).compile()
    got = np.asarray(compiled(*args))
    ref = np.asarray(twin(*args))
    agree = compare_conf(got, ref)
    if not (np.isfinite(got).all() and agree["frac_out_tol"]
            <= MAX_FLIP_FRAC):
        raise AssertionError(f"{name}: kernel disagrees with twin {agree}")
    t_kern = median_seconds(lambda: compiled(*args))
    t_twin = median_seconds(lambda: twin(*args))
    occ = np.asarray(valid).sum(axis=1)
    emit("kernels", t0, case=name, view=v, S=int(cam.shape[0]),
         M=int(cam.shape[1]), need=need, row_p50=float(np.median(occ)),
         overflow=int(overflow), kernel_memory=_memory(compiled),
         twin_memory=_memory(twin.lower(*args).compile()),
         tiles=scoring_triton.DEFAULT_TILES,
         kernel_median_s=t_kern, twin_median_s=t_twin,
         speedup=t_twin / t_kern, **agree)


def phase_kernels():
    base = L3DConfig()
    cfg = L3DConfig(stable_shapes=True)
    scene, cams = demo.make_demo_scene(
        num_views=12, num_random_segments=CLUTTER_SEGMENTS, config=base)
    scoring_case("clutter_M256", scene, cams, base,
                 base.match_block_quota, base.max_matches_per_segment,
                 view=0)
    scene, cams = demo.make_facade_scene(num_views=E2E_VIEWS, config=cfg)
    scoring_case("facade_exact", scene, cams, cfg, 128, None)
    scene, cams = demo.make_demo_scene(
        num_views=E2E_VIEWS, num_random_segments=CLUTTER_SEGMENTS,
        config=cfg)
    scoring_case("clutter_exact", scene, cams, cfg, 128, None)


# ---------------------------------------------------------------- e2e
def model_txt(l3d, result):
    """The model as the reference's TXT format."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        l3d.save_3d_lines_as_txt(result, path)
        with open(path) as f:
            return f.read()


def _endpoints(txt):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.txt")
        with open(path, "w") as f:
            f.write(txt)
        lines = writers.load_txt(path)
    pts = [segs.reshape(-1, 3) for segs, _ in lines]
    return len(lines), (np.concatenate(pts) if pts else np.zeros((0, 3)))


def compare_tokens(a, b, rtol=MODEL_RTOL, atol=MODEL_ATOL):
    """Strict TXT comparison: integer tokens exactly, floats to rtol/atol."""
    a, b = a.split(), b.split()
    if len(a) != len(b):
        return False, dict(tokens=(len(a), len(b)))
    n_int, n_float, n_out = 0, 0, 0
    for x, y in zip(a, b):
        try:
            n_int += int(x) != int(y)
        except ValueError:
            n_float += 1
            n_out += abs(float(x) - float(y)) > atol + rtol * abs(float(y))
    return n_int == 0 and n_out == 0, dict(
        tokens=len(a), int_diffs=n_int, float_tokens=n_float,
        floats_out_of_tol=n_out)


def compare_models(a, b):
    """(ok, summary): the geometric criterion above decides; the strict
    token comparison is reported beside it."""
    from scipy.spatial import cKDTree
    tok_ok, tok = compare_tokens(a, b)
    na, pa = _endpoints(a)
    nb, pb = _endpoints(b)
    if not len(pa) or not len(pb):
        return False, dict(lines=(na, nb), tokens=tok)
    tol = ENDPOINT_TOL * float(np.linalg.norm(pb.max(0) - pb.min(0)))
    fa = float((cKDTree(pb).query(pa)[0] <= tol).mean())
    fb = float((cKDTree(pa).query(pb)[0] <= tol).mean())
    ok = (abs(na - nb) <= LINES_REL_TOL * max(na, nb)
          and min(fa, fb) >= ENDPOINT_MIN)
    return ok, dict(lines=(na, nb), endpoints_matched=(fa, fb),
                    endpoint_tol=tol, tokens_identical=tok_ok, tokens=tok)


def run_model(scene, dcams, cfg, jitter=0.0):
    l3d = Line3D(config=cfg)
    for v in range(scene.num_views):
        l3d.add_view_segments(
            v, scene.segments[v][scene.seg_mask[v]] + np.float32(jitter),
            dcams.K[v], dcams.R[v], dcams.t[v],
            worldpoint_ids=scene.wp_lists[v],
            width=int(dcams.width[v]), height=int(dcams.height[v]))
    t0 = time.perf_counter()
    result = l3d.compute_3d_model()
    return time.perf_counter() - t0, l3d, result


def exactness(stats):
    """(views_rematched, residual_overflow) of a finished run."""
    rematched = int(stats.get("views_rematched_uncapped", 0))
    overflow = int(stats.get("match_overflow", 0))
    return rematched, 0 if (rematched > 0 or overflow == 0) else overflow


def phase_e2e(name, scene, dcams):
    cfg = L3DConfig(stable_shapes=True)
    t0 = time.perf_counter()
    cold, l3d, result = run_model(scene, dcams, cfg)
    warm = [run_model(scene, dcams, cfg, 1e-3 * (k + 1))[0]
            for k in range(3)]
    rematched, residual = exactness(l3d.stats)
    if rematched or residual:
        raise AssertionError(f"{name}: not exact (rematched {rematched}, "
                             f"residual overflow {residual})")
    model = model_txt(l3d, result)
    with backend.twins_only():
        t_twin, l3d_t, result_t = run_model(scene, dcams, cfg)
        model_t = model_txt(l3d_t, result_t)
    ok, cmp = compare_models(model, model_t)
    if not ok or not result:
        raise AssertionError(f"{name}: kernel model differs from the twin "
                             f"model: {cmp}")
    st = l3d.stats
    emit(name, t0, views=scene.num_views, lines=len(result),
         cold_s=cold, warm_median_s=float(np.median(warm)), warm_s=warm,
         images_per_s=scene.num_views / float(np.median(warm)),
         views_rematched=rematched, residual_overflow=residual,
         probe_m_total=st.get("probe_m_total"),
         probe_quota=st.get("probe_quota"),
         twin_cold_s=t_twin, model_vs_twin=cmp,
         stages={k: round(v, 4) for k, v in st.items()
                 if k.startswith("t_")})


# ---------------------------------------------------------- detection
def draw_segments(segs, width, height):
    """Dark 2-px anti-aliased strokes on a light background, numpy only."""
    img = np.full((height, width), 235.0, np.float32)
    for x1, y1, x2, y2 in segs:
        n = int(np.hypot(x2 - x1, y2 - y1) * 2) + 2
        t = np.linspace(0.0, 1.0, n)
        px, py = x1 + t * (x2 - x1), y1 + t * (y2 - y1)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                ix = np.clip(np.round(px + dx).astype(int), 0, width - 1)
                iy = np.clip(np.round(py + dy).astype(int), 0, height - 1)
                dist = np.hypot(ix - px, iy - py)
                val = 235.0 - 195.0 * np.clip(1.5 - dist, 0.0, 1.0)
                np.minimum.at(img, (iy, ix), val)
    # 3x3 box blur
    pad = np.pad(img, 1, mode="edge")
    return sum(pad[i:i + height, j:j + width]
               for i in range(3) for j in range(3)) / 9.0


def phase_detection():
    t0 = time.perf_counter()
    cfg = L3DConfig(stable_shapes=True)
    n_cols, n_rows, seed = 8, 6, 0
    scene, dcams = demo.make_facade_scene(num_views=6, config=cfg,
                                          n_cols=n_cols, n_rows=n_rows,
                                          distance=10.0, seed=seed)
    l3d = Line3D(config=cfg)
    td = time.perf_counter()
    for v in range(scene.num_views):
        segs = scene.segments[v][scene.seg_mask[v]]
        img = draw_segments(segs, int(dcams.width[v]), int(dcams.height[v]))
        l3d.add_image(v, img, dcams.K[v], dcams.R[v], dcams.t[v],
                      worldpoint_ids=scene.wp_lists[v])
    t_detect = time.perf_counter() - td
    tm = time.perf_counter()
    result = l3d.compute_3d_model()
    t_model = time.perf_counter() - tm
    if not result:
        raise AssertionError("detection run produced no 3D lines")
    # reconstructed sub-segment endpoints vs the ground-truth 3D lines
    gt = demo.facade_lines(n_cols=n_cols, n_rows=n_rows, seed=seed + 11)
    A, B = gt[:, 0], gt[:, 1]
    pts = np.concatenate([ln.segments3d.reshape(-1, 3) for ln in result])
    if not np.isfinite(pts).all():
        raise AssertionError("non-finite 3D lines")
    AB = B - A
    tt = np.clip(np.einsum("plk,lk->pl", pts[:, None] - A[None], AB)
                 / np.einsum("lk,lk->l", AB, AB), 0.0, 1.0)
    dist = np.linalg.norm(pts[:, None] - (A[None] + tt[..., None] * AB),
                          axis=-1).min(axis=1)
    within = float((dist < 0.05).mean())
    if within < 0.9:
        raise AssertionError(f"only {within:.2f} of the 3D endpoints lie "
                             f"within 0.05 of a ground-truth line")
    emit("detection", t0, views=scene.num_views, image="1920x1440",
         segments=[len(s) for s in l3d._segments], lines=len(result),
         detect_s=t_detect, model_s=t_model,
         endpoints_within_0p05=within,
         median_endpoint_error=float(np.median(dist)))


# ----------------------------------------------------------- backends
def house_model(cfg, noise=0.0, seed=0, poses=None):
    from synthetic import make_scene
    syn = make_scene(num_views=10, noise_px=noise, seed=seed)
    l3d = Line3D(config=cfg)
    for v in range(syn.scene.num_views):
        R, t = (syn.cameras.R[v], syn.cameras.t[v]) if poses is None \
            else (poses[0][v], poses[1][v])
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], R, t, worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    result = l3d.compute_3d_model()
    return syn, l3d, result


def golden_txt(name):
    with open(os.path.join(HERE, "tests", "golden", name)) as f:
        return f.read()


def phase_backends():
    from line3d_tpu.cluster import diffusion
    from line3d_tpu.fit import refine
    t0 = time.perf_counter()
    out = {}
    auto = L3DConfig(use_collinearity=True)
    assert diffusion.resolve_backend(auto) == "device"
    assert refine.resolve_backend(auto) == "device"
    # golden models (generated on the CPU with the host float64 paths)
    for diffu, name, noise, seed in ((False, "house10.txt", 0.0, 0),
                                     (True, "house10_diffusion.txt",
                                      0.8, 3)):
        cfg = L3DConfig(use_collinearity=True, perform_diffusion=diffu)
        _, l3d, res = house_model(cfg, noise, seed)
        ok, cmp = compare_models(model_txt(l3d, res), golden_txt(name))
        if not ok:
            raise AssertionError(f"{name}: GPU model differs: {cmp}")
        out[name] = cmp
    # device diffusion vs the host float64 reference on the same scene
    models = {}
    for be in ("device", "host"):
        cfg = L3DConfig(use_collinearity=True, perform_diffusion=True,
                        diffusion_backend=be)
        _, l3d, res = house_model(cfg, 0.8, 3)
        models[be] = model_txt(l3d, res)
    ok, out["diffusion_device_vs_host"] = compare_models(*models.values())
    if not ok:
        raise AssertionError(f"diffusion: {out['diffusion_device_vs_host']}")
    # line refinement: device float32 vs host float64
    models = {}
    for be in ("device", "host"):
        cfg = L3DConfig(use_collinearity=True, refine_lines=True,
                        refine_backend=be)
        _, l3d, res = house_model(cfg, 0.5, 1)
        models[be] = model_txt(l3d, res)
    ok, out["refine_device_vs_host"] = compare_models(*models.values())
    if not ok:
        raise AssertionError(f"refine: {out['refine_device_vs_host']}")
    # camera BA (device only): perturbed poses must move toward the truth
    from synthetic import make_scene
    syn = make_scene(num_views=10)
    rng = np.random.default_rng(11)
    R_p, t_p = syn.cameras.R.copy(), syn.cameras.t.copy()
    for v in range(1, 10):
        w = rng.normal(0, 0.004, 3)
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R_p[v] = (np.eye(3) + np.sin(th) * Kx
                  + (1 - np.cos(th)) * Kx @ Kx) @ R_p[v]
        t_p[v] = t_p[v] + rng.normal(0, 0.005, 3)
    cfg = L3DConfig(use_collinearity=False, bundle_adjust_cameras=True,
                    bundle_iterations=4)
    _, l3d, res = house_model(cfg, poses=(R_p, t_p))
    rb, ra = l3d.stats["ba_rms_before"], l3d.stats["ba_rms_after"]
    if not (res and rb > 0.01 and ra < rb):
        raise AssertionError(f"camera BA did not converge: {rb} -> {ra}")
    out["camera_ba_rms"] = (rb, ra)
    emit("backends", t0, **out)


# ---------------------------------------------------------- four cards
def phase_cards(cards):
    """Views-sharded matching over a `cards`-device mesh against the same
    call on one device, then the full pipeline (device diffusion, camera
    BA) on all cards against the one-card model."""
    from line3d_tpu.parallel import mesh as mesh_mod, sharded
    from line3d_tpu.match import engine
    t0 = time.perf_counter()
    devs = jax.devices()[:cards]
    cfg = L3DConfig(stable_shapes=True)
    scene, dcams = demo.make_facade_scene(num_views=E2E_VIEWS, config=cfg)
    outs = {}
    for n in (cards, 1):
        l3d = Line3D(config=cfg)
        for v in range(scene.num_views):
            l3d.add_view_segments(
                v, scene.segments[v][scene.seg_mask[v]], dcams.K[v],
                dcams.R[v], dcams.t[v], worldpoint_ids=scene.wp_lists[v],
                width=1920, height=1440)
        l3d._build_scene()
        from line3d_tpu.core.conditioning import compute_conditioning
        from line3d_tpu.scene import find_visual_neighbors
        cams = l3d.cameras
        nbs = find_visual_neighbors(l3d._view_similarities(),
                                    cams.baselines(), cfg.min_baseline,
                                    cfg.matching_neighbors)
        tr = compute_conditioning(cams.C)
        cams.transform(tr.Qinv, tr.scale)
        mesh = mesh_mod.make_view_mesh(devs[:n])
        bufs, ctx = engine.dispatch_matching_sharded(
            l3d.scene, cams, nbs, cfg, mesh=mesh)
        rows = np.concatenate([np.asarray(b) for b in bufs])
        shards = {d.id for b in bufs for d in b.sharding.device_set}
        outs[n] = (rows, shards)
    S = l3d.scene.max_segments
    got = sharded.unpack_view_outputs(outs[cards][0], S, ctx["k_export"])
    ref = sharded.unpack_view_outputs(outs[1][0], S, ctx["k_export"])
    diff = {k: float(np.abs(got[k].astype(np.float64)
                            - ref[k].astype(np.float64)).max())
            for k in ref}
    # identities and counters exactly; confidences / depths to float32
    # rounding (each shard's program is compiled on its own)
    if any(diff[k] for k in ref if ref[k].dtype != np.float32) or \
            max(diff[k] for k in ref if ref[k].dtype == np.float32) > 1e-4:
        raise AssertionError(f"sharded matching differs from one card: "
                             f"{diff}")
    if len(outs[cards][1]) != cards:
        raise AssertionError(f"matching ran on devices {outs[cards][1]}")
    emit("cards_matching", t0, cards=cards, rows=outs[1][0].shape,
         devices=sorted(outs[cards][1]),
         bit_identical=bool(np.array_equal(outs[cards][0].view(np.int32),
                                           outs[1][0].view(np.int32))),
         max_abs_diff_vs_one_card=diff)

    # full pipeline: device diffusion + camera BA over the mesh
    t0 = time.perf_counter()
    full = L3DConfig(stable_shapes=True, perform_diffusion=True,
                     bundle_adjust_cameras=True, bundle_iterations=4)
    models = {}
    orig = mesh_mod.make_view_mesh
    for n in (cards, 1):
        mesh_mod.make_view_mesh = \
            lambda devices=None, axis="views", n=n: orig(
                devices if devices is not None else devs[:n], axis)
        try:
            dt, l3d, res = run_model(scene, dcams, full)
        finally:
            mesh_mod.make_view_mesh = orig
        models[n] = (model_txt(l3d, res), dt, l3d.stats.get("ba_rms_after"))
    ok, cmp = compare_models(models[cards][0], models[1][0])
    if not ok:
        raise AssertionError(f"{cards}-card model differs: {cmp}")
    emit("cards_pipeline", t0, cards=cards, model_vs_one_card=cmp,
         seconds_by_cards={n: m[1] for n, m in models.items()},
         ba_rms_after={n: m[2] for n, m in models.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the multi-card path on this many cards")
    args = ap.parse_args(argv)
    enable_persistent_cache()
    devs = phase_device(args.cards)
    cfg = L3DConfig(stable_shapes=True)
    if args.cards > 1:
        phases = [("cards", lambda: phase_cards(args.cards))]
    else:
        phases = [
            ("native", phase_native),
            ("kernels", phase_kernels),
            ("facade", lambda: phase_e2e("facade", *demo.make_facade_scene(
                num_views=E2E_VIEWS, config=cfg))),
            ("clutter", lambda: phase_e2e("clutter", *demo.make_demo_scene(
                num_views=E2E_VIEWS, num_random_segments=CLUTTER_SEGMENTS,
                config=cfg))),
            ("detection", phase_detection),
            ("backends", phase_backends)]
    # every phase runs (one failure does not hide the next phase's
    # result); any failure exits non-zero without the ok line
    failed = []
    for name, fn in phases:
        try:
            fn()
        except Exception:
            failed.append(name)
            traceback.print_exc()
            print(json.dumps({"phase": name, "failed": True}), flush=True)
    if failed:
        sys.exit(f"chip_smoke: failed phases {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
