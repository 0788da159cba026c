"""Public pipeline API: the Line3D class.

Mirrors the reference's L3D::Line3D surface (line3D.h:58-102): add_image()
per view, compute_3d_model(), get_result(), save_3d_lines_as_stl/txt(),
num_cameras(), reset() — but with an array-first core: images are reduced to
padded segment tensors immediately, and the five pipeline stages
(compute3Dmodel, line3D.cc:345-374) run as batched XLA programs.
"""
from __future__ import annotations

import os
import time

import numpy as np

from .config import L3DConfig, DEFAULT_CONFIG
from .core.cameras import CameraSet
from .core.conditioning import compute_conditioning, SceneTransform
from .scene import Scene, view_similarities_from_worldpoints, \
    find_visual_neighbors
from .match import engine
from .match.collinearity import collinearity_maps_fast, \
    collinearity_dispatch_chunked, collinearity_finalize_chunked, \
    apply_collinearity_exact_fallback
from .cluster import affinity, fh, diffusion as diffusion_mod
from .fit import lines as fit_lines
from .fit import refine as refine_mod
from .io import writers


class Line3D:
    """Line-based multi-view stereo on an accelerator.

    Typical use (same flow as the reference CLIs, main_bundler.cpp:104-332):

        l3d = Line3D(data_directory, config)
        for i, img in enumerate(images):
            l3d.add_image(i, img, K, R, t, worldpoint_ids)
        l3d.compute_3d_model(perform_diffusion=False)
        result = l3d.get_result()
        l3d.save_3d_lines_as_txt(result, "out.txt")
    """

    def __init__(self, data_directory: str | None = None,
                 config: L3DConfig = DEFAULT_CONFIG, verbose: bool = False,
                 use_sharded_engine: bool = True):
        self.config = config
        self.verbose = verbose
        self.data_directory = data_directory
        self.use_sharded_engine = use_sharded_engine
        if data_directory:
            os.makedirs(data_directory, exist_ok=True)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        self._images = []       # external ids, in add order
        self._K, self._R, self._t = [], [], []
        self._wh = []
        self._segments = []     # per-view [S_v, 4] arrays
        self._wp_lists = []
        self._fixed_sim = None  # optional {ext_id: {ext_id: sim}}
        self.scene: Scene | None = None
        self.cameras: CameraSet | None = None
        self.transform: SceneTransform | None = None
        self.result: list = []
        # original-frame (unconditioned) camera poses refined by the joint
        # bundle adjustment (config.bundle_adjust_cameras): ([V,3,3] R,
        # [V,3] t), or None when BA did not run
        self.refined_poses = None
        self.neighbors = None
        self.stats = {}
        self._warmup_refs = []
        # segment-axis sizes whose device executables are warm in this
        # process (warmed up or already run): scene building prefers the
        # smallest of these that holds the data over a tighter-but-cold
        # bucket — a fresh scene-scale compile (tens of seconds) costs
        # far more than the padding's extra execution time.
        self._ready_buckets: set[int] = set()

    def num_cameras(self) -> int:
        return len(self._images)

    # ------------------------------------------------------------------
    def add_image(self, image_id: int, image, K, R, t,
                  worldpoint_ids=None, max_img_width: int | None = None,
                  load_and_store_segments: bool | None = None):
        """Detect (or load cached) segments for one image and register the
        view (addImage, line3D.cc:95-217).

        `image` may be an HxW(x3) array, or None if segments are supplied via
        `add_view_segments` / the cache.  Returns the number of segments
        registered for the view (the CLI sizes the warmup bucket from the
        first image's count).
        """
        if image_id in self._images:
            raise ValueError(f"image id {image_id} already in use")
        if worldpoint_ids is None and self._fixed_sim is None:
            raise ValueError("unlinked images cannot be added (no worldpoints)")

        cfg = self.config
        max_w = cfg.max_image_width if max_img_width is None else max_img_width
        store = cfg.load_and_store_segments if load_and_store_segments is None \
            else load_and_store_segments

        segs, (w, h), dt = self._segments_for_image(image_id, image,
                                                    max_w, store)
        self.stats["t_detect"] = self.stats.get("t_detect", 0.0) + dt
        self.add_view_segments(image_id, segs, K, R, t, worldpoint_ids,
                               width=w, height=h)
        return int(np.asarray(segs).reshape(-1, 4).shape[0])

    def _segments_for_image(self, image_id: int, image, max_w: int,
                            store: bool):
        """Detect (or load cached) segments for one image.

        Thread-safe (pure numpy/XLA-CPU work + the segment cache, no shared
        pipeline state) — add_images_parallel maps it over a thread pool.
        Returns (segments [N, 4], (width, height), detect_seconds).
        """
        from .detect import detector
        from .io import cache as seg_cache

        cfg = self.config
        img = np.asarray(image() if callable(image) else image)
        h, w = img.shape[:2]

        new_w, new_h = w, h
        if max_w > 0 and max(w, h) > max_w:
            s = max_w / float(max(w, h))
            new_w, new_h = round(w * s), round(h * s)

        segs = None
        cache_file = None
        if self.data_directory:
            path = seg_cache.segment_cache_path(
                self.data_directory, image_id, new_w, new_h,
                cfg.use_collinearity, max_segments=cfg.max_num_segments,
                min_len_factor=cfg.min_line_length_factor)
            if store:
                cache_file = path
                segs = seg_cache.load_segments(cache_file)
            elif os.path.exists(path):
                # mirror the reference: -l off removes a stale cache file
                # so a later cached run cannot resurrect it
                # (line3D.cc:154-158)
                os.remove(path)
        dt = 0.0
        if segs is None:
            t0 = time.time()
            min_len = cfg.min_line_length_factor * np.hypot(h, w)
            segs = detector.detect_line_segments(
                img, new_w, new_h, min_len, cfg.max_num_segments)
            dt = time.time() - t0
            if cache_file:
                seg_cache.save_segments(cache_file, segs)
        return segs, (w, h), dt

    def add_images_parallel(self, items, max_img_width: int | None = None,
                            load_and_store_segments: bool | None = None,
                            workers: int | None = None):
        """Add many images with detection running in a thread pool.

        The reference detects strictly sequentially inside addImage
        (line3D.cc:95-217); detection here is host-side work that releases
        the GIL (numpy / XLA-CPU / the native ctypes back half), so
        per-image parallelism and overlap of image I/O is free.

        Args:
          items: iterable of (image_id, image_or_loader, K, R, t,
            worldpoint_ids); `image_or_loader` may be a zero-arg callable
            returning the image so file loading/undistortion also runs in
            the worker thread.
          workers: thread count (default: os.cpu_count(), capped at 8).

        Views are registered in the given item order regardless of thread
        completion order, so results are deterministic.
        """
        from concurrent.futures import ThreadPoolExecutor

        items = list(items)
        cfg = self.config
        max_w = cfg.max_image_width if max_img_width is None \
            else max_img_width
        store = cfg.load_and_store_segments if load_and_store_segments \
            is None else load_and_store_segments
        for image_id, _img, _K, _R, _t, wp_ids in items:
            if image_id in self._images:
                raise ValueError(f"image id {image_id} already in use")
            if wp_ids is None and self._fixed_sim is None:
                raise ValueError(
                    "unlinked images cannot be added (no worldpoints)")
        if workers is None:
            workers = min(os.cpu_count() or 1, 8)

        # split the cores between image-level threads and the native
        # kernels' OpenMP regions (omp_set_num_threads is per-thread):
        # workers x full-width OMP oversubscribes cores x workers and
        # measured ~15% slower than 1-wide OMP per worker at 4 cores
        from .native import load as native_load
        lib = native_load.get_lib()
        init = None
        if lib is not None and hasattr(lib, "native_set_num_threads"):
            per = max(1, (os.cpu_count() or 1) // max(1, workers))
            init = lambda: lib.native_set_num_threads(per)  # noqa: E731

        t0 = time.time()
        with ThreadPoolExecutor(max_workers=max(1, workers),
                                initializer=init) as ex:
            results = list(ex.map(
                lambda it: self._segments_for_image(it[0], it[1], max_w,
                                                    store), items))
        self.stats["t_detect"] = self.stats.get("t_detect", 0.0) + \
            (time.time() - t0)
        for (image_id, _, K, R, t, wp_ids), (segs, (w, h), _dt) in zip(
                items, results):
            self.add_view_segments(image_id, segs, K, R, t, wp_ids,
                                   width=w, height=h)

    def add_view_segments(self, image_id: int, segments, K, R, t,
                          worldpoint_ids=None, width: int = 0,
                          height: int = 0):
        """Register a view with precomputed 2D segments (detector bypass —
        the reference's `-l` cache plays the same role, line3D.cc:160-168).

        Views with ZERO segments are not registered (the reference returns
        from addImage without creating the view, line3D.cc:188-198) — a
        segmentless camera must not occupy a visual-neighbor slot."""
        if image_id in self._images:
            raise ValueError(f"image id {image_id} already in use")
        if np.asarray(segments).size == 0:
            if self.verbose:
                print(f"[L3D] image {image_id}: no segments — view skipped")
            return
        self._images.append(image_id)
        self._K.append(np.asarray(K, np.float64))
        self._R.append(np.asarray(R, np.float64))
        self._t.append(np.asarray(t, np.float64).reshape(3))
        self._wh.append((width, height))
        self._segments.append(np.asarray(segments, np.float32).reshape(-1, 4))
        self._wp_lists.append(list(worldpoint_ids) if worldpoint_ids is not None
                              else [])

    def warmup_async(self, num_views: int, max_segments: int | None = None):
        """Pre-compile the device programs for a `num_views`-view scene.

        Dispatches the matching and collinearity executables on dummy
        inputs WITHOUT blocking, so their first-execution compile (tens
        of seconds for the scene-scale programs) overlaps with host-side
        work — the CLI calls this right after
        parsing the dataset, before image loading/detection.

        Requires config.stable_shapes (or an explicit `max_segments`) so
        the warmed shapes match the eventual real scene.  Under
        stable_shapes `max_segments` is an *estimate*: it snaps to a shape
        bucket (scene.stable_segment_bucket), and scene building later
        prefers this warmed bucket over a tighter cold one whenever it
        holds the real data — an overshoot therefore reuses the warmed
        executable, while an undershoot only costs the warmup (the bigger
        program compiles at compute time instead).  With no estimate the
        top bucket (the segment cap) is warmed, which any scene can use.
        No-op on repeat calls with the same shapes (jit cache).
        """
        cfg = self.config
        from .scene import pad_to, stable_segment_bucket
        if max_segments is None:
            if not cfg.stable_shapes:
                raise ValueError(
                    "warmup_async needs config.stable_shapes=True (or an "
                    "explicit max_segments) to know the padded shapes")
            max_segments = cfg.max_num_segments
        # same bucketing as Scene.from_ragged so the warmed executable is
        # the one the real scene will use
        if cfg.stable_shapes:
            max_segments = stable_segment_bucket(max_segments, cfg)
        S = pad_to(max_segments, cfg.pad_multiple)
        self._ready_buckets.add(S)
        import jax

        from .parallel import mesh as mesh_mod
        refs = [engine.warmup_matching_sharded(num_views, S, cfg)]
        if cfg.use_collinearity:
            # both device programs are chunk-shaped (scene-size
            # independent), so one chunk's warmup covers every scene;
            # multi-process runs dispatch whole-scene (no chunking), so
            # warm the Vp-shaped program there instead
            mesh = mesh_mod.make_view_mesh()
            chunk = mesh_mod.view_chunk_size(mesh, cfg.view_pad_multiple) \
                if jax.process_count() == 1 else \
                mesh_mod.pad_views_to_mesh(max(num_views, 4), mesh,
                                           multiple=cfg.view_pad_multiple)
            refs.append(collinearity_dispatch_chunked(
                np.zeros((1, S, 4), np.float32), np.zeros((1, S), bool),
                cfg.collinearity_sigma, chunk,
                quota=cfg.collinearity_block_quota,
                pairs_per_seg=cfg.collinearity_pairs_per_seg,
                aff_threshold=cfg.collinearity_aff_threshold))
        self._warmup_refs = refs

    def set_view_similarity(self, image_id: int, sims: dict):
        """Fixed view similarity instead of worldpoints (addImage_fixed_sim /
        setViewSimilarity, line3D.cc:220-342, 1938-1946)."""
        if self._fixed_sim is None:
            self._fixed_sim = {}
        self._fixed_sim[image_id] = {k: v for k, v in sims.items()
                                     if v > 0.01}

    # ------------------------------------------------------------------
    def _build_scene(self):
        V = len(self._images)
        cams = CameraSet(
            K=np.stack(self._K), R=np.stack(self._R), t=np.stack(self._t),
            width=np.array([wh[0] for wh in self._wh]),
            height=np.array([wh[1] for wh in self._wh]),
            uncertainty_lower_px=self.config.uncertainty_lower_px,
            uncertainty_upper_px=self.config.uncertainty_upper_px)
        collin = None
        axis = self._preferred_segment_axis()
        scene = Scene.from_ragged(self._segments, cams,
                                  wp_lists=self._wp_lists, collin=collin,
                                  config=self.config, segment_axis=axis)
        self.scene, self.cameras = scene, cams
        self._ready_buckets.add(scene.max_segments)

    def _preferred_segment_axis(self) -> int | None:
        """Smallest already-warm segment-axis size that holds the data, if
        it beats the scene's natural bucket — reusing a warmed (or
        previously run) executable is cheaper than a fresh scene-scale
        compile even when its shape is a bucket wider."""
        if not self.config.stable_shapes or not self._ready_buckets:
            return None
        from .scene import stable_segment_bucket
        need = max((len(s) for s in self._segments), default=1)
        natural = stable_segment_bucket(need, self.config)
        if natural in self._ready_buckets:
            return None                      # natural choice is warm
        ready = [b for b in self._ready_buckets if b >= need]
        return min(ready) if ready else None

    def _view_similarities(self):
        V = len(self._images)
        if self._fixed_sim is not None:
            ext2int = {e: i for i, e in enumerate(self._images)}
            sim = np.zeros((V, V))
            for e, d in self._fixed_sim.items():
                for e2, s in d.items():
                    if e in ext2int and e2 in ext2int:
                        sim[ext2int[e], ext2int[e2]] = s
            return sim
        sim, _ = view_similarities_from_worldpoints(self._wp_lists, V)
        return sim

    # ------------------------------------------------------------------
    def compute_3d_model(self, perform_diffusion: bool | None = None):
        """Run the five-stage pipeline (compute3Dmodel, line3D.cc:345-374)."""
        cfg = self.config
        diffu = cfg.perform_diffusion if perform_diffusion is None \
            else perform_diffusion
        if len(self._images) < 4:
            raise ValueError("not enough images (need >= 4)")

        t0 = time.time()
        self.refined_poses = None     # never leak a previous run's BA poses
        self._build_scene()
        scene, cams = self.scene, self.cameras

        # collinearity (L3DSegments ctor, segments.h:73-101) is dispatched
        # FIRST — it only needs the padded segments, so the device runs it
        # (and streams its pair list back) while the host still builds
        # neighbors/conditioning/stacks and while the much larger matching
        # program executes.  Dispatch order is execution order on the
        # device, and a program's device->host copy overlaps the next
        # program's execution, so the short program must go first: when
        # collinearity trails the matching program, its exec + transfer
        # sit on the critical path instead of hiding inside match
        # execution.
        import jax

        # one-pass exact matching: with the guard armed, a cheap device
        # probe measures every view's exact gate-passing capacity and the
        # single mainline pass launches at the pow2-bucketed exact
        # capacity — no wasted capped pass + rematch at realistic density
        # (the pre-probe flow re-matched EVERY overflowing view).  The
        # probe must be read back before the matching dispatch, so it is
        # dispatched FIRST (before collinearity) and stage 1+2 host work
        # moves ahead of both dispatches.
        use_probe = (self.use_sharded_engine and cfg.uncapped_fallback
                     and cfg.capacity_probe)
        probe_bufs, prep, decision = None, None, None
        tg0 = time.time()
        if use_probe:
            # stage 1: visual neighbors (line3D.cc:361) — host, cheap
            sim = self._view_similarities()
            self.neighbors = find_visual_neighbors(
                sim, cams.baselines(), cfg.min_baseline,
                cfg.matching_neighbors, cfg.eps, ext_ids=self._images)
            # stage 2: scene conditioning (line3D.cc:364) — host, cheap
            self.transform = compute_conditioning(cams.C)
            cams.transform(self.transform.Qinv, self.transform.scale)
            prep = engine.prepare_sharded_matching(
                scene, cams, self.neighbors, cfg)
            if prep is not None:
                probe_bufs = engine.dispatch_capacity_probe(prep)
        t_graph = time.time() - tg0

        coll_chunks = None
        if self.use_sharded_engine and cfg.use_collinearity:
            from .parallel import mesh as mesh_mod
            mesh = mesh_mod.make_view_mesh()
            Vp = mesh_mod.pad_views_to_mesh(
                scene.num_views, mesh, multiple=cfg.view_pad_multiple)
            chunk = mesh_mod.view_chunk_size(mesh, cfg.view_pad_multiple) \
                if jax.process_count() == 1 else Vp
            coll_chunks = collinearity_dispatch_chunked(
                scene.segments, scene.seg_mask, cfg.collinearity_sigma,
                chunk, num_pad_views=Vp,
                quota=cfg.collinearity_block_quota,
                pairs_per_seg=cfg.collinearity_pairs_per_seg,
                aff_threshold=cfg.collinearity_aff_threshold)

        if not use_probe:
            # stage 1: visual neighbors (line3D.cc:361) — host, cheap
            tg0 = time.time()
            sim = self._view_similarities()
            self.neighbors = find_visual_neighbors(
                sim, cams.baselines(), cfg.min_baseline,
                cfg.matching_neighbors, cfg.eps, ext_ids=self._images)

            # stage 2: scene conditioning (line3D.cc:364) — host, cheap
            self.transform = compute_conditioning(cams.C)
            cams.transform(self.transform.Qinv, self.transform.scale)
            t_graph = time.time() - tg0

        # stage 3+4: matching + verification + greedy selection
        # (line3D.cc:367-370).  Both device programs are in flight before
        # either is read back: JAX dispatch is async and each NEW
        # executable compiles on first execution (tens of seconds), so
        # issuing both up front overlaps those costs instead of paying
        # them serially.  The sharded engine
        # batches the whole scene into one dispatch (and shards it when a
        # mesh is present); the per-view engine is kept for
        # exactness-without-caps runs.
        fine_t = {}
        if self.use_sharded_engine:
            overrides = {}
            if probe_bufs is not None:
                tp0 = time.time()
                need, total, bmax, nbmax = engine.finalize_capacity_probe(
                    probe_bufs)
                fine_t["t_probe_wait"] = time.time() - tp0
                decision = engine.decide_exact_capacities(
                    need, total, bmax, nbmax, cfg, prep["n_max"],
                    prep["S"])
                if decision is not None:
                    overrides = dict(
                        m_total_override=decision["m_total"],
                        quota_override=decision["quota"],
                        k_export_override=decision["k_export"],
                        per_nb_cap_override=decision["per_nb_cap"],
                        # strict-bound export stays device-resident and is
                        # sliced to the actual verified size at readback
                        defer_export=True)
                    if self.verbose:
                        print(f"[L3D] capacity probe: need "
                              f"{decision['need']} -> m_total "
                              f"{decision['m_total']}, block quota "
                              f"{decision['blockmax']} -> "
                              f"{decision['quota']}, per-neighbor "
                              f"{decision['nbmax']} -> "
                              f"{decision['per_nb_cap']}, export "
                              f"{decision['total']} -> "
                              f"{decision['k_export']}")
            # chunked dispatch; each chunk's device->host copy is queued
            # inside and overlaps the next chunk's execution
            td0 = time.time()
            buf, mctx = engine.dispatch_matching_sharded(
                scene, cams, self.neighbors, cfg, prepared=prep,
                **overrides)
            fine_t["t_match_dispatch"] = time.time() - td0
            if cfg.use_collinearity:
                tc0 = time.time()
                scene.collin = collinearity_finalize_chunked(
                    coll_chunks, max_segments=scene.max_segments,
                    num_views=scene.num_views, verbose=self.verbose)
                fine_t["t_coll_finalize"] = time.time() - tc0
            t1 = time.time()
            matches, best, med = engine.finalize_matching_sharded(
                buf, mctx, scene, cams, cfg, verbose=self.verbose,
                timings=fine_t)
            self._warmup_refs = []   # warmed executables now in jit cache
        else:
            if cfg.use_collinearity:
                scene.collin = collinearity_maps_fast(
                    scene.segments, scene.seg_mask, cfg.collinearity_sigma,
                    quota=cfg.collinearity_block_quota,
                    pairs_per_seg=cfg.collinearity_pairs_per_seg,
                    aff_threshold=cfg.collinearity_aff_threshold)
            t1 = time.time()
            matches, best, med = engine.run_matching(
                scene, cams, self.neighbors, cfg, verbose=self.verbose)
            self._warmup_refs = []
        # reference-exactness guard: the match caps can only drop
        # gate-passing matches, so overflow == 0 proves the capped result
        # equals an uncapped run; overflowing views are either re-matched
        # at exact capacity (uncapped_fallback, the default — reference
        # semantics, cudawrapper.cu:923-1007) or warned about
        n_rematched = 0
        overflow_total = sum(vm.overflow for vm in matches)
        if overflow_total:
            if cfg.uncapped_fallback:
                matches, best, med, n_rematched = \
                    engine.apply_uncapped_fallback(
                        matches, best, med, scene, cams, self.neighbors,
                        cfg, verbose=self.verbose,
                        sharded=self.use_sharded_engine)
            else:
                print(f"[L3D] WARNING: match caps dropped "
                      f"{overflow_total} gate-passing matches across "
                      f"{sum(vm.overflow > 0 for vm in matches)} view(s) "
                      f"(uncapped_fallback off — results may differ from "
                      f"the reference; raise max_matches_per_segment / "
                      f"match_block_quota)")
        # reference-exactness guard for collinearity (the reference keeps
        # every pair, segments.h:76-100): re-derive overflowed views'
        # maps from the dense matrix.  Runs after the matching readback so
        # its device work doesn't serialize ahead of the match transfer.
        coll_overflow, n_recollin = 0, 0
        if cfg.use_collinearity and scene.collin is not None:
            coll_overflow = int(getattr(scene.collin, "dropped_total", 0))
            if coll_overflow and cfg.collinearity_exact_fallback:
                scene.collin, n_recollin = apply_collinearity_exact_fallback(
                    scene.collin, scene.segments, scene.seg_mask,
                    cfg.collinearity_sigma,
                    aff_threshold=cfg.collinearity_aff_threshold,
                    verbose=self.verbose)
        t_collin = t1 - t0
        t2 = time.time()

        # stage 5: clustering (line3D.cc:373)
        graph = affinity.build_affinity_graph(
            best, matches, scene.collin, cams, cfg, scene.max_segments,
            verbose=self.verbose)
        t2a = time.time()
        if diffu and graph.num_nodes:
            # device backend: shard the [E]-vector diffusion over the mesh
            # (performDiffusion, line3D.cc:1255-1303 — whose GPU version is
            # capped at ~1000 images by single-device memory,
            # README.txt:144-146; the edge-sharded plan removes that)
            d_mesh = None
            if diffusion_mod.resolve_backend(cfg) == "device":
                from .parallel import mesh as mesh_mod
                d_mesh = mesh_mod.make_view_mesh()
            graph = diffusion_mod.run_diffusion(graph, cfg, self.verbose,
                                                mesh=d_mesh)
        t2b = time.time()
        ba_info = {}
        if graph.num_nodes:
            fh_fn = fh.fh_cluster_parallel \
                if cfg.fh_backend == "parallel" else fh.fh_cluster
            labels = fh_fn(graph.edges_i, graph.edges_j,
                           graph.edges_w, graph.num_nodes, cfg.fh_c)
            t2c = time.time()
            # device refine shards its cluster axis over the views mesh
            # (independent per-cluster Gauss-Newton, zero collectives);
            # the joint camera BA additionally psums its reduced [6V, 6V]
            # camera system over the mesh (Schur reduction, fit/bundle.py)
            do_refine = cfg.refine_lines or cfg.bundle_adjust_cameras
            r_mesh = None
            if do_refine and refine_mod.resolve_backend(cfg) == "device":
                from .parallel import mesh as mesh_mod
                r_mesh = mesh_mod.make_view_mesh()
            self.result = fit_lines.process_clusters(
                graph, labels, best, self.transform, cfg,
                scene.max_segments, verbose=self.verbose,
                refine=do_refine,
                scene_segments=scene.segments, P_cond=cams.P,
                mesh=r_mesh, cameras=cams, out_info=ba_info)
            if "R_cond" in ba_info:
                # un-condition the refined poses: X' = s (R_c X + t_c), so
                # the equivalent original-frame pose of a conditioned
                # camera (R', t') is R_u = R' R_c, t_u = R' t_c + t' / s
                tr = self.transform
                Rp, tp = ba_info["R_cond"], ba_info["t_cond"]
                self.refined_poses = (
                    np.einsum("vij,jk->vik", Rp, tr.R),
                    np.einsum("vij,j->vi", Rp, tr.t) + tp * tr.scale_inv)
        else:
            t2c = t2b
            self.result = []
        t3 = time.time()

        self.stats = dict(
            num_views=scene.num_views,
            num_best=int(best.view.size),
            num_edges=int(len(graph.edges_w)),
            num_lines=len(self.result),
            t_detect=self.stats.get("t_detect", 0.0),
            t_setup=t_collin - t_graph, t_graph=t_graph,
            t_match=t2 - t1, t_cluster=t3 - t2, t_total=t3 - t0,
            # cluster-stage composition (all host except device diffusion)
            t_affinity=t2a - t2, t_diffusion=t2b - t2a,
            t_fh=t2c - t2b, t_fit=t3 - t2c,
            match_overflow=int(overflow_total),
            views_rematched_uncapped=int(n_rematched),
            # one-pass exact launch capacities (0 = defaults were exact
            # or the probe did not run)
            probe_m_total=int(decision["m_total"]) if decision else 0,
            probe_quota=int(decision["quota"]) if decision else 0,
            probe_k_export=int(decision["k_export"]) if decision else 0,
            collinearity_overflow=coll_overflow,
            views_recollin_exact=int(n_recollin))
        # fine-grained match-stage split (sharded engine only): probe
        # readback wait, dispatch, collinearity finalize, row-buffer wait
        # (device exec critical path), export transfer, host decode
        self.stats.update(fine_t)
        if ba_info:
            self.stats["ba_rms_before"] = ba_info.get("ba_rms_before")
            self.stats["ba_rms_after"] = ba_info.get("ba_rms_after")
        if self.verbose:
            print(f"[L3D] {len(self.result)} 3D lines found! "
                  f"(match {t2-t1:.2f}s, cluster {t3-t2:.2f}s)")
        return self.result

    # ------------------------------------------------------------------
    def get_result(self):
        return self.result

    def get_segment_2d(self, view: int, seg: int):
        """Coordinates of a 2D segment (getSegment2D, line3D.cc:2004-2013);
        `view` is the internal dense index."""
        return self.scene.segments[view, seg]

    def save_3d_lines_as_stl(self, result, filename: str):
        writers.save_stl(result, filename)

    def save_3d_lines_as_txt(self, result, filename: str):
        writers.save_txt(result, filename, get_segment_2d=self.get_segment_2d,
                         view_id_map=self._images)
