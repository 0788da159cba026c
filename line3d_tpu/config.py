"""Configuration and default parameters for the line3d_tpu framework.

Mirrors the reference's compile-time defaults (reference: commons.h:42-66 and
cudawrapper.h:35-46) so that a user of the reference finds the same knobs with
the same semantics, exposed as a single dataclass instead of scattered macros.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class L3DConfig:
    """All tunables of the pipeline.

    Every field cites the reference symbol it corresponds to.
    """

    # --- feature detection (commons.h:42-45) ---
    max_image_width: int = 1920          # L3D_DEF_MAX_IMG_WIDTH
    min_line_length_factor: float = 0.005  # L3D_DEF_MIN_LINE_LENGTH_F (x image diagonal)
    max_num_segments: int = 3000         # L3D_DEF_MAX_NUM_SEGMENTS
    load_and_store_segments: bool = True  # L3D_DEF_LOAD_AND_STORE_SEGMENTS

    # --- collinearity (commons.h:48-49) ---
    collinearity_sigma: float = 2.0      # L3D_DEF_COLLINEARITY_S
    use_collinearity: bool = True        # L3D_DEF_COLLINEARITY_FOR_CLUSTERING
    collinearity_aff_threshold: float = 0.50  # L3D_COLLIN_AFF_T_G (cudawrapper.h:44)
    # device->host export cap on collinear pairs per view:
    # max(8192, collinearity_pairs_per_seg * S).  The reference keeps all
    # pairs (sparse map, segments.h:76-100); this cap only bounds the
    # transfer buffer — drops are counted and warned.  Measured usage is
    # ~1 pair/segment on synthetic scenes; the padded buffer dominates the
    # device link at large view counts (~0.2 GB at 1000 views with 8/seg).
    collinearity_pairs_per_seg: int = 4
    # Per-(segment, 128-partner-block) quota during the device-side
    # compaction of the collinearity keep-plane (compact_rows_blockq) —
    # the collinearity analogue of match_block_quota.  Drops are counted
    # and repaired by collinearity_exact_fallback.
    collinearity_block_quota: int = 8
    # Reference-exactness guard for the collinearity export quota/cap,
    # mirroring uncapped_fallback: the reference keeps EVERY collinear pair
    # (sparse map, segments.h:76-100), so a nonzero drop count means the
    # exported pair list differs from the reference's.  With this flag on
    # (default), views whose drop counter is nonzero get their collinearity
    # map re-derived exactly from the dense [S, S] matrix (collinearity is
    # view-local, so the patched maps equal an uncapped run); with it off,
    # drops are only warned about.
    collinearity_exact_fallback: bool = True

    # --- matching (commons.h:52-58, cudawrapper.h:45-46) ---
    matching_neighbors: int = 10         # L3D_DEF_MATCHING_NEIGHBORS
    uncertainty_upper_px: float = 5.0    # L3D_DEF_UNCERTAINTY_UPPER_T
    uncertainty_lower_px: float = 1.0    # L3D_DEF_UNCERTAINTY_LOWER_T
    min_baseline: float = 0.25           # L3D_DEF_MIN_BASELINE_T
    sigma_p: float = 3.5                 # L3D_DEF_SIGMA_P (px)
    sigma_a: float = 10.0                # L3D_DEF_SIGMA_A (deg)
    min_overlap_lower: float = 0.10      # L3D_MIN_OVERLAP_LOWER_T_G
    min_overlap_upper: float = 0.30      # L3D_MIN_OVERLAP_UPPER_T_G

    # --- verification / selection (cudawrapper.cu:1026-1110) ---
    confidence_threshold: float = 1.0    # conf_t
    confidence_norm: float = 2.0         # confidence_norm
    support_threshold: float = 0.5       # per-support gate (cudawrapper.cu:699)

    # --- replicator dynamics diffusion (commons.h:61, cudawrapper.h:35) ---
    perform_diffusion: bool = False      # L3D_DEF_PERFORM_RDD
    diffusion_iterations: int = 10       # L3D_RDD_MAX_ITER
    # "reference" reproduces the lockstep sparse product of
    # K_sparseMat_diffusion_step (cudawrapper.cu:765-829); "true" computes the
    # published replicator-dynamics update P ∘ (P·W) restricted to the pattern.
    diffusion_mode: str = "reference"
    # "host" runs diffusion in numpy/scipy (float64); "device" runs the
    # iterations (either mode: the reference lockstep walk or the true
    # merge-walk sparse product) as one jitted fori_loop on the device
    # (float32, shardable along the edge axis — cluster/diffusion_device.py).
    # "auto" (default) picks "device" on a GPU and "host" otherwise (CPU
    # runs/tests keep the f64 reference path; utils/backend.py).
    diffusion_backend: str = "auto"

    # --- line refinement (additive: line bundle adjustment, no reference
    # equivalent; BASELINE.json north star) ---
    refine_lines: bool = False
    refine_iterations: int = 5
    # "host" = float64 numpy Gauss-Newton (semantic reference);
    # "device" = jit-batched float32 with exact JVP Jacobians
    # (fit/refine.py, the 100k+-cluster scale path); "auto" picks "device"
    # on a GPU, "host" otherwise (same rule as diffusion_backend)
    refine_backend: str = "auto"

    # --- joint camera + line bundle adjustment (additive: the BASELINE
    # north star's Schur-complement reduction across the mesh;
    # fit/bundle.py).
    # Refines camera poses AND cluster lines jointly (intrinsics fixed);
    # the refined poses land in Line3D.refined_poses and the reported
    # lines are snapped to the jointly refined geometry.  Implies the
    # refine stage. ---
    bundle_adjust_cameras: bool = False
    bundle_iterations: int = 5

    # --- clustering (commons.h:64, line3D.cc:1245,1334) ---
    min_affinity: float = 0.25           # L3D_MIN_AFFINITY (direct edges)
    collinear_affinity: float = 0.01     # collinear edge threshold (line3D.cc:1087,1165)
    fh_c: float = 1.0                    # F-H constant c (line3D.cc:1245)
    # "exact" = the reference's serial merge order (native union-find);
    # "parallel" = mutual-minimal round-parallel scale mode (shardable
    # data-parallel rounds; agreement at production density ARI ~0.999,
    # 98.5% identical clusters — cluster/fh.py, PARITY.md)
    fh_backend: str = "exact"
    min_cameras_per_cluster: int = 4     # line3D.cc:1334
    min_cameras_open: int = 3            # sweep threshold (line3D.cc:1585-1591)

    # --- numerics ---
    eps: float = 1e-12                   # L3D_EPS / L3D_EPS_G

    # --- device shape knobs (no reference equivalent) ---
    # Maximum number of raw matches kept per source segment during
    # verification.  The reference keeps an unbounded std::list
    # (cudawrapper.cu:926-944); fixed shapes need a cap.  Overflow is counted
    # and reported so it can be raised.
    max_matches_per_segment: int = 256
    # Per-(source segment, 128-target-block) raw-match quota during
    # per-neighbor compaction (compact_rows_blockq): per-neighbor capacity
    # is (S/128)*quota.  Key-only block compaction avoids a payload-heavy
    # tight row packing; overflow is counted and reported.
    match_block_quota: int = 8
    # Reference-exactness guard for the two caps above.  The reference
    # keeps every raw match (unbounded std::list, cudawrapper.cu:923-1007);
    # the caps can only DROP gate-passing matches, so overflow == 0 implies
    # the capped result is bit-identical to uncapped.  With this flag on
    # (default), views whose overflow counter is nonzero are re-matched at
    # their exact gate-passing capacity (scoring/selection/median are
    # view-local, so the patched result equals a fully uncapped run);
    # with it off, overflow is only warned about — the capped result is
    # the production path at maximum throughput.
    uncapped_fallback: bool = True
    # One-pass exact matching (used when uncapped_fallback is on and the
    # sharded engine runs): a cheap chunked device probe (the pair gates
    # only, ~1/3 of the per-view match step) measures every view's exact
    # gate-passing capacity BEFORE the mainline dispatch, and the single
    # mainline pass launches at the pow2-bucketed exact capacity — so
    # reference-exact results never pay a wasted capped pass + rematch
    # (the round-3 fallback path re-matched EVERY view at realistic
    # density).  The fallback above remains armed as the guard for
    # mispredictions (structurally impossible — the probe runs the same
    # pair kernel on the same inputs — but unconditional exactness must
    # not rest on that argument).  Costs one extra short device program on
    # scenes whose density fits the default caps anyway.
    capacity_probe: bool = True
    # Segment-count padding granularity (the block width of the per-block
    # match compaction).
    pad_multiple: int = 128
    # View-count padding granularity for the batched/sharded engine.
    # Bucketing the padded view axis makes the matching and collinearity
    # programs byte-identical for any scene in the same bucket, so compiled
    # executables (local persistent cache, warmup_async pre-compiles,
    # service-side caches) are reusable across scenes.  Padded views are
    # masked inactive (view_active) and cost only the dead branch of the
    # per-view lax.cond.
    view_pad_multiple: int = 8
    # Shape-stable device programs: snap the segment axis to one of three
    # buckets — the smallest of {cap/4, cap/2, cap} that holds the scene
    # (scene.stable_segment_bucket; cap = max_num_segments) — and pad the
    # neighbor axis to matching_neighbors regardless of the scene's actual
    # counts.  Scenes of similar density then compile the SAME
    # matching/collinearity executables, which (a) lets Line3D.warmup_async
    # pre-compile them concurrently with host-side detection from a rough
    # segment-count estimate (scene building prefers an already-warm bucket
    # over a tighter cold one), and (b) makes executable caching effective
    # across runs, while sparse scenes avoid the full cap^2 pair grids.
    # Still costs execution time proportional to the in-bucket padding
    # (S^2 in the pair stage), so it is off by default for the library and
    # enabled by the CLI.
    stable_shapes: bool = False

    def __post_init__(self):
        # Reference clamps (line3D.cc:24-28)
        lower = max(abs(self.uncertainty_lower_px), 1.0)
        upper = abs(self.uncertainty_upper_px)
        if upper <= lower:
            upper = lower + 1.0
        object.__setattr__(self, "uncertainty_lower_px", lower)
        object.__setattr__(self, "uncertainty_upper_px", upper)


DEFAULT_CONFIG = L3DConfig()
