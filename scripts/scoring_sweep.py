"""Tile sweep of the Pallas-Triton scoring kernel on the GPU.

Times score_matches_triton for each (m tile, m2 tile, num_warps,
num_stages) candidate on real match tables — the 12-view clutter scene's
view 0 at the default capacity M=256, and the views that set the exact
capacities of the 25-view facade (M=1024) and 25 x 2990-segment clutter
(M=2048) scenes — median of 5 warm runs each, one JSON line per point:

    python scripts/scoring_sweep.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax                                             # noqa: E402
import jax.numpy as jnp                                # noqa: E402

from line3d_tpu import L3DConfig                       # noqa: E402
from line3d_tpu.match import scoring_triton           # noqa: E402
from line3d_tpu.utils import demo                      # noqa: E402

TILES = [(64, 8, 4, 1), (32, 8, 4, 1), (128, 8, 4, 1), (64, 4, 4, 1),
         (64, 8, 2, 1), (64, 8, 4, 2), (128, 8, 8, 1), (64, 16, 4, 1),
         (32, 16, 4, 1), (32, 32, 4, 1)]


def cases():
    base = L3DConfig()
    cfg = L3DConfig(stable_shapes=True)
    yield ("clutter_M256", base, 8, 256, 0,
           demo.make_demo_scene(num_views=12, num_random_segments=2990,
                                config=base))
    yield ("facade_exact", cfg, 128, None, None,
           demo.make_facade_scene(num_views=25, config=cfg))
    yield ("clutter_exact", cfg, 128, None, None,
           demo.make_demo_scene(num_views=25, num_random_segments=2990,
                                config=cfg))


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit("scoring_sweep: no GPU")
    for name, cfg, quota, m_total, view, (scene, cams) in cases():
        v, src, nbd, sk, need = demo.view_match_inputs(scene, cams, cfg,
                                                       view=view)
        m_total = m_total or 1 << max(need - 1, 0).bit_length()
        cam, tgt, depths, valid, tco, _ = demo.match_table(
            src, nbd, quota=quota, m_total=m_total)
        args = (*src, cam, tgt, depths, valid, nbd[5], nbd[0],
                jnp.float32(cfg.sigma_p), jnp.float32(cfg.sigma_a),
                jnp.float32(sk))
        for tiles in TILES:
            fn = jax.jit(lambda *a, tiles=tiles:
                         scoring_triton.score_matches_triton(
                             *a, tcoords=tco, tiles=tiles))
            jax.block_until_ready(fn(*args))
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*args))
                ts.append(time.perf_counter() - t0)
            print(json.dumps(dict(case=name, M=int(cam.shape[1]),
                                  tiles=tiles,
                                  median_s=float(np.median(ts)))),
                  flush=True)


if __name__ == "__main__":
    main()
