"""Derive the useful-math FLOP counts bench.py uses for its stage rates.

The Pallas-Triton scoring kernel is an opaque custom call to XLA's cost
model, so the *useful-math* FLOP counts are taken from the XLA twins
(match/pairwise.match_pair_dense, match/scoring.score_matches — the
kernel's equivalence is tested in tests/test_pallas.py) via
compiled.cost_analysis() on the CPU backend.  bench.py hard-codes the
per-element constants printed here (they are shape-independent ratios);
re-run this script after changing either stage's math.
"""
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np                      # noqa: E402
import jax.numpy as jnp                 # noqa: E402

from line3d_tpu.match import pairwise, scoring   # noqa: E402


def cost(fn, *args):
    comp = jax.jit(fn).lower(*args).compile()
    ca = comp.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("transcendentals", 0.0))


def pair_flops(S=1024, St=1024):
    rng = np.random.RandomState(0)
    a = (jnp.asarray(rng.rand(S, 4), jnp.float32) * 500,
         jnp.asarray(rng.rand(St, 4), jnp.float32) * 500,
         jnp.ones(S, bool), jnp.ones(St, bool),
         jnp.asarray(rng.rand(3, 3), jnp.float32),
         jnp.asarray(np.eye(3), jnp.float32),
         jnp.asarray(np.eye(3), jnp.float32),
         jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32))
    f, t = cost(lambda *x: pairwise.match_pair_dense(*x)[1], *a)
    print(f"pair kernel: S={S} St={St}  flops/pair={f / (S * St):.2f}  "
          f"transcendentals/pair={t / (S * St):.2f}")
    return f / (S * St)


def scoring_flops(S=1024, M=256, N=10, row_chunk=128):
    rng = np.random.RandomState(0)
    segs_src = jnp.asarray(rng.rand(S, 4), jnp.float32) * 500
    mask_src = jnp.ones(S, bool)
    RtKinv = jnp.asarray(np.eye(3), jnp.float32)
    C = jnp.zeros(3, jnp.float32)
    cam = jnp.asarray(rng.randint(0, N, (S, M)), jnp.int32)
    tgt = jnp.asarray(rng.randint(0, S, (S, M)), jnp.int32)
    depths = jnp.asarray(rng.rand(S, M, 4), jnp.float32) + 0.5
    valid = jnp.ones((S, M), bool)
    P_nb = jnp.asarray(rng.rand(N, 3, 4), jnp.float32)
    segs_nb = jnp.asarray(rng.rand(N, S, 4), jnp.float32) * 500

    def fn(*x):
        return scoring.score_matches_best(
            *x, jnp.float32(3.5), jnp.float32(10.0), jnp.float32(0.01),
            row_chunk=row_chunk)

    f, t = cost(fn, segs_src, mask_src, RtKinv, C, cam, tgt, depths, valid,
                P_nb, segs_nb)
    print(f"scoring: S={S} M={M} N={N}  flops/(S*M*M)={f / (S * M * M):.2f} "
          f" transcendentals/(S*M*M)={t / (S * M * M):.2f}")
    return f / (S * M * M)


if __name__ == "__main__":
    pair_flops()
    scoring_flops()
