"""Pallas-Triton scoring kernel: correctness in interpret mode on the CPU,
its lowering for CUDA, the kernel choice, and the XLA twin it is checked
against.  `gpu`-marked tests compile the kernel for the card and skip
where there is none (chip_smoke.py runs the same checks at full width)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from line3d_tpu.match import scoring, scoring_triton

# the kernel reassociates the projection / acos arithmetic (scoring_triton
# docstrings); per-value agreement with the twin within this bound
RTOL, ATOL = 2e-3, 2e-4


def _fixture(S, M, N=4, St=128, seed=5, occ=0.4, need=None, dead_row=None,
             packed=False):
    rng = np.random.default_rng(seed)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    cam = rng.integers(-1, N, (S, M)).astype(np.int32)
    valid = (rng.uniform(size=(S, M)) < occ) & (cam >= 0)
    if need is not None:
        valid[:, need:] = False
    if dead_row is not None:
        valid[dead_row] = False
    if packed:
        # the merge's layout: valid slots first, camera-major
        for s in range(S):
            k = valid[s].sum()
            cam[s] = -1
            cam[s, :k] = np.sort(rng.integers(0, N, k))
            valid[s] = False
            valid[s, :k] = True
    return (f32(rng.uniform(0, 300, (S, 4))), jnp.ones(S, bool),
            f32(np.eye(3)), f32(rng.normal(size=3)),
            jnp.asarray(cam), jnp.asarray(rng.integers(0, St, (S, M))
                                          .astype(np.int32)),
            f32(rng.uniform(0.5, 3.0, (S, M, 4))), jnp.asarray(valid),
            f32(rng.normal(size=(N, 3, 4))),
            f32(rng.uniform(0, 300, (N, St, 4))),
            # loose sigmas so support values actually flow
            jnp.float32(200.0), jnp.float32(90.0), jnp.float32(3.0))


def _check(args, **kw):
    ref = np.asarray(scoring.score_matches(*args, row_chunk=8))
    got = np.asarray(scoring_triton.score_matches_triton(
        *args, interpret=True, **kw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    return ref, got


@pytest.mark.parametrize("S,M", [(16, 128), (16, 256), (8, 512), (4, 1024),
                                 (8, 200)])
def test_pallas_scoring_matches_xla_interpret(S, M):
    """score_matches_triton (interpret mode) reproduces score_matches at
    every M the engine produces, including one that is no multiple of the
    tiles (padded with invalid slots)."""
    ref, _ = _check(_fixture(S, M))
    assert (ref > 0).sum() > 50


@pytest.mark.parametrize("case", ["dead_row", "need_below_m",
                                  "packed_rows", "tiles_32x32"])
def test_pallas_scoring_tiled_matches_xla_interpret(case):
    """Edge cases of the tiled loop: an all-invalid row (need 0), rows
    whose live bound need < M (the loop stops early), the merge's packed
    camera-major rows (the camera-range predicate skips cameras), and a
    non-default tile shape."""
    S, M = 8, 256
    if case == "dead_row":
        args = _fixture(S, M, dead_row=3)
        ref, got = _check(args)
        assert not got[3].any()
    elif case == "need_below_m":
        ref, got = _check(_fixture(S, M, need=70))
        assert not got[:, 70:].any()
    elif case == "packed_rows":
        ref, got = _check(_fixture(S, M, packed=True, occ=0.5))
    else:
        ref, got = _check(_fixture(S, M), tiles=(32, 32, 4, 1))
    assert (ref > 0).sum() > 10


def test_scoring_kernel_lowers_for_cuda():
    """The Triton route accepts the kernel: cross-lowering for the CUDA
    platform runs the whole Pallas -> Triton IR translation on the CPU."""
    args = _fixture(64, 256, N=10)
    lowered = jax.jit(scoring_triton.score_matches_triton).trace(
        *args).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()


@pytest.mark.parametrize("M,rows", [(256, 128), (1024, 32), (2048, 8),
                                    (200, 128)])
def test_twin_row_chunk_shrinks_with_m(M, rows):
    """The XLA twin halves its row chunk until one [rows, M, M] plane fits
    its budget (it is the on-card reference at the exact capacities)."""
    assert scoring.twin_row_chunk(128, M) == rows
    assert rows * M * M <= scoring._TWIN_PLANE_ELEMS


def test_score_matches_best_runs_twin_on_cpu():
    args = _fixture(8, 128)
    np.testing.assert_array_equal(
        np.asarray(scoring.score_matches_best(*args, row_chunk=8)),
        np.asarray(scoring.score_matches(*args, row_chunk=8)))


@pytest.mark.gpu
def test_scoring_kernel_on_gpu():
    """Compiled for the card (no interpret mode): agrees with the twin."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs this at full width)")
    args = _fixture(64, 512, N=10)
    ref = np.asarray(scoring.score_matches(*args))
    got = np.asarray(scoring_triton.score_matches_triton(*args))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
