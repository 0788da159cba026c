"""Batched 3D line refinement (line-bundle-adjustment).

An additive capability beyond the reference (BASELINE.json north star): each
clustered 3D line is refined by minimizing the reprojection error of its
member 2D segments — the perpendicular distances of the member segment
endpoints to the projected 3D line in their own views — with a damped
Gauss-Newton loop, batched over all clusters at once.

Parameterization (4 DoF per line): base point offsets in the plane normal
to the direction (2) + direction tangent updates (2); the line is
(P0 + a u1 + b u2,  normalize(d + c u1 + e u2)) with (u1, u2) an
orthonormal basis of d's normal plane.

Two equivalent backends (refine_lines / refine_lines_device, equivalence-
tested in tests/test_refine.py):
  * host: float64 numpy with a numeric Jacobian — the semantic reference;
    double precision is comfortable for the normal equations.
  * device: jit-batched jax float32 with EXACT forward-mode Jacobians
    (jax.jvp; finite differences are unusable in f32 — (r(x+eps)-r(x))/eps
    at pixel scale loses ~half the mantissa).  The per-cluster Gauss-Newton
    is embarrassingly parallel, so at 100k+ clusters the [C, M] batch maps
    onto the device's vector units and the 4x4 normal solves are trivially
    batched; the
    host stage was the serial bottleneck at the 1000-view scale
    (README host_stage_scaling).
"""
from __future__ import annotations

import functools

import numpy as np


def _orthobasis(d: np.ndarray):
    """[C, 3] unit dirs -> two [C, 3] orthonormal normal-plane vectors."""
    ref = np.where(np.abs(d[:, 0:1]) < 0.9,
                   np.tile([1.0, 0, 0], (len(d), 1)),
                   np.tile([0, 1.0, 0], (len(d), 1)))
    u1 = np.cross(d, ref)
    u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
    u2 = np.cross(d, u1)
    return u1, u2


def _residuals(P0, d, Pm, p1, p2, mask):
    """Perpendicular reprojection residuals.

    P0, d: [C, 3]; Pm: [C, M, 3, 4] member projection matrices;
    p1, p2: [C, M, 2] member 2D endpoints; mask: [C, M].
    Returns [C, M, 2] residuals (distance of each endpoint to the projected
    line) with masked entries zeroed, plus a validity mask.
    """
    Xa = np.concatenate([P0, np.ones((len(P0), 1))], axis=1)       # [C, 4]
    Xb = np.concatenate([P0 + d, np.ones((len(P0), 1))], axis=1)
    xa = np.einsum("cmij,cj->cmi", Pm, Xa)                         # [C, M, 3]
    xb = np.einsum("cmij,cj->cmi", Pm, Xb)
    # projected 2D line through the two image points
    l = np.cross(xa, xb)                                           # [C, M, 3]
    den = np.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    ok = (np.abs(xa[..., 2]) > 1e-12) & (np.abs(xb[..., 2]) > 1e-12) & \
         (den > 1e-12) & mask
    den = np.maximum(den, 1e-12)
    r1 = (l[..., 0] * p1[..., 0] + l[..., 1] * p1[..., 1] + l[..., 2]) / den
    r2 = (l[..., 0] * p2[..., 0] + l[..., 1] * p2[..., 1] + l[..., 2]) / den
    r = np.stack([r1, r2], axis=-1)
    return np.where(ok[..., None], r, 0.0), ok


def refine_lines(P0, d, Pm, p1, p2, mask, iterations: int = 5,
                 huber_delta: float = 2.0, damping: float = 1e-6):
    """Refine [C] lines given padded member data.  Returns (P0', d', rms
    before, rms after)."""
    P0 = np.asarray(P0, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    C = len(P0)
    n_res = np.maximum(mask.sum(axis=1) * 2, 1)

    def rms(P0_, d_):
        r, ok = _residuals(P0_, d_, Pm, p1, p2, mask)
        return np.sqrt((r ** 2).sum(axis=(1, 2)) / n_res)

    rms_before = rms(P0, d)

    eps = 1e-6
    for _ in range(iterations):
        u1, u2 = _orthobasis(d)
        r0, ok = _residuals(P0, d, Pm, p1, p2, mask)

        # numeric Jacobian over the 4 tangent parameters
        J = np.zeros(r0.shape + (4,))
        deltas = [(u1, None), (u2, None), (None, u1), (None, u2)]
        for k, (dp, dd) in enumerate(deltas):
            P0p = P0 + eps * dp if dp is not None else P0
            dpn = d + eps * dd if dd is not None else d
            if dd is not None:
                dpn = dpn / np.linalg.norm(dpn, axis=1, keepdims=True)
            rp, _ = _residuals(P0p, dpn, Pm, p1, p2, mask)
            J[..., k] = (rp - r0) / eps

        # Huber weights
        absr = np.abs(r0)
        w = np.where(absr <= huber_delta, 1.0,
                     np.sqrt(huber_delta / np.maximum(absr, 1e-12)))
        w = np.where(ok[..., None], w, 0.0)

        Jw = J * w[..., None]
        rw = r0 * w
        # normal equations per cluster: [C, 4, 4] and [C, 4]
        Jf = Jw.reshape(C, -1, 4)
        rf = rw.reshape(C, -1)
        H = np.einsum("cik,cil->ckl", Jf, Jf)
        g = np.einsum("cik,ci->ck", Jf, rf)
        H += damping * np.eye(4)[None] * \
            np.maximum(np.trace(H, axis1=1, axis2=2), 1.0)[:, None, None]
        try:
            step = np.linalg.solve(H, -g[..., None])[..., 0]
        except np.linalg.LinAlgError:
            break

        P0_new = P0 + step[:, 0:1] * u1 + step[:, 1:2] * u2
        d_new = d + step[:, 2:3] * u1 + step[:, 3:4] * u2
        d_new /= np.linalg.norm(d_new, axis=1, keepdims=True)

        # accept per cluster only if rms improves (r0 was computed at the
        # current (P0, d), so rms_old comes for free)
        rms_old = np.sqrt((r0 ** 2).sum(axis=(1, 2)) / n_res)
        rms_new = rms(P0_new, d_new)
        better = (rms_new < rms_old)[:, None]
        P0 = np.where(better, P0_new, P0)
        d = np.where(better, d_new, d)

    return P0, d, rms_before, rms(P0, d)


def _residuals_jnp(P0, d, Pm, p1, p2, mask):
    """jax twin of _residuals (same math, f32 device arrays).

    HIGHEST precision on the projection einsums: a lower-precision
    product (TF32 on a GPU, bf16 elsewhere) keeps ~3 decimal digits, and
    with K-scale entries ~1500 that is whole PIXELS of reprojection error —
    the Gauss-Newton steps would be computed from noise (the CPU-mesh
    equivalence test cannot catch this; chip_smoke.py's refinement check
    on the card would)."""
    import jax
    import jax.numpy as jnp
    ones = jnp.ones((P0.shape[0], 1), P0.dtype)
    Xa = jnp.concatenate([P0, ones], axis=1)
    Xb = jnp.concatenate([P0 + d, ones], axis=1)
    hi = jax.lax.Precision.HIGHEST
    xa = jnp.einsum("cmij,cj->cmi", Pm, Xa, precision=hi)
    xb = jnp.einsum("cmij,cj->cmi", Pm, Xb, precision=hi)
    l = jnp.cross(xa, xb)
    den = jnp.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    ok = (jnp.abs(xa[..., 2]) > 1e-12) & (jnp.abs(xb[..., 2]) > 1e-12) & \
         (den > 1e-12) & mask
    den = jnp.maximum(den, 1e-12)
    r1 = (l[..., 0] * p1[..., 0] + l[..., 1] * p1[..., 1] + l[..., 2]) / den
    r2 = (l[..., 0] * p2[..., 0] + l[..., 1] * p2[..., 1] + l[..., 2]) / den
    r = jnp.stack([r1, r2], axis=-1)
    return jnp.where(ok[..., None], r, 0.0), ok


def _refine_lines_jit(P0, d, Pm, p1, p2, mask, iterations: int,
                      huber_delta: float, damping: float):
    import jax
    import jax.numpy as jnp

    def orthobasis(dv):
        ref = jnp.where(jnp.abs(dv[:, 0:1]) < 0.9,
                        jnp.tile(jnp.asarray([1.0, 0, 0], dv.dtype),
                                 (dv.shape[0], 1)),
                        jnp.tile(jnp.asarray([0, 1.0, 0], dv.dtype),
                                 (dv.shape[0], 1)))
        u1 = jnp.cross(dv, ref)
        u1 = u1 / jnp.linalg.norm(u1, axis=1, keepdims=True)
        u2 = jnp.cross(dv, u1)
        return u1, u2

    C = P0.shape[0]
    n_res = jnp.maximum(mask.sum(axis=1) * 2, 1).astype(P0.dtype)

    def rms_of(P0_, d_):
        r, _ = _residuals_jnp(P0_, d_, Pm, p1, p2, mask)
        return jnp.sqrt((r ** 2).sum(axis=(1, 2)) / n_res)

    rms_before = rms_of(P0, d)

    def step(carry, _):
        P0c, dc = carry
        u1, u2 = orthobasis(dc)

        def res_at(params):
            a, b, c, e = (params[:, k] for k in range(4))
            P0p = P0c + a[:, None] * u1 + b[:, None] * u2
            dp = dc + c[:, None] * u1 + e[:, None] * u2
            dp = dp / jnp.linalg.norm(dp, axis=1, keepdims=True)
            return _residuals_jnp(P0p, dp, Pm, p1, p2, mask)[0]

        zero = jnp.zeros((C, 4), P0.dtype)
        r0, ok = _residuals_jnp(P0c, dc, Pm, p1, p2, mask)
        # exact forward-mode Jacobian: 4 jvp passes over the tangent params
        Jcols = []
        for k in range(4):
            tang = jnp.zeros((C, 4), P0.dtype).at[:, k].set(1.0)
            _, jc = jax.jvp(res_at, (zero,), (tang,))
            Jcols.append(jc)
        J = jnp.stack(Jcols, axis=-1)                     # [C, M, 2, 4]

        absr = jnp.abs(r0)
        w = jnp.where(absr <= huber_delta, 1.0,
                      jnp.sqrt(huber_delta / jnp.maximum(absr, 1e-12)))
        w = jnp.where(ok[..., None], w, 0.0)

        Jf = (J * w[..., None]).reshape(C, -1, 4)
        rf = (r0 * w).reshape(C, -1)
        hi = jax.lax.Precision.HIGHEST
        H = jnp.einsum("cik,cil->ckl", Jf, Jf, precision=hi)
        g = jnp.einsum("cik,ci->ck", Jf, rf, precision=hi)
        tr = jnp.trace(H, axis1=1, axis2=2)
        H = H + damping * jnp.eye(4, dtype=P0.dtype)[None] * \
            jnp.maximum(tr, 1.0)[:, None, None]
        stepv = jnp.linalg.solve(H, -g[..., None])[..., 0]
        stepv = jnp.where(jnp.isfinite(stepv), stepv, 0.0)

        P0n = P0c + stepv[:, 0:1] * u1 + stepv[:, 1:2] * u2
        dn = dc + stepv[:, 2:3] * u1 + stepv[:, 3:4] * u2
        dn = dn / jnp.linalg.norm(dn, axis=1, keepdims=True)

        rms_old = jnp.sqrt((r0 ** 2).sum(axis=(1, 2)) / n_res)
        better = (rms_of(P0n, dn) < rms_old)[:, None]
        return (jnp.where(better, P0n, P0c), jnp.where(better, dn, dc)), None

    (P0f, df) = (P0, d)
    for _ in range(iterations):
        (P0f, df), _ = step((P0f, df), None)
    return P0f, df, rms_before, rms_of(P0f, df)


def resolve_backend(config) -> str:
    """Resolve config.refine_backend: "auto" becomes "device" on a GPU
    and "host" otherwise (shared rule, utils.backend)."""
    from ..utils.backend import resolve_auto_backend
    return resolve_auto_backend(getattr(config, "refine_backend", "auto"))


def _make_refine_jit():
    import jax
    return jax.jit(_refine_lines_jit,
                   static_argnames=("iterations", "huber_delta", "damping"))


class _LazyJit:
    """Module-level jit wrapper created on first use (keeps the jax import
    out of module import; one persistent cache across calls — a fresh
    jax.jit(partial(...)) per call would never hit the executable cache)."""

    _fn = None

    def __call__(self, *args, **kw):
        if _LazyJit._fn is None:
            _LazyJit._fn = _make_refine_jit()
        return _LazyJit._fn(*args, **kw)


_refine_jit = _LazyJit()


def refine_lines_device(P0, d, Pm, p1, p2, mask, iterations: int = 5,
                        huber_delta: float = 2.0, damping: float = 1e-6,
                        mesh=None):
    """Device-batched refine_lines (float32, exact JVP Jacobians).

    Same signature/semantics as refine_lines; ~equal optima (both are
    rms-gated Gauss-Newton on the same residuals — equivalence within
    f32/f64 tolerance is pinned in tests/test_refine.py).  Pads the
    cluster axis to a multiple of 256 so repeated calls reuse executables.

    With `mesh` (a 1-D "views" device mesh), the cluster axis is sharded
    over the mesh: each per-cluster Gauss-Newton is independent (no
    cross-cluster term anywhere), so the whole solve partitions with zero
    collectives — the multi-chip path for the 100k+-cluster refinement
    stage that is serial-host in the reference era (BASELINE.md north
    star; the per-cluster loop analogue is processClusteredSegments,
    line3D.cc:1306-1368).  Sharded ≡ unsharded is pinned in
    tests/test_refine.py.
    """
    import math

    import jax
    import jax.numpy as jnp

    C = len(P0)
    mult = 256
    if mesh is not None:
        # pow2-stable buckets (mirroring the view-axis bucketing
        # rationale, engine.dispatch_matching_sharded): power-of-two mesh
        # sizes all share the lcm(256, pow2) bucket.  The actual mesh
        # size must ALSO divide the pad (shard_leading splits the leading
        # axis evenly), so non-pow2 slices (6, 12, ...) fold their own
        # size into the lcm — they get a per-size bucket, which is the
        # price of an odd slice shape, not a crash
        n = mesh.devices.size
        mult = math.lcm(256, 1 << (n - 1).bit_length(), n)
    Cp = max(mult, ((C + mult - 1) // mult) * mult)
    padc = Cp - C

    def pad(x, fill=0.0):
        if padc == 0:
            return x
        cfg = [(0, padc)] + [(0, 0)] * (np.ndim(x) - 1)
        return np.pad(x, cfg, constant_values=fill)

    d_unit = np.asarray(d, np.float64)
    d_unit = d_unit / np.linalg.norm(d_unit, axis=1, keepdims=True)
    if padc:   # padded rows need a unit direction (orthobasis normalizes)
        d_pad = np.concatenate([d_unit, np.tile([1.0, 0, 0], (padc, 1))])
    else:
        d_pad = d_unit
    args = (pad(np.asarray(P0, np.float32)),
            d_pad.astype(np.float32),
            pad(np.asarray(Pm, np.float32)),
            pad(np.asarray(p1, np.float32)),
            pad(np.asarray(p2, np.float32)),
            pad(np.asarray(mask, bool), fill=False))
    if mesh is not None:
        from ..parallel.mesh import shard_leading
        args = tuple(shard_leading(mesh, a) for a in args)

    out = _refine_jit(
        *args, iterations=int(iterations), huber_delta=float(huber_delta),
        damping=float(damping))
    if mesh is not None and jax.process_count() > 1:
        # sharded outputs are partly non-addressable on each host;
        # replicate so every process can materialize them
        from ..parallel import multihost
        out = multihost.replicate(mesh, out)
    P0f, df, rms_b, rms_a = out
    return (np.asarray(P0f[:C], np.float64), np.asarray(df[:C], np.float64),
            np.asarray(rms_b[:C], np.float64),
            np.asarray(rms_a[:C], np.float64))


def build_cluster_member_data(member_views, member_segs, scene_segments,
                              P_f64):
    """Pad per-cluster member (view, seg) lists into [C, M] arrays.

    member_views/member_segs: list of per-cluster int arrays.
    scene_segments: [V, S, 4]; P_f64: [V, 3, 4] projection matrices
    (conditioned space, float64).
    Returns (Pm [C, M, 3, 4], p1 [C, M, 2], p2 [C, M, 2], mask [C, M]).
    """
    C = len(member_views)
    M = max((len(v) for v in member_views), default=1)
    Pm = np.zeros((C, M, 3, 4))
    p1 = np.zeros((C, M, 2))
    p2 = np.zeros((C, M, 2))
    mask = np.zeros((C, M), bool)
    for c, (vs, ss) in enumerate(zip(member_views, member_segs)):
        k = len(vs)
        Pm[c, :k] = P_f64[vs]
        coords = scene_segments[vs, ss]
        p1[c, :k] = coords[:, 0:2]
        p2[c, :k] = coords[:, 2:4]
        mask[c, :k] = True
    return Pm, p1, p2, mask
