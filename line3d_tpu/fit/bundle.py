"""Joint camera + line bundle adjustment with Schur-complement reduction.

The north-star capability beyond the reference (BASELINE.json: "final line
bundle adjustment ... distributed via Schur-complement reduction", here
across the device mesh; the reference never touches camera poses — its closest analogue is
the per-cluster line fit of processClusteredSegments, line3D.cc:1306-1368).
`fit/refine.py` refines 4-DoF lines with cameras frozen; this module
refines the SAME residuals jointly over

  * per-cluster line parameters (4 tangent DoF, same parameterization as
    refine.py: base-point offsets in the direction's normal plane +
    direction tangent updates), and
  * per-view camera poses (6 DoF: axis-angle rotation increment applied on
    the left of R, translation increment on t; intrinsics K stay fixed —
    they come from the upstream SfM, as in the reference).

Each residual couples exactly ONE line and ONE camera, so the Gauss-Newton
normal system is arrow-shaped: the line-line block is block-diagonal
([C, 4, 4]), and eliminating it via the Schur complement leaves a reduced
camera system S = H_θθ − Σ_c H_θl,c H_ll,c⁻¹ H_lθ,c of size [6V, 6V] —
the ONLY cross-cluster object in the solve.  On a mesh the cluster axis is
sharded and S/g arrive by `psum` over the shards, every device
solves the same tiny reduced system, and back-substitution for the line
steps is again embarrassingly parallel per shard.  That is exactly the
promised Schur-complement reduction across the mesh: per-shard outer
products in, one [6V, 6V] psum out.

Gauge handling: the first camera's 6 DoF are pinned (update masked to
zero) and Levenberg damping on both blocks absorbs the remaining global
scale freedom.  Steps are accepted per iteration only if the global
reprojection rms improves (same accept-gate style as refine.py).

Float32 on device with exact forward-mode Jacobians (jax.jvp) and HIGHEST
precision on the projection/normal-equation einsums — the same numeric
rules as the refine path (a TF32 or bf16 product is whole pixels of
reprojection error at K ≈ 1500).
"""
from __future__ import annotations

import numpy as np


def _rodrigues_jnp(w):
    """[V, 3] axis-angle -> [V, 3, 3] rotations, series-safe at ||w|| -> 0."""
    import jax
    import jax.numpy as jnp
    th2 = jnp.sum(w * w, axis=-1)                          # [V]
    th = jnp.sqrt(jnp.maximum(th2, 1e-24))
    small = th2 < 1e-12
    # sin(th)/th and (1-cos(th))/th^2 with series fallbacks
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / th2)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    zero = jnp.zeros_like(wx)
    Wx = jnp.stack([
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1)], axis=-2)     # [V, 3, 3]
    I = jnp.eye(3, dtype=w.dtype)[None]
    # geometry matmul: HIGHEST precision (a TF32/bf16 product is
    # whole-pixel reprojection noise per iteration)
    Wx2 = jnp.einsum("vij,vjk->vik", Wx, Wx,
                     precision=jax.lax.Precision.HIGHEST)
    return I + a[:, None, None] * Wx + b[:, None, None] * Wx2


def _bundle_residuals(P0, d, K, R0, t0, theta, vidx, p1, p2, mask):
    """Perpendicular reprojection residuals with camera increments.

    P0, d: [C, 3]; K/R0/t0: [V, 3, 3]/[V, 3, 3]/[V, 3];
    theta: [V, 6] (axis-angle, translation); vidx: [C, M] member view ids;
    p1, p2: [C, M, 2]; mask: [C, M].  Returns ([C, M, 2] residuals, ok).
    Same residual model as refine._residuals_jnp with Pm built from the
    incremented poses: P_v = K_v [exp([ω]×) R0_v | t0_v + τ_v].
    """
    import jax
    import jax.numpy as jnp
    hi = jax.lax.Precision.HIGHEST

    dR = _rodrigues_jnp(theta[:, :3])
    R = jnp.einsum("vij,vjk->vik", dR, R0, precision=hi)
    t = t0 + theta[:, 3:]
    Rt = jnp.concatenate([R, t[..., None]], axis=-1)       # [V, 3, 4]
    P = jnp.einsum("vij,vjk->vik", K, Rt, precision=hi)    # [V, 3, 4]
    Pm = P[jnp.maximum(vidx, 0)]                           # [C, M, 3, 4]

    ones = jnp.ones((P0.shape[0], 1), P0.dtype)
    Xa = jnp.concatenate([P0, ones], axis=1)
    Xb = jnp.concatenate([P0 + d, ones], axis=1)
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


def _bundle_jit(P0, d, K, R0, t0, vidx, p1, p2, mask, iterations: int,
                huber_delta: float, damping: float, axis: str | None):
    """One jitted joint Gauss-Newton solve (optionally inside shard_map
    with the cluster axis sharded on `axis`; [V]-shaped operands are then
    replicated and the reduced camera system arrives by psum)."""
    import math

    import jax
    import jax.numpy as jnp
    hi = jax.lax.Precision.HIGHEST

    C, M = vidx.shape
    V = K.shape[0]
    Q = 6 * V

    def orthobasis(dv):
        ref = jnp.where(jnp.abs(dv[:, 0:1]) < 0.9,
                        jnp.tile(jnp.asarray([1.0, 0, 0], dv.dtype),
                                 (dv.shape[0], 1)),
                        jnp.tile(jnp.asarray([0, 1.0, 0], dv.dtype),
                                 (dv.shape[0], 1)))
        u1 = jnp.cross(dv, ref)
        u1 = u1 / jnp.linalg.norm(u1, axis=1, keepdims=True)
        return u1, jnp.cross(dv, u1)

    # psum the raw count FIRST, clamp once: flooring per shard would add a
    # phantom residual per all-padding shard and make the reported rms
    # mesh-dependent
    n_res_raw = (mask.sum() * 2).astype(P0.dtype)
    if axis:
        n_res_raw = jax.lax.psum(n_res_raw, axis)
    n_res = jnp.maximum(n_res_raw, 1)

    def global_rms(P0_, d_, th_):
        r, _ = _bundle_residuals(P0_, d_, K, R0, t0, th_, vidx, p1, p2,
                                 mask)
        ss = (r ** 2).sum()
        if axis:
            ss = jax.lax.psum(ss, axis)
        return jnp.sqrt(ss / n_res)

    # the first camera's 6 DoF are pinned (gauge); rows/cols of the pinned
    # coordinates are identity in S and zero in g
    pin = jnp.zeros(Q, bool).at[:6].set(True)

    def one_iteration(P0c, dc, Rc_acc, tc_acc, rms_cur):
        """One damped GN step at the current linearization point.
        Rc_acc/tc_acc are the ACCUMULATED camera increments folded into the
        pose so far; theta re-linearizes at zero each iteration.  rms_cur
        is the incumbent state's rms carried through the loop — the accept
        gate and the final report reuse it instead of re-evaluating a full
        residual pass (one pass + cross-shard psum per iteration saved)."""
        u1, u2 = orthobasis(dc)
        R_cur = Rc_acc
        t_cur = tc_acc

        def res_at(xi, th):
            P0p = P0c + xi[:, 0:1] * u1 + xi[:, 1:2] * u2
            dp = dc + xi[:, 2:3] * u1 + xi[:, 3:4] * u2
            dp = dp / jnp.linalg.norm(dp, axis=1, keepdims=True)
            return _bundle_residuals(P0p, dp, K, R_cur, t_cur, th,
                                     vidx, p1, p2, mask)[0]

        zx = jnp.zeros((C, 4), P0.dtype)
        zt = jnp.zeros((V, 6), P0.dtype)
        r0, ok = _bundle_residuals(P0c, dc, K, R_cur, t_cur, zt,
                                   vidx, p1, p2, mask)

        # exact forward-mode Jacobians: 4 line-tangent + 6 camera-tangent
        # jvp passes.  The camera tangent sets coordinate k of EVERY view
        # simultaneously — each residual touches exactly one camera, so
        # the pass yields ∂r/∂θ_{v(m),k} for all members at once.
        Jx = []
        for k in range(4):
            tang = zx.at[:, k].set(1.0)
            _, jc = jax.jvp(lambda x: res_at(x, zt), (zx,), (tang,))
            Jx.append(jc)
        Jx = jnp.stack(Jx, axis=-1)                    # [C, M, 2, 4]
        Jt = []
        for k in range(6):
            tang = zt.at[:, k].set(1.0)
            _, jc = jax.jvp(lambda th: res_at(zx, th), (zt,), (tang,))
            Jt.append(jc)
        Jt = jnp.stack(Jt, axis=-1)                    # [C, M, 2, 6]

        absr = jnp.abs(r0)
        w = jnp.where(absr <= huber_delta, 1.0,
                      jnp.sqrt(huber_delta / jnp.maximum(absr, 1e-12)))
        w = jnp.where(ok[..., None], w, 0.0)

        # flatten member-residual rows: i = (m, endpoint)
        A = (Jx * w[..., None]).reshape(C, 2 * M, 4)
        B = (Jt * w[..., None]).reshape(C, 2 * M, 6)
        rf = (r0 * w).reshape(C, 2 * M)
        vix = jnp.repeat(jnp.maximum(vidx, 0), 2, axis=1)  # [C, 2M]

        H_ll = jnp.einsum("cia,cib->cab", A, A, precision=hi)
        tr_l = jnp.trace(H_ll, axis1=1, axis2=2)
        H_ll = H_ll + damping * jnp.eye(4, dtype=P0.dtype)[None] * \
            jnp.maximum(tr_l, 1.0)[:, None, None]
        Hinv = jnp.linalg.inv(H_ll)                        # [C, 4, 4]
        g_l = jnp.einsum("cia,ci->ca", A, rf, precision=hi)

        # accumulate the reduced camera system in CLUSTER BLOCKS: the
        # [C, 2M, 6V] placed-Jacobian G is the only O(C·V) tensor of the
        # whole solve (at the 173k-cluster / 1000-view north star it would
        # be ~100 GB), so it is materialized per 256-cluster block inside
        # a lax.scan and contracted away immediately — peak extra memory
        # is [CB, 2M, 6V] while every accumulator is [6V, 6V] or smaller.
        # G[c,i,:] = B[c,i,:] at view block v(i), built as a one-hot outer
        # product (a small dense contraction instead of a scatter).
        CB = math.gcd(C, 256)
        nblk = C // CB

        def place(vix_c, B_c):
            onehot = jax.nn.one_hot(vix_c, V, dtype=P0.dtype)
            return (onehot[..., None] * B_c[..., None, :]
                    ).reshape(CB, 2 * M, Q)

        blk = lambda x: x.reshape((nblk, CB) + x.shape[1:])

        def acc_body(carry, inp):
            Htt, Sf, gt, gc = carry
            A_c, B_c, r_c, vix_c, Hinv_c, gl_c = inp
            G = place(vix_c, B_c)
            Zc = jnp.einsum("cia,ciq->caq", A_c, G, precision=hi)
            Htt = Htt + jnp.einsum("ciq,cir->qr", G, G, precision=hi)
            Sf = Sf + jnp.einsum("caq,cab,cbr->qr", Zc, Hinv_c, Zc,
                                 precision=hi)
            gt = gt + jnp.einsum("ciq,ci->q", G, r_c, precision=hi)
            gc = gc + jnp.einsum("caq,cab,cb->q", Zc, Hinv_c, gl_c,
                                 precision=hi)
            return (Htt, Sf, gt, gc), None

        zQQ = jnp.zeros((Q, Q), P0.dtype)
        zQ = jnp.zeros(Q, P0.dtype)
        (Htt, S_fill, g_t, g_corr), _ = jax.lax.scan(
            acc_body, (zQQ, zQQ, zQ, zQ),
            (blk(A), blk(B), blk(rf), blk(vix), blk(Hinv), blk(g_l)))

        S_part = Htt - S_fill
        g_part = g_t - g_corr
        if axis:
            # the Schur-complement reduction across the mesh: every shard's
            # cluster contributions sum into the one global [6V, 6V]
            # camera system; the solve below is replicated
            S_part = jax.lax.psum(S_part, axis)
            g_part = jax.lax.psum(g_part, axis)

        trS = jnp.trace(S_part)
        S = S_part + damping * jnp.maximum(trS, 1.0) * \
            jnp.eye(Q, dtype=P0.dtype)
        # pin the gauge camera: identity rows/cols, zero gradient
        S = jnp.where(pin[:, None] | pin[None, :],
                      jnp.eye(Q, dtype=P0.dtype), S)
        g = jnp.where(pin, 0.0, g_part)

        dtheta = jnp.linalg.solve(S, -g)                   # [Q]
        dtheta = jnp.where(jnp.isfinite(dtheta), dtheta, 0.0)

        # back-substitute the line steps: δx_c = -Hinv (g_l + Z δθ).
        # Z δθ = Aᵀ (G δθ), and G δθ gathers the member's own camera's 6
        # increments — no G materialization needed at all here
        dth_v = dtheta.reshape(V, 6)
        Bdth = jnp.einsum("cik,cik->ci", B,
                          dth_v[vix], precision=hi)       # [C, 2M]
        Zdth = jnp.einsum("cia,ci->ca", A, Bdth, precision=hi)
        dx = -jnp.einsum("cab,cb->ca", Hinv, g_l + Zdth, precision=hi)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)

        P0n = P0c + dx[:, 0:1] * u1 + dx[:, 1:2] * u2
        dn = dc + dx[:, 2:3] * u1 + dx[:, 3:4] * u2
        dn = dn / jnp.linalg.norm(dn, axis=1, keepdims=True)
        thn = dtheta.reshape(V, 6)
        dRn = _rodrigues_jnp(thn[:, :3])
        Rn = jnp.einsum("vij,vjk->vik", dRn, R_cur, precision=hi)
        tn = t_cur + thn[:, 3:]

        # global accept gate: the coupled step stands or falls as a whole
        def rms_at(P0_, d_, R_, t_):
            r, _ = _bundle_residuals(P0_, d_, K, R_, t_, zt, vidx, p1,
                                     p2, mask)
            ss = (r ** 2).sum()
            if axis:
                ss = jax.lax.psum(ss, axis)
            return jnp.sqrt(ss / n_res)

        rms_new = rms_at(P0n, dn, Rn, tn)
        better = rms_new < rms_cur
        return (jnp.where(better, P0n, P0c), jnp.where(better, dn, dc),
                jnp.where(better, Rn, R_cur), jnp.where(better, tn, t_cur),
                jnp.where(better, rms_new, rms_cur))

    zt0 = jnp.zeros((V, 6), P0.dtype)
    rms_before = global_rms(P0, d, zt0)
    state = (P0, d, R0, t0, rms_before)
    for _ in range(iterations):
        state = one_iteration(*state)
    P0f, df, Rf, tf, rms_after = state
    return P0f, df, Rf, tf, rms_before, rms_after


class _LazyBundleJit:
    """jit (and per-mesh shard_map) wrappers created on first use."""

    _plain = None
    _sharded = {}

    def plain(self):
        import jax
        if _LazyBundleJit._plain is None:
            _LazyBundleJit._plain = jax.jit(
                lambda *a, it, hd, dp: _bundle_jit(
                    *a, iterations=it, huber_delta=hd, damping=dp,
                    axis=None),
                static_argnames=("it", "hd", "dp"))
        return _LazyBundleJit._plain

    def sharded(self, mesh):
        import jax
        from jax.sharding import PartitionSpec as P
        key = mesh
        if key not in _LazyBundleJit._sharded:
            axis = mesh.axis_names[0]
            cshard = P(axis)
            repl = P()

            def fn(P0, d, K, R0, t0, vidx, p1, p2, mask, it, hd, dp):
                body = lambda *a: _bundle_jit(  # noqa: E731
                    *a, iterations=it, huber_delta=hd, damping=dp,
                    axis=axis)
                smap = jax.shard_map(
                    body, mesh=mesh,
                    in_specs=(cshard, cshard, repl, repl, repl, cshard,
                              cshard, cshard, cshard),
                    out_specs=(cshard, cshard, repl, repl, repl, repl),
                    check_vma=False)
                return smap(P0, d, K, R0, t0, vidx, p1, p2, mask)

            _LazyBundleJit._sharded[key] = jax.jit(
                fn, static_argnames=("it", "hd", "dp"))
        return _LazyBundleJit._sharded[key]


_jits = _LazyBundleJit()


def bundle_adjust(P0, d, K, R, t, vidx, p1, p2, mask, iterations: int = 5,
                  huber_delta: float = 2.0, damping: float = 1e-4,
                  mesh=None):
    """Jointly refine [C] lines and [V] camera poses (see module docs).

    Args:
      P0, d: [C, 3] initial lines (conditioned space, any float dtype).
      K, R, t: [V, 3, 3] / [V, 3, 3] / [V, 3] conditioned cameras.
      vidx: [C, M] int member view ids (-1 padding); p1/p2: [C, M, 2]
        member 2D endpoints; mask: [C, M] member validity.
      mesh: optional 1-D device mesh — shards the cluster axis; the
        reduced [6V, 6V] camera system is psum'd over it.

    Returns (P0', d', R', t', rms_before, rms_after) — rms are scalars
    over all member residuals.
    """
    import math

    C = len(P0)
    mult = 256
    if mesh is not None:
        # see refine.refine_lines_device: pow2 mesh sizes share a stable
        # bucket; the actual size must also divide the pad (even shards)
        n = mesh.devices.size
        mult = math.lcm(256, 1 << (n - 1).bit_length(), n)
    Cp = max(mult, ((C + mult - 1) // mult) * mult)
    padc = Cp - C

    def pad(x, fill=0.0):
        if padc == 0:
            return np.asarray(x)
        cfg = [(0, padc)] + [(0, 0)] * (np.ndim(x) - 1)
        return np.pad(np.asarray(x), cfg, constant_values=fill)

    d_unit = np.asarray(d, np.float64)
    d_unit = d_unit / np.linalg.norm(d_unit, axis=1, keepdims=True)
    if padc:
        d_unit = np.concatenate([d_unit, np.tile([1.0, 0, 0], (padc, 1))])
    args = (pad(np.asarray(P0, np.float32)),
            d_unit.astype(np.float32),
            np.asarray(K, np.float32), np.asarray(R, np.float32),
            np.asarray(t, np.float32),
            pad(np.asarray(vidx, np.int32), fill=-1).astype(np.int32),
            pad(np.asarray(p1, np.float32)), pad(np.asarray(p2, np.float32)),
            pad(np.asarray(mask, bool), fill=False))
    if mesh is not None:
        from ..parallel.mesh import shard_leading
        from jax.sharding import NamedSharding, PartitionSpec as P
        import jax
        repl = NamedSharding(mesh, P())
        args = tuple(
            shard_leading(mesh, a) if i in (0, 1, 5, 6, 7, 8)
            else jax.device_put(a, repl) for i, a in enumerate(args))
        fn = _jits.sharded(mesh)
    else:
        fn = _jits.plain()

    out = fn(*args, it=int(iterations), hd=float(huber_delta),
             dp=float(damping))
    if mesh is not None:
        import jax
        if jax.process_count() > 1:
            # line outputs are cluster-sharded (partly non-addressable on
            # each host); replicate before materializing
            from ..parallel import multihost
            out = multihost.replicate(mesh, out)
    P0f, df, Rf, tf, rms_b, rms_a = out
    return (np.asarray(P0f[:C], np.float64), np.asarray(df[:C], np.float64),
            np.asarray(Rf, np.float64), np.asarray(tf, np.float64),
            float(rms_b), float(rms_a))


def build_bundle_member_data(member_views, member_segs, scene_segments):
    """Pad per-cluster member lists into the bundle_adjust inputs.

    Returns (vidx [C, M] int32 (-1 pads), p1 [C, M, 2], p2 [C, M, 2],
    mask [C, M])."""
    C = len(member_views)
    M = max((len(v) for v in member_views), default=1)
    vidx = np.full((C, M), -1, np.int32)
    p1 = np.zeros((C, M, 2))
    p2 = np.zeros((C, M, 2))
    mask = np.zeros((C, M), bool)
    for c, (vs, ss) in enumerate(zip(member_views, member_segs)):
        k = len(vs)
        vidx[c, :k] = vs
        coords = scene_segments[vs, ss]
        p1[c, :k] = coords[:, 0:2]
        p2[c, :k] = coords[:, 2:4]
        mask[c, :k] = True
    return vidx, p1, p2, mask
