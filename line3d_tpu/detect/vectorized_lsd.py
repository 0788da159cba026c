"""Vectorized line-segment detection (array-native LSD replacement).

The reference uses a greedy, inherently sequential LSD (seeded region growing
with a running region angle, lsd_opencv.cpp:537-969).  SURVEY.md §7 marks
this as hard part #1: this build re-formulates detection as a data-parallel
pipeline with the same validation statistics:

  1. Gaussian blur + 0.8x downscale (flsd, lsd_opencv.cpp:546-558),
  2. 2x2 gradient field: angle = atan2(gx, -gy), norm threshold
     rho = quant / sin(prec) (ll_angle, lsd_opencv.cpp:636-684),
  3. line-support regions as connected components of the 8-neighbor graph
     where both pixels' gradient angles agree within prec = 22.5 deg — a
     hook + pointer-jumping label propagation instead of greedy growth,
  4. per-region weighted rectangle fit via moment/inertia statistics
     (region2rect/get_theta, lsd_opencv.cpp:788-882) as segment reductions,
  5. density test (refine's gate, lsd_opencv.cpp:887-889) and an a-contrario
     NFA validation with the same binomial-tail statistic
     (nfa, lsd_opencv.cpp:1198-1234) on the host for surviving candidates.

Low-density regions go through the reference's refine / radius-reduce
chain: the native `lsd_carve` (native/fh_cluster.cpp) re-grows failing
components with per-seed tolerance and shrinking radius
(refine/reduce_region_radius, lsd_opencv.cpp:884-969), with a
tolerance-halving ladder as the pure-python fallback — the analogue of
rect_improve's p/2 precision search (lsd_opencv.cpp:995-1008).

The NFA decision is the reference's full rect_improve ladder on
RE-RASTERIZED rect_nfa counts (`_rect_improve_nfa` / `_rect_counts`,
lsd_opencv.cpp:983-1196): every candidate rectangle's lattice pixels are
counted (total + angle-aligned within prec, pi-wrapped exactly as
isAligned), then failing candidates walk the reference's greedy variant
ladder — 5 precision halvings, 5 symmetric width reductions, 5 one-side
reductions per side (midline shift carried into the emitted endpoints),
5 more precision halvings — batched across the candidate set.  The one
deliberate divergence (PARITY.md): pixels are selected by a clean
point-in-rectangle test instead of the reference's scanline quad walk,
whose second-edge step selection compares an x against a y
(lsd_opencv.cpp:1156-1161, an upstream OpenCV bug).  Mutual recall vs
OpenCV's LSD stays pinned at 0.99-1.00 in tests/test_detect.py.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

# LSD constants (lsd_opencv.hpp:158-161, createLineSegmentDetectorPtr)
SCALE = 0.8
SIGMA_SCALE = 0.6
QUANT = 2.0
ANG_TH = 22.5
LOG_EPS = 0.0
DENSITY_TH = 0.7

NOTDEF = -1024.0


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    """cv::GaussianBlur-compatible kernel: size from LSD (flsd,
    lsd_opencv.cpp:550-553): h = ceil(sigma * sqrt(2*3*ln10))."""
    h = int(math.ceil(sigma * math.sqrt(2.0 * 3.0 * math.log(10.0))))
    x = np.arange(-h, h + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resize_taps(in_size: int, out_size: int):
    """Sparse taps reproducing jax.image.resize(method="linear",
    antialias=True) along one axis (triangle kernel scaled by 1/scale,
    normalized, out-of-range samples zeroed — jax/_src/image/scale.py).
    Returns (idx [out, T] int32, w [out, T] f32); equality with
    jax.image.resize is asserted in tests/test_detect.py."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kscale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kscale
    wmat = np.maximum(0.0, 1.0 - x)                     # [in, out]
    tot = wmat.sum(axis=0, keepdims=True)
    wmat = np.where(np.abs(tot) > 1e-4,
                    wmat / np.where(tot != 0, tot, 1), 0)
    ok = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    wmat = np.where(ok[None, :], wmat, 0)
    T = max(1, int((wmat > 0).sum(axis=0).max()))
    idx = np.zeros((out_size, T), np.int32)
    w = np.zeros((out_size, T), np.float32)
    for o in range(out_size):
        nz = np.nonzero(wmat[:, o])[0]
        idx[o, :len(nz)] = nz
        w[o, :len(nz)] = wmat[nz, o]
    return idx, w


def _resize_linear(x: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """jax.image.resize(..., "linear") as per-axis sparse gather-fma —
    ~6x faster than the dense scale_and_translate path on the CPU
    detection device (detection is host-side, detector.py)."""
    iy, wy = _resize_taps(x.shape[0], out_h)
    ix, wx = _resize_taps(x.shape[1], out_w)
    out = None
    for k in range(iy.shape[1]):
        t = jnp.asarray(wy[:, k])[:, None] * x[jnp.asarray(iy[:, k]), :]
        out = t if out is None else out + t
    x = out
    out = None
    for k in range(ix.shape[1]):
        t = jnp.asarray(wx[:, k])[None, :] * x[:, jnp.asarray(ix[:, k])]
        out = t if out is None else out + t
    return out


def _blur_and_scale(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Gaussian blur (sigma = SIGMA_SCALE/SCALE) + bilinear resize to
    (out_h, out_w)."""
    sigma = SIGMA_SCALE / SCALE if SCALE < 1 else SIGMA_SCALE
    k = gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    # separable blur with edge replication (cv2 BORDER_REFLECT101-ish; the
    # boundary treatment only affects a 3px frame), unrolled as shifted
    # fused multiply-adds (XLA CPU's convolve lowering is ~10x slower)
    pad = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    out = None
    for i in range(len(k)):
        t = float(k[i]) * pad[i:i + img.shape[0], :]
        out = t if out is None else out + t
    pad = jnp.pad(out, ((0, 0), (r, r)), mode="edge")
    out = None
    for i in range(len(k)):
        t = float(k[i]) * pad[:, i:i + img.shape[1]]
        out = t if out is None else out + t
    return _resize_linear(out, out_h, out_w)


def _gradient_field(img: jnp.ndarray, rho: float):
    """2x2 scheme of ll_angle (lsd_opencv.cpp:661-684)."""
    H, W = img.shape
    A = img[:-1, :-1]
    B = img[:-1, 1:]
    C = img[1:, :-1]
    D = img[1:, 1:]
    DA = D - A
    BC = B - C
    gx = DA + BC
    gy = DA - BC
    norm = jnp.sqrt((gx * gx + gy * gy) * 0.25)
    angle = jnp.arctan2(gx, -gy)
    defined = norm > rho
    # pad back to full size; last row/col undefined (lsd_opencv.cpp:652-653)
    norm = jnp.pad(norm, ((0, 1), (0, 1)))
    angle = jnp.pad(angle, ((0, 1), (0, 1)), constant_values=NOTDEF)
    defined = jnp.pad(defined, ((0, 1), (0, 1)), constant_values=False)
    angle = jnp.where(defined, angle, NOTDEF)
    return norm, angle, defined


def _angle_ok(a: jnp.ndarray, b: jnp.ndarray, prec: float) -> jnp.ndarray:
    """|a - b| folded into [-pi, pi] <= prec (angle_diff semantics)."""
    d = a - b
    d = jnp.abs(jnp.mod(d + jnp.pi, 2.0 * jnp.pi) - jnp.pi)
    return d <= prec


def _connected_components(angle: jnp.ndarray, defined: jnp.ndarray,
                          prec, rounds: int = 24,
                          jumps: int = 6) -> jnp.ndarray:
    """8-connected components among defined pixels with pairwise angle
    agreement.  `prec` may be a scalar or a per-pixel map (the refinement
    pass uses per-component tolerances).  Returns flat root labels [H, W]
    (undefined -> H*W)."""
    H, W = angle.shape
    BIG = H * W
    idx = (jnp.arange(H)[:, None] * W + jnp.arange(W)[None, :])
    label = jnp.where(defined, idx, BIG).astype(jnp.int32)

    prec_map = jnp.broadcast_to(jnp.asarray(prec, jnp.float32), angle.shape)

    shifts = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
              (0, 1), (1, -1), (1, 0), (1, 1)]

    def hook(lab):
        best = lab
        for dy, dx in shifts:
            nb_lab = _shift_fill(lab, dy, dx, BIG)
            nb_ang = _shift_fill(angle, dy, dx, NOTDEF)
            nb_def = _shift_fill(defined, dy, dx, False)
            nb_prec = _shift_fill(prec_map, dy, dx, 0.0)
            tol = jnp.minimum(prec_map, nb_prec)
            ok = defined & nb_def & _angle_ok(angle, nb_ang, tol)
            best = jnp.minimum(best, jnp.where(ok, nb_lab, BIG))
        return best

    def compress(lab):
        flat = lab.reshape(-1)
        padded = jnp.concatenate([flat, jnp.array([BIG], jnp.int32)])
        for _ in range(jumps):
            padded = padded[jnp.minimum(padded, BIG)]
            # note: padded[BIG] = BIG keeps undefined stable
        return padded[:-1].reshape(lab.shape)

    def cond(state):
        i, lab, changed = state
        return (i < rounds) & changed

    def body(state):
        i, lab, _ = state
        new = compress(jnp.minimum(lab, hook(lab)))
        return i + 1, new, jnp.any(new != lab)

    _, label, _ = jax.lax.while_loop(cond, body,
                                     (jnp.int32(0), label, jnp.bool_(True)))
    return label


def _shift_fill(x: jnp.ndarray, dy: int, dx: int, fill):
    """Shift a 2D array by (dy, dx), filling vacated cells."""
    H, W = x.shape
    out = jnp.full_like(x, fill)
    ys = slice(max(dy, 0), H + min(dy, 0))
    yd = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    xd = slice(max(-dx, 0), W + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


_blur_jit = jax.jit(_blur_and_scale, static_argnums=(1, 2))
_grad_jit = jax.jit(_gradient_field, static_argnums=(1,))


def _front_native(lib, image: np.ndarray, out_h: int, out_w: int,
                  rho: float):
    """Native C++ front (blur + antialiased resize + gradient field) —
    same taps/weights and summation order as the XLA formulation (the
    resize taps come from _resize_taps, whose equality with
    jax.image.resize is pinned in tests); ~6x the XLA CPU front at
    1920x1440 and GIL-free under the image thread pool."""
    H, W = image.shape
    sigma = SIGMA_SCALE / SCALE if SCALE < 1 else SIGMA_SCALE
    k = gaussian_kernel1d(sigma)
    iy, wy = _resize_taps(H, out_h)
    ix, wx = _resize_taps(W, out_w)
    norm = np.empty((out_h, out_w), np.float32)
    angle = np.empty((out_h, out_w), np.float32)
    defined = np.empty((out_h, out_w), np.uint8)
    lib.lsd_front(
        np.ascontiguousarray(image.reshape(-1), np.float32), H, W,
        np.ascontiguousarray(k), len(k),
        np.ascontiguousarray(iy.reshape(-1)),
        np.ascontiguousarray(wy.reshape(-1)), out_h, iy.shape[1],
        np.ascontiguousarray(ix.reshape(-1)),
        np.ascontiguousarray(wx.reshape(-1)), out_w, ix.shape[1],
        float(rho), np.float32(NOTDEF),
        norm.reshape(-1), angle.reshape(-1), defined.reshape(-1))
    return norm, angle, defined.astype(bool)


def _front(image, out_h: int, out_w: int):
    """Blur/scale + gradient field.

    On a GPU the XLA formulation runs on the card (7.2 ms at 1920x1440
    against 12.6 ms for the native C++ front, transfers included; H100,
    PERF.md); on the host the native C++ front when the library is
    available (the XLA CPU front measured 52 ms).  The XLA front is two
    separate jit programs on purpose: fused, XLA CPU duplicates the
    gather-resize chain into every gradient consumer."""
    prec = math.pi * ANG_TH / 180.0
    rho = QUANT / math.sin(prec)

    from ..native import load as native_load
    from ..utils import backend
    lib = native_load.get_lib()
    if not backend.on_gpu() and lib is not None and \
            hasattr(lib, "lsd_front"):
        return _front_native(lib, np.asarray(image, np.float32),
                             out_h, out_w, rho)

    img = _blur_jit(jnp.asarray(image, jnp.float32), out_h, out_w)
    return _grad_jit(img, rho)


@jax.jit
def _cc_and_stats(norm, angle, defined, prec_map):
    """CC + per-component moment statistics.  Returns (stats, flat labels)."""
    label = _connected_components(angle, defined, prec_map)

    H, W = angle.shape
    NB = H * W
    flat_label = label.reshape(-1)
    dflat = defined.reshape(-1)
    w = jnp.where(defined, norm, 0.0).reshape(-1)
    ys = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None],
                          (H, W)).reshape(-1)
    xs = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None, :],
                          (H, W)).reshape(-1)
    ca = jnp.cos(angle).reshape(-1)
    sa = jnp.sin(angle).reshape(-1)

    lab = jnp.minimum(flat_label, NB - 1)
    fields = jnp.stack([
        dflat.astype(jnp.float32), w, w * xs, w * ys,
        w * xs * xs, w * ys * ys, w * xs * ys,
        jnp.where(dflat, ca, 0.0), jnp.where(dflat, sa, 0.0)], axis=1)
    sums = jax.ops.segment_sum(fields, lab, num_segments=NB)  # one pass
    keys = ("count", "sw", "swx", "swy", "swxx", "swyy", "swxy",
            "sca", "ssa")
    stats = {k: sums[:, i] for i, k in enumerate(keys)}
    return stats, flat_label, xs, ys, dflat


@functools.partial(jax.jit, static_argnames=())
def _region_extents(xs, ys, flat_label, defined, cx, cy, dx, dy, nb):
    """Second pass: per-pixel projections onto each component's axis,
    reduced to per-component extents (region2rect, lsd_opencv.cpp:810-826)."""
    NB = nb.shape[0]
    lab = jnp.minimum(flat_label, NB - 1)
    rx = xs - cx[lab]
    ry = ys - cy[lab]
    l = rx * dx[lab] + ry * dy[lab]
    wd = -rx * dy[lab] + ry * dx[lab]
    big = jnp.float32(1e9)
    l_min = jax.ops.segment_min(jnp.where(defined, l, big), lab,
                                num_segments=NB)
    l_max = jax.ops.segment_max(jnp.where(defined, l, -big), lab,
                                num_segments=NB)
    wd_min = jax.ops.segment_min(jnp.where(defined, wd, big), lab,
                                 num_segments=NB)
    wd_max = jax.ops.segment_max(jnp.where(defined, wd, -big), lab,
                                 num_segments=NB)
    return l_min, l_max, wd_min, wd_max


def _rect_counts(angle, defined, theta, prec, cx, cy, dxv, dyv,
                 l0, l1, wc, width, chunk_px=8_000_000):
    """(total, aligned) lattice-pixel counts of each rectangle — the
    re-rasterization at the heart of rect_nfa (lsd_opencv.cpp:1075-1196).

    For every integer pixel inside the rectangle {c + l*d + w*perp :
    l in [l0, l1], |w - wc| <= width/2} the total count increments, and
    the aligned count increments when the pixel's level-line angle is
    within prec of theta (pi-wrapped exactly as isAligned,
    lsd_opencv.cpp:1236-1252).  Vectorized over ALL rectangles at once:
    flat enumeration of the per-rect bounding boxes (chunked to bound
    peak memory), point-in-rect test in the axis frame, bincount
    reduction.  DIVERGENCE (deliberate, PARITY.md): the reference
    rasterizes the quad with a scanline walk whose second-edge step
    selection compares an x against a y (lsd_opencv.cpp:1156-1161, an
    upstream OpenCV bug) — the clean point-in-rect test counts the
    geometrically correct pixel set instead.
    """
    C = len(theta)
    H, W = angle.shape
    total = np.zeros(C, np.int64)
    aligned = np.zeros(C, np.int64)
    if C == 0:
        return total, aligned
    hw = width / 2.0
    ls = np.stack([l0, l0, l1, l1], axis=1)
    ws = np.stack([wc - hw, wc + hw, wc - hw, wc + hw], axis=1)
    cxs = cx[:, None] + ls * dxv[:, None] - ws * dyv[:, None]
    cys = cy[:, None] + ls * dyv[:, None] + ws * dxv[:, None]
    x0 = np.clip(np.floor(cxs.min(1)).astype(np.int64), 0, W - 1)
    x1 = np.clip(np.ceil(cxs.max(1)).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(cys.min(1)).astype(np.int64), 0, H - 1)
    y1 = np.clip(np.ceil(cys.max(1)).astype(np.int64), 0, H - 1)
    nx = np.maximum(x1 - x0 + 1, 0)
    ny = np.maximum(y1 - y0 + 1, 0)
    areas = nx * ny
    ang_flat = angle.reshape(-1)
    def_flat = defined.reshape(-1)
    cum = np.cumsum(areas)
    start = 0
    while start < C:
        base = cum[start - 1] if start else 0
        stop = min(max(int(np.searchsorted(cum, base + chunk_px)) + 1,
                       start + 1), C)
        sl = slice(start, stop)
        a_sl = areas[sl]
        tot_px = int(a_sl.sum())
        if tot_px == 0:
            start = stop
            continue
        cid = np.repeat(np.arange(start, stop), a_sl)
        offs = np.concatenate([[0], np.cumsum(a_sl)[:-1]])
        local = np.arange(tot_px) - np.repeat(offs, a_sl)
        px = x0[cid] + local % np.maximum(nx[cid], 1)
        py = y0[cid] + local // np.maximum(nx[cid], 1)
        rx = px - cx[cid]
        ry = py - cy[cid]
        l = rx * dxv[cid] + ry * dyv[cid]
        w = -rx * dyv[cid] + ry * dxv[cid]
        inside = (l >= l0[cid]) & (l <= l1[cid]) & \
                 (np.abs(w - wc[cid]) <= hw[cid])
        adx = py * W + px
        a = ang_flat[adx]
        d = np.abs(theta[cid] - a)
        d = np.where(d > 1.5 * np.pi, np.abs(d - 2.0 * np.pi), d)
        ok = inside & def_flat[adx] & (d <= prec[cid])
        total[sl] += np.bincount(cid[inside] - start,
                                 minlength=stop - start)
        aligned[sl] += np.bincount(cid[ok] - start, minlength=stop - start)
        start = stop
    return total, aligned


def _rect_improve_nfa(fit, ids, angle, defined, p0, log_nt):
    """NFA decision with the reference's full rect_improve ladder
    (lsd_opencv.cpp:983-1073) on re-rasterized rect_nfa counts: base
    rectangle first, then — only for candidates still failing — five
    precision halvings (p /= 2, prec = p*pi), five symmetric width
    reductions (0.5 px), five reductions of each single side (midline
    shifted 0.25 px), and five more precision halvings; each stage
    starts from the best rectangle so far, improvements are kept
    greedily, and a candidate leaves the ladder as soon as its best
    log NFA clears LOG_EPS.  All stages run batched over the surviving
    candidate set (_rect_counts).

    Returns (log_nfa [len(ids)], wc [len(ids)]) — the best NFA and the
    winning rectangle's perpendicular midline shift (nonzero only when a
    one-side reduction won; the emitted endpoints move with it, exactly
    as the reference's r.x1 += -dy*delta_2 updates do)."""
    C = len(ids)
    if C == 0:
        return np.zeros(0), np.zeros(0)
    f64 = np.float64
    cx = np.asarray(fit["cx"], f64)[ids]
    cy = np.asarray(fit["cy"], f64)[ids]
    dxv = np.asarray(fit["dx"], f64)[ids]
    dyv = np.asarray(fit["dy"], f64)[ids]
    theta = np.arctan2(dyv, dxv)
    l0 = np.asarray(fit["l_min"], f64)[ids]
    l1 = np.asarray(fit["l_max"], f64)[ids]
    width_b = np.maximum(np.asarray(fit["width"], f64)[ids], 1.0)
    wc_b = np.zeros(C, f64)
    p_b = np.full(C, p0, f64)

    def counts_nfa(mask, wc, widthv, pv):
        idx = np.nonzero(mask)[0]
        out = np.full(C, -np.inf)
        if len(idx) == 0:
            return out
        n, k = _rect_counts(angle, defined, theta[idx], np.pi * pv[idx],
                            cx[idx], cy[idx], dxv[idx], dyv[idx],
                            l0[idx], l1[idx], wc[idx], widthv[idx])
        out[idx] = _nfa_log10(n.astype(f64), k.astype(f64), pv[idx],
                              log_nt)
        return out

    nfa_b = counts_nfa(np.ones(C, bool), wc_b, width_b, p_b)
    done = nfa_b > LOG_EPS

    # stage 1: finer precision (lsd_opencv.cpp:994-1006)
    r_p = p_b.copy()
    act0 = ~done
    for _ in range(5):
        if not act0.any():
            break
        r_p = np.where(act0, r_p / 2.0, r_p)
        nfa_new = counts_nfa(act0, wc_b, width_b, r_p)
        better = act0 & (nfa_new > nfa_b)
        nfa_b = np.where(better, nfa_new, nfa_b)
        p_b = np.where(better, r_p, p_b)
    done |= nfa_b > LOG_EPS

    # stage 2: symmetric width reduction (lsd_opencv.cpp:1009-1024)
    act0 = ~done
    r_w = width_b.copy()
    for _ in range(5):
        act = act0 & (r_w - 0.5 >= 0.5)
        if not act.any():
            break
        r_w = np.where(act, r_w - 0.5, r_w)
        nfa_new = counts_nfa(act, wc_b, r_w, p_b)
        better = act & (nfa_new > nfa_b)
        nfa_b = np.where(better, nfa_new, nfa_b)
        width_b = np.where(better, r_w, width_b)
    done |= nfa_b > LOG_EPS

    # stages 3+4: reduce one side, then the other
    # (lsd_opencv.cpp:1027-1070) — midline shifts delta/2 per step
    for sign in (1.0, -1.0):
        act0 = ~done
        r_w = width_b.copy()
        r_wc = wc_b.copy()
        for _ in range(5):
            act = act0 & (r_w - 0.5 >= 0.5)
            if not act.any():
                break
            r_wc = np.where(act, r_wc + sign * 0.25, r_wc)
            r_w = np.where(act, r_w - 0.5, r_w)
            nfa_new = counts_nfa(act, r_wc, r_w, p_b)
            better = act & (nfa_new > nfa_b)
            nfa_b = np.where(better, nfa_new, nfa_b)
            width_b = np.where(better, r_w, width_b)
            wc_b = np.where(better, r_wc, wc_b)
        done |= nfa_b > LOG_EPS

    # stage 5: finer precision again, width-guarded (lsd_opencv.cpp:1073+)
    act0 = ~done & (width_b - 0.5 >= 0.5)
    r_p = p_b.copy()
    for _ in range(5):
        if not act0.any():
            break
        r_p = np.where(act0, r_p / 2.0, r_p)
        nfa_new = counts_nfa(act0, wc_b, width_b, r_p)
        better = act0 & (nfa_new > nfa_b)
        nfa_b = np.where(better, nfa_new, nfa_b)
        p_b = np.where(better, r_p, p_b)
    return nfa_b, wc_b


def _emit_candidates(cands, p, log_nt, angle=None, defined=None):
    """Shared NFA filter + endpoint emission over (fit, ids[, labels])
    entries.  With an angle map, the NFA is the reference's rect_improve
    ladder on re-rasterized rect_nfa counts (_rect_improve_nfa) and the
    emitted endpoints carry the winning rectangle's midline shift;
    without one (unit-test fits), the region-count approximation is
    used."""
    out = []
    for entry in cands:
        fit, ids = entry[0], entry[1]
        if len(ids) == 0:
            continue
        if angle is not None:
            log_nfa, wshift = _rect_improve_nfa(fit, ids, angle, defined,
                                                p, log_nt)
            keep = log_nfa > LOG_EPS
            ids = ids[keep]
            log_nfa = log_nfa[keep]
            ws = wshift[keep]
        else:
            n_pix = np.ceil(fit["length"][ids]) * np.ceil(fit["width"][ids])
            log_nfa = _nfa_log10(n_pix, fit["count"][ids], p, log_nt)
            keep = log_nfa > LOG_EPS
            ids = ids[keep]
            log_nfa = log_nfa[keep]
            ws = np.zeros(len(ids))
        sx = -fit["dy"][ids] * ws          # perp midline shift (stage 3/4)
        sy = fit["dx"][ids] * ws
        x1 = fit["cx"][ids] + fit["l_min"][ids] * fit["dx"][ids] + sx + 0.5
        y1 = fit["cy"][ids] + fit["l_min"][ids] * fit["dy"][ids] + sy + 0.5
        x2 = fit["cx"][ids] + fit["l_max"][ids] * fit["dx"][ids] + sx + 0.5
        y2 = fit["cy"][ids] + fit["l_max"][ids] * fit["dy"][ids] + sy + 0.5
        inv = 1.0 / SCALE
        out.append(np.stack([x1 * inv, y1 * inv, x2 * inv, y2 * inv,
                             log_nfa], axis=1).astype(np.float32))
    if not out:
        return np.zeros((0, 5), np.float32)
    return np.concatenate(out, axis=0)


def _detect_native(lib, norm, angle, defined, prec, p, log_nt,
                   min_reg_size):
    """Host-native detection back half: union-find CC + moments + extents
    in C++.  Low-density pass-1 components are carved by the native
    lsd_carve — the reference's seeded grow / refine / radius-reduce
    chain (lsd_opencv.cpp:576-633, 884-969) restricted to the failing
    pixels, which recovers the clean segments that noise chained into
    one bloated component.  Falls back to the tolerance-halving ladder
    when the library predates lsd_carve."""
    H, W = angle.shape
    tol = np.full((H, W), prec, np.float32)
    fit1, labels = _cc_and_fit_native(lib, norm, angle, defined, tol, prec)
    if fit1 is None:
        return np.zeros((0, 5), np.float32)

    fit1["_img_w"] = W        # enables the width-reduction NFA rescue
    big = fit1["count"] >= min_reg_size
    cands = [(fit1, np.nonzero(big & (fit1["density"] >= DENSITY_TH))[0],
              labels.reshape(-1))]

    fail = big & (fit1["density"] < DENSITY_TH)
    if fail.any() and hasattr(lib, "lsd_carve"):
        fit_c = _carve_native(lib, norm, angle, labels, fail, prec,
                              min_reg_size)
        if fit_c is not None:
            cands.append((fit_c, np.arange(len(fit_c["count"]))))
        return _emit_candidates(cands, p, log_nt, angle=angle,
                                defined=defined)

    cur_fail = fail
    cur_labels = labels
    cur_fit = fit1
    t = prec
    for _ in range(3):
        if not cur_fail.any():
            break
        t = t / 2.0
        lab_ok = cur_labels >= 0
        pix_in = np.zeros((H, W), bool)
        pix_in[lab_ok] = cur_fail[cur_labels[lab_ok]]
        pix_in &= defined
        if pix_in.sum() < min_reg_size:
            break
        fit_k, labels_k = _cc_and_fit_native(
            lib, norm, angle, pix_in, np.full((H, W), t, np.float32), prec)
        if fit_k is None:
            break
        big_k = fit_k["count"] >= min_reg_size
        cands.append((fit_k,
                      np.nonzero(big_k & (fit_k["density"] >= DENSITY_TH))[0]))
        cur_fail = big_k & (fit_k["density"] < DENSITY_TH)
        cur_labels = labels_k
        cur_fit = fit_k

    if cur_fail.any():
        fit_r = _radius_reduce(norm, angle, cur_labels,
                               np.nonzero(cur_fail)[0], cur_fit, prec)
        if fit_r is not None:
            cands.append((fit_r, np.arange(len(fit_r["count"]))))
    return _emit_candidates(cands, p, log_nt, angle=angle,
                            defined=defined)


def _carve_native(lib, norm, angle, labels, fail, prec, min_reg_size):
    """Run the native lsd_carve over the failing components and return a
    fit dict compatible with _emit_candidates (None when nothing was
    recovered)."""
    H, W = angle.shape
    n_fail_pix = int(fail[np.maximum(labels, 0)][labels >= 0].sum())
    max_out = max(n_fail_pix // max(min_reg_size, 1), 16)
    out = np.empty((max_out, 10), np.float64)
    rows = int(lib.lsd_carve(
        np.ascontiguousarray(norm.reshape(-1), np.float32),
        np.ascontiguousarray(angle.reshape(-1), np.float32),
        np.ascontiguousarray(labels.reshape(-1), np.int32),
        np.ascontiguousarray(fail.astype(np.uint8)),
        len(fail), H, W, float(prec), float(DENSITY_TH),
        int(min_reg_size), out, max_out))
    if rows == 0:
        return None
    o = out[:rows]
    length = o[:, 7] - o[:, 6]
    width = np.maximum(o[:, 9] - o[:, 8], 1.0)
    return dict(count=o[:, 0], sw=o[:, 1], cx=o[:, 2], cy=o[:, 3],
                dx=o[:, 4].astype(np.float32),
                dy=o[:, 5].astype(np.float32),
                l_min=o[:, 6], l_max=o[:, 7], length=length, width=width,
                density=o[:, 0] / np.maximum(length * width, 1e-9))


def _radius_reduce(norm, angle, labels, fail_ids, fit, prec):
    """Radius-reduction recovery (reduce_region_radius,
    lsd_opencv.cpp:932-969): a component that still fails the density test
    is shrunk around its highest-gradient pixel — radius to 75% per step —
    and refitted until the kept core is dense enough or degenerates.
    Recovers the short, dense centers of regions bloated by noise pixels.

    `labels` is [H, W] component ids (-1 / out-of-range = no component);
    `fit` the component fit dict the ids index.  Returns a fit dict of the
    recovered components (None when nothing survives)."""
    H, W = norm.shape
    lab_flat = labels.reshape(-1)
    C = len(fit["count"])
    in_fail = np.zeros(C + 1, bool)
    in_fail[fail_ids] = True
    ok_lab = (lab_flat >= 0) & (lab_flat < C)
    sel = np.flatnonzero(ok_lab & in_fail[np.where(ok_lab, lab_flat, C)])
    if len(sel) == 0:
        return None
    comp = lab_flat[sel]
    order = np.argsort(comp, kind="stable")
    sel = sel[order]
    comp = comp[order]
    starts = np.flatnonzero(np.diff(comp, prepend=-1))
    ends = np.append(starts[1:], len(comp))

    px = (sel % W).astype(np.float64)
    py = (sel // W).astype(np.float64)
    pw = norm.reshape(-1)[sel].astype(np.float64)
    pa = angle.reshape(-1)[sel].astype(np.float64)
    pca, psa = np.cos(pa), np.sin(pa)

    rows = []
    for s, e in zip(starts, ends):
        c = comp[s]
        x, y, w = px[s:e], py[s:e], pw[s:e]
        ca, sa = pca[s:e], psa[s:e]
        seed = int(np.argmax(w))
        sx, sy = x[seed], y[seed]
        # region radius: seed to the farther fitted endpoint
        # (lsd_opencv.cpp:936-940)
        ex1 = fit["cx"][c] + fit["l_min"][c] * fit["dx"][c]
        ey1 = fit["cy"][c] + fit["l_min"][c] * fit["dy"][c]
        ex2 = fit["cx"][c] + fit["l_max"][c] * fit["dx"][c]
        ey2 = fit["cy"][c] + fit["l_max"][c] * fit["dy"][c]
        rad_sq = max((sx - ex1) ** 2 + (sy - ey1) ** 2,
                     (sx - ex2) ** 2 + (sy - ey2) ** 2)
        d_sq = (x - sx) ** 2 + (y - sy) ** 2
        while True:
            rad_sq *= 0.5625                     # 0.75^2 per step
            keep = d_sq <= rad_sq
            n = int(keep.sum())
            if n < 2:
                break
            x, y, w = x[keep], y[keep], w[keep]
            ca, sa = ca[keep], sa[keep]
            d_sq = d_sq[keep]
            stats = dict(count=np.array([float(n)]),
                         sw=np.array([w.sum()]),
                         swx=np.array([(w * x).sum()]),
                         swy=np.array([(w * y).sum()]),
                         swxx=np.array([(w * x * x).sum()]),
                         swyy=np.array([(w * y * y).sum()]),
                         swxy=np.array([(w * x * y).sum()]),
                         sca=np.array([ca.sum()]),
                         ssa=np.array([sa.sum()]))
            cnt, sw, cx, cy, dx, dy = _moments_to_rect(stats, prec)
            l = (x - cx[0]) * dx[0] + (y - cy[0]) * dy[0]
            wd = -(x - cx[0]) * dy[0] + (y - cy[0]) * dx[0]
            row = _finalize_fit(stats, cnt, sw, cx, cy, dx, dy,
                                np.array([l.min()]), np.array([l.max()]),
                                np.array([wd.min()]), np.array([wd.max()]))
            if row["density"][0] >= DENSITY_TH:
                rows.append(row)
                break
    if not rows:
        return None
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def _nfa_log10(n: np.ndarray, k: np.ndarray, p: float,
               log_nt: float) -> np.ndarray:
    """-log10 binomial tail - LOG_NT (nfa, lsd_opencv.cpp:1198-1234),
    vectorized on host.

    Exact to f64 rounding: the binomial survival function IS the
    regularized incomplete beta, sum_{i>=k} C(n,i) p^i q^(n-i) =
    I_p(k, n-k+1), evaluated with scipy's betainc wherever it does not
    underflow.  In the deep tail (I_p < 1e-280, i.e. k >> n p) a
    64-term log-sum series takes over — there the term ratio
    r = p (n-i) / ((i+1) q) is far below 1, so the geometric truncation
    error r^64 is below f64 ulp.  This replaces the former
    unconditionally-truncated 64-term series, whose error was unbounded
    at k ~ n p where the tail decays slowly (the reference bounds the
    same series adaptively with a 1e-10 tolerance,
    lsd_opencv.cpp:1198-1234).  Agreement with a full-sum oracle is
    pinned to 1e-6 log10 across the (n, k, p) plane incl. k ~ n p in
    tests/test_detect.py::test_nfa_log10_matches_full_sum_oracle.
    """
    from scipy.special import betainc, gammaln
    n = np.asarray(n, np.float64)
    k = np.asarray(k, np.float64)
    k = np.minimum(k, n)
    p = np.asarray(p, np.float64)
    p_col = p[:, None] if p.ndim else p       # broadcast over the series

    kk = np.maximum(k, 1.0)
    nn = np.maximum(n, kk)
    with np.errstate(divide="ignore", invalid="ignore"):
        tail = betainc(kk, nn - kk + 1.0, p)
    use_beta = tail > 1e-280

    # deep-tail series (only selected where betainc underflows)
    terms = 64
    i = kk[:, None] + np.arange(terms)[None, :]
    valid = i <= nn[:, None]
    i = np.minimum(i, nn[:, None])
    logC = (gammaln(nn[:, None] + 1) - gammaln(i + 1) -
            gammaln(nn[:, None] - i + 1))
    logterm = logC + i * np.log(p_col) + \
        (nn[:, None] - i) * np.log1p(-p_col)
    logterm = np.where(valid, logterm, -np.inf)
    m = logterm.max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logser = m + np.log(np.sum(np.exp(logterm - m[:, None]), axis=1))
        logser = np.where(np.isfinite(m), logser, -np.inf)
        logtail = np.where(use_beta, np.log(np.maximum(tail, 1e-300)),
                           logser)
    res = -logtail / np.log(10.0) - log_nt
    res = np.where(n <= 0, -log_nt, res)
    res = np.where(k <= 0, -log_nt, res)
    exact = -log_nt - n * np.log10(p)
    res = np.where(k >= n, exact, res)
    return res


def _moments_to_rect(stats, prec):
    """Centroid + inertia axis from moment sums (region2rect/get_theta,
    lsd_opencv.cpp:788-882)."""
    count = np.asarray(stats["count"])
    sw = np.asarray(stats["sw"])
    with np.errstate(divide="ignore", invalid="ignore"):
        cx = np.where(sw > 0, np.asarray(stats["swx"]) / sw, 0)
        cy = np.where(sw > 0, np.asarray(stats["swy"]) / sw, 0)
    Ixx = np.asarray(stats["swyy"]) - 2 * cy * np.asarray(stats["swy"]) + \
        cy * cy * sw
    Iyy = np.asarray(stats["swxx"]) - 2 * cx * np.asarray(stats["swx"]) + \
        cx * cx * sw
    Ixy = -(np.asarray(stats["swxy"]) - cx * np.asarray(stats["swy"]) -
            cy * np.asarray(stats["swx"]) + cx * cy * sw)
    lam = 0.5 * (Ixx + Iyy - np.sqrt((Ixx - Iyy) ** 2 + 4.0 * Ixy ** 2))
    theta = np.where(np.abs(Ixx) > np.abs(Iyy),
                     np.arctan2(lam - Ixx, Ixy),
                     np.arctan2(Ixy, lam - Iyy))
    reg_angle = np.arctan2(np.asarray(stats["ssa"]), np.asarray(stats["sca"]))
    d = np.abs(np.mod(theta - reg_angle + np.pi, 2 * np.pi) - np.pi)
    theta = np.where(d > prec, theta + np.pi, theta)
    return count, sw, cx, cy, np.cos(theta), np.sin(theta)


def _finalize_fit(stats, count, sw, cx, cy, dx, dy,
                  l_min, l_max, wd_min, wd_max):
    length = l_max - l_min
    width = np.maximum(wd_max - wd_min, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        density = np.where(length * width > 0, count / (length * width), 0)
    return dict(count=count, sw=sw, cx=cx, cy=cy,
                dx=dx.astype(np.float32), dy=dy.astype(np.float32),
                l_min=l_min, l_max=l_max, length=length, width=width,
                wd_min=wd_min, density=density)


def _fit_components(stats, xs, ys, flat_label, defined, prec):
    """Rectangle fits for every component (jax-extents path)."""
    count, sw, cx, cy, dx, dy = _moments_to_rect(stats, prec)
    nb = count.shape[0]
    l_min, l_max, wd_min, wd_max = [np.asarray(a) for a in _region_extents(
        xs, ys, flat_label, defined,
        jnp.asarray(cx, jnp.float32), jnp.asarray(cy, jnp.float32),
        jnp.asarray(dx, jnp.float32), jnp.asarray(dy, jnp.float32),
        jnp.zeros(nb))]
    return _finalize_fit(stats, count, sw, cx, cy, dx, dy,
                         l_min, l_max, wd_min, wd_max)


def _cc_and_fit_native(lib, norm, angle, defined, tol, prec):
    """Native CC + moments + extents (host C++); returns (fit dict sized
    [C], compact labels int32 [H, W] with -1 undefined)."""
    H, W = angle.shape
    labels = np.empty(H * W, np.int32)
    C = int(lib.grid_cc_compact(
        np.ascontiguousarray(angle.reshape(-1), np.float32),
        np.ascontiguousarray(defined.reshape(-1).astype(np.uint8)),
        np.ascontiguousarray(tol.reshape(-1), np.float32),
        H, W, labels))
    if C == 0:
        return None, labels.reshape(H, W)
    moments = np.zeros((C, 9), np.float64)
    w = np.where(defined, norm, 0.0).astype(np.float32).reshape(-1)
    lib.region_moments(labels, w,
                       np.ascontiguousarray(angle.reshape(-1), np.float32),
                       H, W, moments)
    keys = ("count", "sw", "swx", "swy", "swxx", "swyy", "swxy",
            "sca", "ssa")
    stats = {k: moments[:, i] for i, k in enumerate(keys)}
    count, sw, cx, cy, dx, dy = _moments_to_rect(stats, prec)
    ext = np.empty((C, 4), np.float64)
    ext[:, 0] = np.inf; ext[:, 1] = -np.inf
    ext[:, 2] = np.inf; ext[:, 3] = -np.inf
    lib.region_extents(labels, H, W,
                       np.ascontiguousarray(cx), np.ascontiguousarray(cy),
                       np.ascontiguousarray(dx), np.ascontiguousarray(dy),
                       ext)
    fit = _finalize_fit(stats, count, sw, cx, cy, dx, dy,
                        ext[:, 0], ext[:, 1], ext[:, 2], ext[:, 3])
    return fit, labels.reshape(H, W)


def detect(image_gray: np.ndarray) -> np.ndarray:
    """Run vectorized LSD on a float grayscale image.

    Returns [N, 5] array: (x1, y1, x2, y2, log_nfa) in input pixel coords.

    Two passes: a full CC at prec = 22.5 deg, then a refinement ladder over
    the pixels of low-density components at globally halved tolerances
    (prec/2, prec/4, ...) — the data-parallel analogue of LSD's refine() /
    reduce_region_radius (lsd_opencv.cpp:884-969), which separates
    near-parallel crossing lines that single-linkage merges.
    """
    return _detect_impl(image_gray)


def _detect_impl(image_gray: np.ndarray) -> np.ndarray:
    H, W = image_gray.shape
    out_h = int(math.ceil(H * SCALE))
    out_w = int(math.ceil(W * SCALE))

    prec = math.pi * ANG_TH / 180.0
    p = ANG_TH / 180.0
    log_nt = 5.0 * (math.log10(out_w) + math.log10(out_h)) / 2.0 + \
        math.log10(11.0)
    min_reg_size = int(-log_nt / math.log10(p))

    norm, angle, defined = _front(image_gray, out_h, out_w)

    from ..native import load as native_load
    lib = native_load.get_lib()
    if lib is not None:
        return _detect_native(lib, np.asarray(norm), np.asarray(angle),
                              np.asarray(defined), prec, p, log_nt,
                              min_reg_size)

    stats, flat_label, xs, ys, dflat = _cc_and_stats(
        norm, angle, defined, jnp.float32(prec))
    fit1 = _fit_components(stats, xs, ys, flat_label, dflat, prec)

    big_enough = fit1["count"] >= min_reg_size
    good1 = big_enough & (fit1["density"] >= DENSITY_TH)
    failing = big_enough & (fit1["density"] < DENSITY_TH)

    fit1["_img_w"] = int(np.asarray(angle).shape[1])
    lab1 = np.where(np.asarray(dflat), np.asarray(flat_label), -1)
    cands = [(fit1, np.nonzero(good1)[0], lab1)]

    # tolerance-halving ladder over still-failing components — the
    # data-parallel analogue of LSD's p/2 refinement ladder
    # (rect_improve, lsd_opencv.cpp:983-993): anti-aliased crossings chain
    # different lines through intermediate gradient angles; halving the
    # pairwise gate breaks the chains.
    Hh, Ww = np.asarray(angle).shape
    cur_fail = failing
    cur_label = np.asarray(flat_label)
    cur_fit = fit1
    tol = prec
    for _ in range(3):
        if not cur_fail.any():
            break
        tol = tol / 2.0
        lab_clip = np.minimum(cur_label, Hh * Ww - 1)
        pix_in = cur_fail[lab_clip] & np.asarray(dflat)
        if pix_in.sum() < min_reg_size:
            break
        defined_k = jnp.asarray(pix_in.reshape(Hh, Ww))
        stats_k, flat_label_k, _, _, dflat_k = _cc_and_stats(
            norm, angle, defined_k, jnp.float32(tol))
        fit_k = _fit_components(stats_k, xs, ys, flat_label_k, dflat_k, prec)
        big_k = fit_k["count"] >= min_reg_size
        good_k = big_k & (fit_k["density"] >= DENSITY_TH)
        cands.append((fit_k, np.nonzero(good_k)[0]))
        cur_fail = big_k & (fit_k["density"] < DENSITY_TH)
        cur_label = np.asarray(flat_label_k)
        cur_fit = fit_k

    if cur_fail.any():
        fit_r = _radius_reduce(np.asarray(norm), np.asarray(angle),
                               cur_label.reshape(Hh, Ww),
                               np.nonzero(cur_fail)[0], cur_fit, prec)
        if fit_r is not None:
            cands.append((fit_r, np.arange(len(fit_r["count"]))))

    return _emit_candidates(cands, p, log_nt, angle=np.asarray(angle),
                            defined=np.asarray(defined))
