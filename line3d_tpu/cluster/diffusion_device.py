"""Device-side replicator-dynamics diffusion.

Device equivalent of the reference RDD GPU kernels
(K_sparseMat_row_normalization cudawrapper.cu:717-762,
K_sparseMat_diffusion_step cudawrapper.cu:765-829, host driver
replicator_dynamics_diffusion cudawrapper.cu:1131-1191): the host builds a
static index plan once (sorted COO layout, lockstep gather bases, transpose
permutation), then all iterations run inside a single jitted
``lax.fori_loop`` — no host round-trip between iterations, unlike the
reference which launches 2 kernels + syncs per iteration.

Formulation notes:
* The reference's "dot product" walks a P-row and a W-column in
  index-locked steps (cudawrapper.cu:786-800); that lockstep walk is
  reproduced here as K accumulation steps of [E]-vector gathers
  (``pv[rowstart[j]+t] * wv[colstart[i]+t]``), K = max node degree, which
  keeps peak memory at O(E) instead of materializing the [E, K] gather
  matrix in HBM.
* The transpose-position scatter (cudawrapper.cu:812-818) is inverted into
  a gather: ``pv' = newv[order_col]`` where ``order_col`` is the
  (col, row)-sorted enumeration of the (row, col)-sorted entries.
* Row normalization is a sorted ``segment_sum`` + gather
  (cudawrapper.cu:736-760).
* Padded entries live in segment ``num_nodes`` with degree 0 so they decay
  to ``eps`` and never touch real entries.

Sharding: all [E]-shaped arrays may be sharded along a 1-D mesh axis.  The
value vector is both gather source and permutation target across shards,
so XLA inserts one all-gather per iteration across the mesh — the O(E) vector,
not the O(E·K) matrix.  Values are float32 on device, matching the
reference kernels (the host path in diffusion.py is float64).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class DiffusionPlan:
    """Static index plan for the lockstep diffusion, padded to E_pad."""
    rw: np.ndarray          # [E_pad] f32 row-sorted values (P's initial W)
    wv_col: np.ndarray      # [E_pad] f32 col-sorted values (W, fixed)
    ri_seg: np.ndarray      # [E_pad] i32 row id; pads -> num_nodes
    rowstart_j: np.ndarray  # [E_pad] i32 row-sorted base of P's row j_e
    colstart_i: np.ndarray  # [E_pad] i32 col-sorted base of W's col i_e
    mindeg: np.ndarray      # [E_pad] i32 min(deg[j_e], deg[i_e]); pads 0
    order_col: np.ndarray   # [E_pad] i32 transpose gather perm; pads self
    ri: np.ndarray          # [E] i64 unpadded row ids, (i, j)-sorted
    rj: np.ndarray          # [E] i64 unpadded col ids
    num_nodes: int
    num_edges: int
    max_degree: int
    # extra arrays for the "true"-mode merge walk (see _diffuse_true_kernel)
    rj_keys: np.ndarray = None   # [E_pad] i32 col id per row-sorted entry
    ci_keys: np.ndarray = None   # [E_pad] i32 row id per col-sorted entry
    deg_i: np.ndarray = None     # [E_pad] i32 deg of row i_e; pads 0
    deg_j: np.ndarray = None     # [E_pad] i32 deg of col j_e; pads 0


def build_plan(edges_i, edges_j, edges_w, num_nodes,
               pad_multiple: int = 1024) -> DiffusionPlan:
    """Precompute the gather plan on host (one-time, O(E log E))."""
    E = len(edges_w)
    order_r = np.lexsort((edges_j, edges_i))
    ri, rj = edges_i[order_r], edges_j[order_r]
    rw = edges_w[order_r].astype(np.float32)
    order_c = np.lexsort((edges_i, edges_j))
    wv_col = edges_w[order_c].astype(np.float32)

    deg = np.bincount(ri, minlength=num_nodes)
    rowstart = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64)
    # pattern is symmetric (both edge directions present), so the col-sorted
    # layout has the same per-column starts
    # rank of each row-sorted entry under the (col, row) key = row-sorted
    # position of its transpose (sparsematrix.cc:120-191 re-sort semantics)
    order_col = np.empty(E, np.int64)
    order_col[:] = np.lexsort((ri, rj))

    E_pad = max(pad_multiple, int(np.ceil(E / pad_multiple)) * pad_multiple)

    def pad(a, fill):
        out = np.full(E_pad, fill, a.dtype)
        out[:E] = a
        return out

    mindeg = np.minimum(deg[rj], deg[ri])
    ci = edges_i[order_c]                 # row id per col-sorted entry
    plan = DiffusionPlan(
        rw=pad(rw, np.float32(0)),
        wv_col=pad(wv_col, np.float32(0)),
        ri_seg=pad(ri.astype(np.int32), np.int32(num_nodes)),
        rowstart_j=pad(rowstart[rj].astype(np.int32), np.int32(0)),
        colstart_i=pad(rowstart[ri].astype(np.int32), np.int32(0)),
        mindeg=pad(mindeg.astype(np.int32), np.int32(0)),
        order_col=np.concatenate(
            [order_col, np.arange(E, E_pad)]).astype(np.int32),
        ri=ri, rj=rj,
        num_nodes=num_nodes, num_edges=E,
        max_degree=int(deg.max()) if E else 0,
        # "true"-mode merge-walk operands: inner-index keys of P's rows
        # (row-sorted layout) and W's columns (col-sorted layout), plus the
        # two walk lengths.  num_nodes is the +inf key for exhausted walks.
        rj_keys=pad(rj.astype(np.int32), np.int32(num_nodes)),
        ci_keys=pad(ci.astype(np.int32), np.int32(num_nodes)),
        deg_i=pad(deg[ri].astype(np.int32), np.int32(0)),
        deg_j=pad(deg[rj].astype(np.int32), np.int32(0)))
    return plan


def _make_row_normalize(ri_seg, num_nodes, eps):
    """Shared row normalization (cudawrapper.cu:736-760, eps clamp
    745-746) — ONE formulation for both device modes so the semantics
    stay locked to the host twins."""
    def row_normalize(pv):
        sums = jax.ops.segment_sum(pv, ri_seg, num_segments=num_nodes + 1,
                                   indices_are_sorted=True)
        sums = jnp.maximum(sums, eps)
        return pv / sums[ri_seg]
    return row_normalize


def _run_iterations(rw, row_normalize, body, iterations, order_col):
    """Shared iteration scaffold: iterations==0 still row-normalizes once
    (matching the host twins' pre-loop normalize), then min-symmetrizes
    (performDiffusion, line3D.cc:1264-1299)."""
    if iterations == 0:
        pv = row_normalize(rw)
    else:
        pv = jax.lax.fori_loop(0, iterations, body, rw)
    return jnp.minimum(pv, pv[order_col])


@partial(jax.jit,
         static_argnames=("num_nodes", "iterations", "max_degree", "eps"))
def _diffuse_kernel(rw, wv_col, ri_seg, rowstart_j, colstart_i, mindeg,
                    order_col, *, num_nodes, iterations, max_degree,
                    eps=1e-12):
    eps = jnp.float32(eps)
    row_normalize = _make_row_normalize(ri_seg, num_nodes, eps)

    def lockstep_dot(pv):
        def tbody(t, dot):
            pP = pv[rowstart_j + t]         # t-th entry of P's row j_e
            wW = wv_col[colstart_i + t]     # t-th entry of W's col i_e
            return dot + jnp.where(t < mindeg, pP * wW, jnp.float32(0))
        return jax.lax.fori_loop(0, max_degree, tbody,
                                 jnp.zeros_like(pv))

    def body(_, pv):
        pv = row_normalize(pv)
        newv = jnp.maximum(pv * lockstep_dot(pv), eps)  # cudawrapper.cu:805
        return newv[order_col]              # write-to-transpose as a gather

    return _run_iterations(rw, row_normalize, body, iterations, order_col)


@partial(jax.jit,
         static_argnames=("num_nodes", "iterations", "max_degree", "eps"))
def _diffuse_true_kernel(rw, wv_col, ri_seg, base_j, base_i,
                         rj_keys, ci_keys, deg_i, deg_j, order_col,
                         *, num_nodes, iterations, max_degree, eps=1e-12):
    """Device "true"-mode RDD: the published update restricted to the
    sparsity pattern (the device twin of diffusion.diffuse_true).

    The reference-mode lockstep walk multiplies the t-th entries of a
    P-row and a W-column regardless of whether their inner indices agree
    (cudawrapper.cu:786-800); the TRUE sparse dot
    ``(P·W)[i,j] = Σ_k P[i,k]·W[k,j]`` over the common inner indices runs
    here as a MERGE WALK: both operand lists are index-sorted (P's row i
    in the row-sorted layout keyed by rj, W's column j in the col-sorted
    layout keyed by ci), so two per-edge cursors advance by key comparison
    — ≤ deg(i)+deg(j) fixed fori_loop steps of [E]-vector gathers, same
    O(E) memory as the lockstep plan, no [E, K] index matrix in HBM.

    Iteration structure mirrors diffuse_true exactly: the new value at
    row-sorted position f is P[i_f,j_f] · (P·W)[j_f,i_f] (the host writes
    P^T ∘ (P·W) to transposed positions, which gathers back as
    pv · dot[order_col]), row normalization before each iteration, and
    min-symmetrization at the end.
    """
    eps = jnp.float32(eps)
    BIG = jnp.int32(num_nodes)
    row_normalize = _make_row_normalize(ri_seg, num_nodes, eps)

    def true_dot(pv):
        """dot_e = Σ_k P[i_e, k] · W[k, j_e] (merge walk)."""
        a0 = jnp.zeros_like(base_i)
        b0 = jnp.zeros_like(base_i)

        def tbody(t, state):
            a, b, dot = state
            pa = base_i + a
            pb = base_j + b
            ka = jnp.where(a < deg_i, rj_keys[pa], BIG)
            kb = jnp.where(b < deg_j, ci_keys[pb], BIG)
            hit = (ka == kb) & (ka < BIG)
            dot = dot + jnp.where(hit, pv[pa] * wv_col[pb],
                                  jnp.float32(0))
            adv_a = ((ka <= kb) & (a < deg_i)).astype(a.dtype)
            adv_b = ((kb <= ka) & (b < deg_j)).astype(b.dtype)
            return a + adv_a, b + adv_b, dot

        _, _, dot = jax.lax.fori_loop(0, 2 * max_degree, tbody,
                                      (a0, b0, jnp.zeros_like(pv)))
        return dot

    def body(_, pv):
        pv = row_normalize(pv)
        dot = true_dot(pv)
        # host twin: newv = max(P^T ∘ (P·W), eps) written to transposed
        # positions == gather form pv ∘ dot[order_col], clamped
        return jnp.maximum(pv * dot[order_col], eps)

    return _run_iterations(rw, row_normalize, body, iterations, order_col)


def diffuse_true_device(edges_i, edges_j, edges_w, num_nodes,
                        iterations: int = 10, eps: float = 1e-12,
                        mesh=None):
    """"True"-mode RDD on device; same contract as
    diffuse_reference_device (sharded over `mesh` when given)."""
    E = len(edges_w)
    if E == 0:
        return edges_i, edges_j, edges_w
    plan = build_plan(edges_i, edges_j, edges_w, num_nodes)

    arrays = (plan.rw, plan.wv_col, plan.ri_seg, plan.rowstart_j,
              plan.colstart_i, plan.rj_keys, plan.ci_keys,
              plan.deg_i, plan.deg_j, plan.order_col)
    arrays = _place(arrays, mesh)
    w_sym = _diffuse_true_kernel(*arrays, num_nodes=num_nodes,
                                 iterations=iterations,
                                 max_degree=plan.max_degree, eps=eps)
    return _readback(plan, w_sym, mesh)


def _place(arrays, mesh):
    """Shard the [E_pad] plan arrays over the mesh (or just move them)."""
    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from ..parallel import multihost
        axis = mesh.axis_names[0]
        # globalize: works for a single-process mesh (device_put) and a
        # multi-host one (each device reads its slice of the replicated
        # host plan)
        return tuple(multihost.globalize(mesh, P(axis), a) for a in arrays)
    return tuple(jnp.asarray(a) for a in arrays)


def _readback(plan, w_sym, mesh):
    if mesh is not None and jax.process_count() > 1:
        from ..parallel import multihost
        w_sym = multihost.replicate(mesh, w_sym)
    w_sym = np.asarray(w_sym)[:plan.num_edges].astype(np.float64)
    return plan.ri, plan.rj, w_sym


def diffuse_reference_device(edges_i, edges_j, edges_w, num_nodes,
                             iterations: int = 10, eps: float = 1e-12,
                             mesh=None):
    """Reference-mode RDD on device; returns ((i, j)-sorted edge list).

    With ``mesh`` (a 1-D ``jax.sharding.Mesh``), the [E_pad] arrays are
    sharded over its first axis and the kernel runs as one pjit program.
    """
    E = len(edges_w)
    if E == 0:
        return edges_i, edges_j, edges_w
    plan = build_plan(edges_i, edges_j, edges_w, num_nodes)

    arrays = _place((plan.rw, plan.wv_col, plan.ri_seg, plan.rowstart_j,
                     plan.colstart_i, plan.mindeg, plan.order_col), mesh)
    w_sym = _diffuse_kernel(*arrays, num_nodes=num_nodes,
                            iterations=iterations,
                            max_degree=plan.max_degree, eps=eps)
    return _readback(plan, w_sym, mesh)
