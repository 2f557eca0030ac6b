"""Gauss-Newton solver for the non-rigid warp-field energy.

Replaces the reference's external Opt/Terra toolchain (energy declared in
include/dynfu/utils/terra/energy.t, driven through CombinedSolver in
src/dynfu/utils/opt_solver.cpp). The energy is small and fixed, so instead of
a JIT-compiled DSL we assemble the normal equations directly and solve them
with Jacobi-preconditioned CG — the same GN+PCG structure Opt generates —
entirely on device (the reference bounced robust weights through the CPU
every nonlinear iteration; opt_solver.cpp:135-140).

Energy (energy.t:47-55, 73-78), unknowns = per-node translations t (D, 3)
(rotations are declared upstream but appear in no term):

  data:  r_v = sqrt(tukey_v) * (live_v - canonical_v - sum_k w_vk t_{n_k})
  reg:   r_nj = w_reg * (t_j - t_n)    for each node n, neighbor j
  w_reg = sqrt(lambda / (D * KNN))                       (opt_solver.cpp:30)
  tukey_v = (1 - (|err_v|/tukeyOffset / psi_data)^2)^2 if < psi_data else 0
                                                        (opt_solver.cpp:204-231)

Solve flow replicates the Opt harness with earlyOut=true (the reference's
only mode, dyn_fusion.cpp:189 / opt tests): robust weights computed ONCE from
the incoming warp state, one full linear solve (the energy is linear in t,
so GN converges in a single step up to CG tolerance), then translations are
composed into the nodes (opt_solver.cpp:270-285).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.warp import field as wfield

_hi = jax.lax.Precision.HIGHEST
# Every solver matmul, the Gram assembly included, runs at HIGHEST: the
# reference accumulates these sums in plain f32, and on a GPU a HIGH or
# DEFAULT f32 product may run in TF32 (~1e-3 relative per product; the
# 512-cube normal equations then miss the 1e-5 float64 agreement
# chip_smoke.py checks).
_mm = functools.partial(jnp.matmul, precision=_hi)


class SolveStats(NamedTuple):
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    cg_iters: jnp.ndarray
    # mean Huber weight over active nodes, recomputed each outer iteration
    # (CombinedSolver::updateHuberWeights, opt_solver.cpp:233-268). The
    # reference uploads these to Opt every preNonlinearSolve but the energy
    # never reads them (energy.t declares huberWeights unused); we mirror
    # that: computed on schedule, observable in stats, not applied to terms.
    mean_huber: jnp.ndarray


def tukey_biweights(warped_canonical, live, tukey_offset: float, psi_data: float):
    """Tukey biweight per vertex from the current DQB residual
    (opt_solver.cpp:204-231)."""
    err = jnp.linalg.norm(live - warped_canonical, axis=-1) / tukey_offset
    w = (1.0 - (err / psi_data) ** 2) ** 2
    return jnp.where(err < psi_data, w, 0.0)


def huber_weights(wf: wfield.WarpField, reg_idx, psi_reg: float):
    """Huber weights on node-pair disagreement (opt_solver.cpp:233-268).

    Computed for API parity; the reference declares them in the energy file
    but never uses them in any term (energy.t:70,76). The reference also only
    keeps the LAST neighbor's weight per node (loop overwrite bug); we keep
    that reduction to match observable behavior.
    """
    n_pos = wf.pos[reg_idx]  # (D, K, 3)
    t1 = dq.dq_transform_point(wf.dqs[:, None, :], n_pos)
    t2 = dq.dq_transform_point(wf.dqs[reg_idx], n_pos)
    e = jnp.linalg.norm(t1 - t2, axis=-1)  # (D, K)
    w = jnp.where(jnp.abs(e) <= psi_reg, 1.0, psi_reg / jnp.maximum(jnp.abs(e), 1e-30))
    return w[:, -1]  # last-neighbor overwrite, as upstream


def _dense_data_normal(canonical_v, data_idx, data_w, s2, delta, D, chunk=8192):
    """Assemble A_data = W^T diag(s2) W (D, D) and b = W^T (s2 * delta)
    (D, 3) from the 8-sparse data-weight rows, gather/scatter-free.

    Instead of segment-sums over graph edges (the reference's Opt
    hypergraph reduction), each chunk of vertices expands its sparse weight
    row into a dense (chunk, D) strip via iota comparison and contracts it
    with a matmul, so the sums are deterministic. D is the node capacity
    (~1k), so A is a small dense matrix that then feeds a cheap PCG.
    """
    N, K = data_idx.shape
    pad = (-N) % chunk
    idx_p = jnp.pad(data_idx, ((0, pad), (0, 0)))
    w_p = jnp.pad(data_w, ((0, pad), (0, 0)))
    s2_p = jnp.pad(s2, (0, pad))
    d_p = jnp.pad(delta, ((0, pad), (0, 0)))
    nchunks = idx_p.shape[0] // chunk
    iota = jnp.arange(D, dtype=data_idx.dtype)

    def body(c, carry):
        A, b = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk, 0)
        idx_c, w_c, s2_c, d_c = sl(idx_p), sl(w_p), sl(s2_p), sl(d_p)
        Wc = jnp.zeros((chunk, D), jnp.float32)
        for r in range(K):
            Wc = Wc + (idx_c[:, r, None] == iota[None, :]) * w_c[:, r, None]
        sW = s2_c[:, None] * Wc
        A = A + _mm(Wc.T, sW)
        b = b + _mm(sW.T, d_c)
        return A, b

    A0 = jnp.zeros((D, D), jnp.float32)
    b0 = jnp.zeros((D, 3), jnp.float32)
    return jax.lax.fori_loop(0, nchunks, body, (A0, b0))


def _dense_reg_normal(reg_idx, edge_mask, D):
    """A_reg = M^T M with M the masked edge incidence rows
    (onehot(j) - onehot(n)); self-edges vanish identically."""
    K = reg_idx.shape[1]
    iota = jnp.arange(D, dtype=reg_idx.dtype)
    n_oh = (iota[:, None] == iota[None, :]).astype(jnp.float32)  # I_D
    A = jnp.zeros((D, D), jnp.float32)
    for r in range(K):
        j_oh = (reg_idx[:, r, None] == iota[None, :]).astype(jnp.float32)
        M = (j_oh - n_oh) * edge_mask[:, r, None]  # (D, D) rows
        A = A + _mm(M.T, M)
    return A


def build_graphs(wf: wfield.WarpField, canonical_v, knn_k: int = wfield.KNN):
    """Data graph: each vertex + its K nearest nodes (opt_solver.cpp:56-72).
    Reg graph: each node + its K nearest nodes incl. itself
    (opt_solver.cpp:74-105; the KD query at a node's own position returns the
    node itself first, giving one always-zero residual per node)."""
    data_idx, _ = wfield.find_neighbors(wf, canonical_v, knn_k)
    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, knn_k)
    return data_idx, reg_idx


@functools.partial(
    jax.jit,
    static_argnames=(
        "tukey_offset", "psi_data", "lambda_reg", "psi_reg",
        "linear_iter", "cg_tol", "knn_k", "nonlinear_iter",
        "num_iter", "early_out", "min_update", "max_update",
    ),
)
def solve(
    wf: wfield.WarpField,
    canonical_v,
    live_v,
    vert_mask=None,
    *,
    graph=None,
    graph_w=None,
    tukey_offset: float = 4.652,
    psi_data: float = 0.01,
    lambda_reg: float = 200.0,
    psi_reg: float = 1e-4,
    linear_iter: int = 256,
    cg_tol: float = 1e-12,
    knn_k: int = wfield.KNN,
    nonlinear_iter: int = 16,
    num_iter: int = 24,
    early_out: bool = True,
    min_update: float = 0.0,
    max_update: float = 0.0,
):
    """One warp solve: returns (updated WarpField, SolveStats).

    Equivalent to CombinedSolver::initializeProblemInstance + solveAll +
    copyResultToCPUFromFloat3, with the Opt harness's exact schedule
    (dyn_fusion.cpp:183-189: numIter=24, nonLinearIter=16, linearIter=256,
    earlyOut=true):

    * OUTER loop (`num_iter`): Opt's CombinedSolverBase::singleSolve —
      before each outer iteration preNonlinearSolve recomputes the Tukey
      biweights (and the energy-unused Huber weights) from the CURRENT
      composed warp state (opt_solver.cpp:131-140, 204-268; the reference
      pays a GPU->CPU->GPU bounce for this, here it stays on device).
      With `early_out` the harness BREAKS after the first outer iteration
      (the reference's only exercised mode), so outer iterations 2..24
      never run upstream either.
    * INNER loop (`nonlinear_iter`): Opt's GN relinearizations with the
      robust weights FROZEN (they are Opt problem parameters, refreshed
      only by preNonlinearSolve). The energy is linear in the per-node
      translations — rotations are declared but appear in no term
      (energy.t:30,78) — so each inner step re-solves the SAME normal
      equations warm-started from the previous estimate: step 1 converges
      to CG tolerance and steps 2..16 terminate immediately. The structure
      is kept (a fori_loop of warm-started PCG restarts) so the schedule
      is wired end-to-end, at ~zero marginal cost.
    """
    canonical_v = jnp.asarray(canonical_v, jnp.float32)
    live_v = jnp.asarray(live_v, jnp.float32)
    N = canonical_v.shape[0]
    D = wf.capacity
    if vert_mask is None:
        vert_mask = jnp.ones((N,), bool)

    # --- one fused k-NN + node-state pass over the vertices ----------------
    # (the reference walks nanoflann twice and re-reads node structs per
    # neighbor, opt_solver.cpp:56-72,204-231; here a single fused pass yields
    # the graph, the data weights AND the DQB for the robust weights).
    # The engine already runs this exact pass to warp the canonical frame
    # (dyn_fusion.cpp:203) — `graph=(data_idx, n_pos, n_w, n_valid, warped)`
    # shares it instead of paying the (N, D) search twice per frame.
    if graph_w is not None:
        # prefetched graph rows: (data_idx, data_w, warped). The engine
        # computes the k-NN + weights ONCE at the (deduplicated) warped
        # canonical and rides them through the correspondence fetch
        # (engine/dynfusion._nonrigid_frame) — invalid neighbors arrive
        # weight-0, so no separate validity mask is needed.
        data_idx, data_w, warped = graph_w
        data_idx = data_idx.astype(jnp.int32)
    else:
        if graph is None:
            data_idx, _, n_pos, n_dq, n_w, n_valid = wfield.neighbor_features(
                wf, canonical_v, knn_k
            )
            blend = wfield._dqb_from_features(
                canonical_v, n_pos, n_dq, n_w, n_valid)
            warped = dq.dq_transform_point(blend, canonical_v)
        else:
            data_idx, n_pos, n_w, n_valid, warped = graph
        # data weights at canonical vertices (energy.t:50-53)
        data_w = wfield.transformation_weights(
            n_pos, n_w, canonical_v[:, None, :])
        data_w = jnp.where(n_valid, data_w, 0.0)
    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, knn_k)

    s2 = tukey_biweights(warped, live_v, tukey_offset, psi_data)  # tukey
    s2 = jnp.where(vert_mask, s2, 0.0)

    # per-term reg weight; D is the ACTIVE node count (opt_solver.cpp:22,30)
    D_active = jnp.maximum(wf.count.astype(jnp.float32), 1.0)
    reg_w2 = lambda_reg / (D_active * knn_k)  # w_reg^2

    # masked reg edges: both endpoints active, self-edges contribute zero
    # residual regardless (t_n - t_n) so they need no special casing.
    edge_mask = (wf.mask[:, None] & wf.mask[reg_idx]).astype(jnp.float32)

    delta = live_v - canonical_v  # energy data constant
    A_reg = _dense_reg_normal(reg_idx, edge_mask, D)

    def pcg(A, b, t_init):
        diag = jnp.diagonal(A)
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.maximum(diag, 1e-30), 0.0)

        def precond(r):
            return inv_diag[:, None] * r

        def matvec(M, q):
            # (D, D) x (D, 3) as an elementwise broadcast-reduce: exact
            # f32, whatever precision the matmul units default to
            return jnp.sum(M[:, :, None] * q[None, :, :], axis=1)

        r0 = b - matvec(A, t_init)
        z0 = precond(r0)
        rz0 = jnp.vdot(r0, z0)

        # CG steps are tiny (D x D matvec); per-iteration loop overhead
        # dominates, so run UNROLL steps per while-loop trip and check the
        # tolerance between trips.
        UNROLL = 8

        def cond(state):
            _, r, _, _, rz, i = state
            return (i < linear_iter) & (rz > cg_tol)

        def step(state):
            t, r, z, p, rz, i = state
            active = rz > cg_tol  # freeze converged state inside the unroll
            ap = matvec(A, p)
            denom = jnp.vdot(p, ap)
            alpha = jnp.where(denom > 0, rz / jnp.maximum(denom, 1e-30), 0.0)
            t2 = t + alpha * p
            r2 = r - alpha * ap
            z2 = precond(r2)
            rz_new = jnp.vdot(r2, z2)
            beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
            p2 = z2 + beta * p
            return (
                jnp.where(active, t2, t), jnp.where(active, r2, r),
                jnp.where(active, z2, z), jnp.where(active, p2, p),
                jnp.where(active, rz_new, rz),
                i + jnp.where(active, 1, 0),
            )

        def body(state):
            for _ in range(UNROLL):
                state = step(state)
            return state

        t, _, _, _, _, iters = jax.lax.while_loop(
            cond, body, (t_init, r0, z0, z0, rz0, 0)
        )
        return t, iters

    def assemble_and_solve(s2_k, t_init):
        with jax.named_scope("gram"):
            A_data, b = _dense_data_normal(canonical_v, data_idx, data_w,
                                           s2_k, delta, D)
        A = A_data + reg_w2 * A_reg
        # inner nonlinear loop: Opt relinearizes `nonlinear_iter` times with
        # the robust weights frozen; the energy is linear in t so every
        # restart sees the same (A, b) and the warm-started PCG of steps
        # 2..n exits on its first convergence check.
        def inner(_, t_i):
            t_n, it_n = pcg(A, b, t_i)
            return t_n

        t = jax.lax.fori_loop(0, max(nonlinear_iter - 1, 0),
                              inner, t_init)
        t, iters = pcg(A, b, t)
        c0 = jnp.sum(s2_k[:, None] * delta * delta)
        cost0 = c0  # cost at t=0 under these weights
        costt = c0 - 2.0 * jnp.vdot(t, b) + jnp.vdot(
            t, jnp.sum(A[:, :, None] * t[None, :, :], axis=1))
        return t, iters, cost0, costt

    def huber_mean(t_cur):
        """updateHuberWeights on the CURRENT translation state: mean over
        active nodes of the (last-neighbor, as upstream) Huber weight."""
        wf_cur = wfield.compose_translations(wf, jnp.where(
            wf.mask[:, None], t_cur, 0.0))
        hw = huber_weights(wf_cur, reg_idx, psi_reg)
        m = wf.mask.astype(jnp.float32)
        return jnp.sum(hw * m) / jnp.maximum(jnp.sum(m), 1.0)

    # outer iteration 1: robust weights from the incoming warp state
    # (initializeProblemInstance runs updateTukeyBiweights/updateHuberWeights
    # before the first solve)
    mean_huber = huber_mean(jnp.zeros((D, 3), jnp.float32))
    t, iters, cost0, costt = assemble_and_solve(s2, jnp.zeros((D, 3), jnp.float32))
    initial_cost = cost0

    # outer iterations 2..num_iter: never run upstream (earlyOut breaks
    # after the first; dyn_fusion.cpp:189). Without early_out, each outer
    # iteration recomputes Tukey/Huber from the CURRENT estimate
    # (warped + W t — the warp is linear in the translations) and re-solves
    # warm-started, the preNonlinearSolve flow of opt_solver.cpp:131-140.
    outer_iters = 1 if early_out else num_iter
    for _ in range(outer_iters - 1):
        warped_k = warped + jnp.einsum(
            "nk,nkc->nc", data_w, t[data_idx], precision=_hi
        )
        s2_k = tukey_biweights(warped_k, live_v, tukey_offset, psi_data)
        s2_k = jnp.where(vert_mask, s2_k, 0.0)
        mean_huber = huber_mean(t)
        t, iters, _, costt = assemble_and_solve(s2_k, t)

    stats = SolveStats(initial_cost, costt, iters, mean_huber)

    t = jnp.where(wf.mask[:, None], t, 0.0)
    if min_update > 0.0:
        # block soft-threshold (group-lasso prox) on each node's update:
        # |t| <= min_update -> exactly zero, larger updates shrink by
        # min_update. A persistent-canonical pipeline needs this: the solve
        # otherwise fits per-frame observation noise (depth quantization +
        # TSDF interpolation, ~0.2 mm/frame/node) and warped-back
        # integration bakes that jitter into the canonical volume forever.
        # Real motion passes through with a bounded lag <= min_update
        # (the un-applied part reappears in the next frame's residual).
        # MEASURED alternatives at 64-cube, 12-frame moving sphere
        # (canonical/warped median mm): soft 6.9/6.1, HARD deadband
        # 8.2/5.2 (weak-data nodes zero out every frame and tear),
        # no gate 3.2/0.5 (but static scenes random-walk to 3.7 mm).
        # The accuracy configuration is solver_rotations=True: the SE(3)
        # solve's relinearized updates + node-local hard gate measure
        # 4.1/0.45 moving AND 2.3/0.6 static.
        norm = jnp.linalg.norm(t, axis=-1, keepdims=True)
        t = t * jnp.maximum(0.0, 1.0 - min_update / jnp.maximum(norm, 1e-12))
    if max_update > 0.0:
        # trust region (see solver/se3.py): a per-frame node step beyond
        # the projective-association gate cannot be data-driven — reject
        # it outright (weak-data rim nodes otherwise fly meters and node
        # insertion cascades along the rogue warp).
        norm = jnp.linalg.norm(t, axis=-1, keepdims=True)
        t = jnp.where(norm <= max_update, t, 0.0)
    return wfield.compose_translations(wf, t), stats
