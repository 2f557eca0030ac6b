"""Per-node SE(3) Gauss-Newton solver: the rotations the reference declared
but never wired.

The reference's energy declares per-node RotationDeform unknowns that appear
in no term (include/dynfu/utils/terra/energy.t:30,78 — the declared-but-dead
rotations), so its solve is translations-only (solver/gn.py replicates that
exactly for parity). This module is the capability done properly: each node
carries a full se(3) twist unknown xi_k = (u_k, omega_k) linearized in the
NODE's own frame (levers y - p_k stay small — global-origin rotations would
couple u and omega through meter-scale lever arms and wreck conditioning):

  warp(x_v)  ~=  y_v + sum_k wbar_vk (u_k + omega_k x (y_v - p_k))

with y_v the current DQB-warped position and wbar the NORMALIZED blend
weights (the actual DynamicFusion data term; the parity solver keeps the
reference's unnormalized quirk).

Assembly: the 6D x 6D normal matrix is NOT built from per-edge scatters
(whose sums would be order-dependent) nor from a dense (N, 6D) Jacobian
strip (36x the translation strip FLOPs). Writing the
per-vertex Jacobian as J_vk = wbar_vk (U_v + C_k) with U_v = [I | -[y_v]x]
(vertex-only) and C_k = [0 | [p_k]x] (node-only constant) factorizes every
block of J^T J into MONOMIAL-WEIGHTED Grams

  B_m = W^T diag(s2 * m(y)) W,   m in {1, y_a, y_a y_b}   (10 matrices)

— ten translation-sized matmul contractions (the same shape solver/gn.py
already runs one of) plus O(D^2) elementwise assembly with the node
constants p_k. The reg term (||T_k p_j - T_j p_j||^2, the DynamicFusion
paper form; the reference's is its translation shadow) has only D*KNN
edges, so it is assembled from batched 6x6 block products directly.

Each Gauss-Newton step composes exp(xi_k) into the node dual quaternions
(left-compose at the node frame: Trans(p_k) exp(xi) Trans(-p_k), matching
node.cpp:19-23's left-composition convention) and relinearizes y_v through
the FIXED data graph with a one-hot refetch of the updated node DQs.

Reference provenance: replaces the Opt solve of warpCanonicalToLiveOpt
(src/dynfu/dyn_fusion.cpp:182-210) with the rotation terms energy.t never
had.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.ops.knn import _onehot_fetch
from dynfu_tpu.solver.gn import tukey_biweights
from dynfu_tpu.warp import field as wfield

_hi = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_hi)  # see solver/gn.py _mm


class Se3Stats(NamedTuple):
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    cg_iters: jnp.ndarray  # of the LAST relinearization
    mean_rot_deg: jnp.ndarray  # mean applied rotation angle over active nodes


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], -1),
        jnp.stack([z, zero, -x], -1),
        jnp.stack([-y, x, zero], -1),
    ], -2)


def _fetch_rows(idx, table, chunk: int = 8192):
    """table[idx] for idx (N, K) int32 over table (D, F) as a chunked
    one-hot matmul fetch (f32-exact via the hi/lo split)."""
    N, K = idx.shape
    D, F = table.shape
    pad = (-N) % chunk
    idx_p = jnp.pad(idx, ((0, pad), (0, 0)))
    nch = idx_p.shape[0] // chunk
    iota = jnp.arange(D, dtype=idx.dtype)

    def body(c, out):
        sl = jax.lax.dynamic_slice_in_dim(idx_p, c * chunk, chunk, 0)
        oh = (sl[..., None] == iota).astype(jnp.float32)  # (chunk, K, D)
        vals = _onehot_fetch(oh.reshape(chunk * K, D), table)
        return jax.lax.dynamic_update_slice_in_dim(
            out, vals.reshape(chunk, K, F), c * chunk, 0)

    out0 = jnp.zeros((idx_p.shape[0], K, F), jnp.float32)
    return jax.lax.fori_loop(0, nch, body, out0)[:N]


def _monomial_grams(data_idx, data_w, s2, y, delta, D, chunk: int = 8192):
    """All weighted Grams + rhs sums of the factorized data term in ONE
    strip pass: for each vertex chunk the (chunk, D) weight strip is built
    once and contracted against the 10 monomial-scaled copies of itself
    (B[m] = W^T diag(s2 m) W) and the 2 rhs vectors (W^T (s2 delta),
    W^T (s2 y x delta)). Returns (B (10, D, D), Bu (D, 3), Bw (D, 3)).

    Monomial order: [1, yx, yy, yz, yx*yx, yx*yy, yx*yz, yy*yy, yy*yz,
    yz*yz]."""
    N, K = data_idx.shape
    pad = (-N) % chunk
    idx_p = jnp.pad(data_idx, ((0, pad), (0, 0)))
    w_p = jnp.pad(data_w, ((0, pad), (0, 0)))
    s2_p = jnp.pad(s2, (0, pad))
    y_p = jnp.pad(y, ((0, pad), (0, 0)))
    d_p = jnp.pad(delta, ((0, pad), (0, 0)))
    nch = idx_p.shape[0] // chunk
    iota = jnp.arange(D, dtype=data_idx.dtype)

    def body(c, carry):
        B, Bu, Bw = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * chunk, chunk, 0)
        idx_c, w_c, s2_c, y_c, d_c = (sl(idx_p), sl(w_p), sl(s2_p),
                                      sl(y_p), sl(d_p))
        Wc = jnp.zeros((chunk, D), jnp.float32)
        for r in range(K):
            Wc = Wc + (idx_c[:, r, None] == iota[None, :]) * w_c[:, r, None]
        yx, yy_, yz = y_c[:, 0], y_c[:, 1], y_c[:, 2]
        monos = [jnp.ones_like(s2_c), yx, yy_, yz,
                 yx * yx, yx * yy_, yx * yz, yy_ * yy_, yy_ * yz, yz * yz]
        Bs = []
        for m in monos:
            Bs.append(_mm(Wc.T, (s2_c * m)[:, None] * Wc))
        B = B + jnp.stack(Bs)
        sW = s2_c[:, None] * Wc
        Bu = Bu + _mm(sW.T, d_c)
        Bw = Bw + _mm(sW.T, jnp.cross(y_c, d_c))
        return B, Bu, Bw

    B0 = jnp.zeros((10, D, D), jnp.float32)
    Bu0 = jnp.zeros((D, 3), jnp.float32)
    Bw0 = jnp.zeros((D, 3), jnp.float32)
    return jax.lax.fori_loop(0, nch, body, (B0, Bu0, Bw0))


def _assemble_data(B, Bu, Bw, pos, D):
    """(A (D,6,D,6), b (D,6)) of the data term from the monomial Grams.

    With a_vk = y_v - p_k, the (k,l) block of J^T J is
      [ G1 I            G1 [p_l]x - [Gy]x                      ]
      [ ([p_k]x G1)^T.. (a.b) I - b a^T  (expanded in monomials)]
    where every y-moment comes out of B and the p's broadcast as (D, 1)
    against (1, D)."""
    G1 = B[0]
    Gy = jnp.stack([B[1], B[2], B[3]], -1)  # (D, D, 3)
    iu = jnp.asarray([[4, 5, 6], [5, 7, 8], [6, 8, 9]])
    Gyy = B[iu]  # (3, 3, D, D) symmetric moments
    Gyy = jnp.moveaxis(Gyy, (0, 1), (2, 3))  # (D, D, 3, 3)

    pk = pos[:, None, :]  # (D, 1, 3) row-block node
    pl = pos[None, :, :]  # (1, D, 3) col-block node
    eye3 = jnp.eye(3, dtype=jnp.float32)

    # uu
    A_uu = G1[..., None, None] * eye3

    # u-omega: sum s2 w w (-[y]x + [p_l]x) = -[Gy]x + G1 [p_l]x
    A_uw = -_skew(Gy) + G1[..., None, None] * _skew(pl)

    # omega-u: block transpose of u-omega with k as the lever node:
    # A_wu[k,l] = (sum s2 w w (-[y]x + [p_k]x))^T = [Gy]x - G1 [p_k]x
    A_wu = jnp.swapaxes(-_skew(Gy) + G1[..., None, None] * _skew(pk), -1, -2)

    # omega-omega: (a.b) I - b a^T
    tr_yy = Gyy[..., 0, 0] + Gyy[..., 1, 1] + Gyy[..., 2, 2]
    y_dot_p_l = jnp.einsum("klc,klc->kl", Gy, jnp.broadcast_to(pl, Gy.shape))
    y_dot_p_k = jnp.einsum("klc,klc->kl", Gy, jnp.broadcast_to(pk, Gy.shape))
    pk_dot_pl = jnp.einsum("kc,lc->kl", pos, pos)
    a_dot_b = tr_yy - y_dot_p_l - y_dot_p_k + G1 * pk_dot_pl
    # b a^T = yy^T - y pk^T - pl y^T + pl pk^T   (rows = b index, cols = a)
    ba = (Gyy
          - Gy[..., :, None] * pk[..., None, :]
          - pl[..., :, None] * Gy[..., None, :]
          + G1[..., None, None] * (pl[..., :, None] * pk[..., None, :]))
    A_ww = a_dot_b[..., None, None] * eye3 - ba

    top = jnp.concatenate([A_uu, A_uw], -1)  # (D, D, 3, 6)
    bot = jnp.concatenate([A_wu, A_ww], -1)
    A = jnp.concatenate([top, bot], -2)  # (D, D, 6, 6)
    A = jnp.moveaxis(A, 1, 2)  # (D, 6, D, 6)

    b_u = Bu
    b_w = Bw - jnp.cross(pos, Bu)
    b = jnp.concatenate([b_u, b_w], -1)  # (D, 6)
    return A, b


def _assemble_reg(wf, reg_idx, edge_mask, reg_w2, D, chunk: int = 2048,
                  psi_reg: float = 0.0, similarity: bool = False):
    """Reg normal equations from the SE(3)-linearized DynamicFusion term
    r_kj = T_k(p_j) - T_j(p_j): (A_reg (D,6,D,6), b_reg (D,6), cost0).

    Edge rows J_e are 3 x 6D with only two nonzero blocks ([I |
    -[t_k(p_j)-p_k]x] at k, -[I | -[t_j(p_j)-p_j]x] at j). A dense
    (3c, 6D) strip would spend ~90 GMACs per chunk on 12 nonzeros/row. The
    edges are naturally (D, K)-shaped (edge (k, r) joins k to
    reg_idx[k, r]), so the assembly needs only the batched 6x6 block
    products and, for the j-side placements, K one-hot (D, D) broadcasts /
    small matmuls — no dense strip ever exists.

    psi_reg > 0 applies the DynamicFusion paper's Huber weight on each
    edge's CURRENT disagreement (w_e = 1 below psi, psi/|r| above) — the
    robust reg the reference computed every iteration but never fed to any
    term (opt_solver.cpp:233-268 / energy.t:70,76)."""
    K = reg_idx.shape[1]
    pos = wf.pos
    # current transforms applied to the NEIGHBOR node position p_j
    n_pos = pos[reg_idx]  # (D, K, 3) tiny (D nodes), direct index fine
    yk = dq.dq_transform_point(wf.dqs[:, None, :], n_pos)  # T_k(p_j)
    yj = dq.dq_transform_point(wf.dqs[reg_idx], n_pos)  # T_j(p_j)
    if psi_reg > 0.0:
        e = jnp.linalg.norm(yk - yj, axis=-1)  # (D, K)
        hw = jnp.where(e <= psi_reg, 1.0,
                       psi_reg / jnp.maximum(e, 1e-30))
        edge_mask = edge_mask * jnp.sqrt(hw)  # folded into the edge rows
    r0 = (yk - yj) * edge_mask[..., None]  # (D, K, 3)

    eye3 = jnp.eye(3, dtype=jnp.float32)
    # edge-masked Jacobian blocks in (D, K, 3, 6) layout; folding the mask
    # into BOTH blocks squares it in every product, matching the strip
    # formulation exactly
    em = edge_mask[..., None, None]
    Gk = jnp.concatenate(
        [jnp.broadcast_to(eye3, (D, K, 3, 3)),
         -_skew(yk - pos[:, None, :])], -1) * em
    Gj = jnp.concatenate(
        [jnp.broadcast_to(eye3, (D, K, 3, 3)), -_skew(yj - n_pos)], -1) * em

    # batched 6x6 block products (D*K small contractions)
    Mkk = jnp.einsum("dkai,dkaj->dkij", Gk, Gk, precision=_hi)
    Mkj = jnp.einsum("dkai,dkaj->dkij", Gk, Gj, precision=_hi)
    Mjj = jnp.einsum("dkai,dkaj->dkij", Gj, Gj, precision=_hi)
    bk = jnp.einsum("dkai,dka->di", Gk, r0, precision=_hi)  # (D, 6)
    bj = jnp.einsum("dkai,dka->dki", Gj, r0, precision=_hi)  # (D, K, 6)

    didx = jnp.arange(D)
    OH = (reg_idx[..., None] == didx).astype(jnp.float32)  # (D, K, D)
    # cross blocks: A[d, l] -= sum_{r: idx[d,r]=l} Mkj[d, r] (+ transpose)
    cross = jnp.einsum("drl,drij->dlij", OH, Mkj, precision=_hi)
    A = -cross - jnp.transpose(cross, (1, 0, 3, 2))
    # diagonals: own-row blocks at k, neighbor blocks segment-summed at j
    diag = (jnp.sum(Mkk, axis=1)
            + jnp.einsum("drl,drij->lij", OH, Mjj, precision=_hi))
    A = A.at[didx, didx].add(diag)
    A = jnp.swapaxes(A, 1, 2)  # (D, 6, D, 6)
    # rhs: b = sum_e S^T r (k block +Gk^T r, j block -Gj^T r)
    b = bk - jnp.einsum("drl,dri->li", OH, bj, precision=_hi)

    if similarity:
        # SIMILARITY-MODE reg: marginalize a PER-COMPONENT uniform-scale
        # mode out of the reg quadratic. A per-node RIGID field
        # approximates a uniform expansion with irreducible inter-node
        # disagreement r_kj ~ sigma (p_k - p_j) (sigma = scale rate),
        # which the ARAP-style term prices — measured as the moving-camera
        # fusion benchmark's dominant residual (under-tracked breathing). The scale mode is augmented as one scalar
        # sigma_c per CONNECTED COMPONENT of the reg graph — a single
        # global sigma is useless the moment the scene holds a deforming
        # object AND static background: the background nodes dominate the
        # global direction, so the object's own scale stays fully priced
        # (bit-identical warped error with/without the global flag on the
        # moving-camera scene). Per edge the residual
        # derivative is d_e = p_k - p_j (both endpoints shift by
        # sigma (p - c); the component center c cancels); scales do not
        # couple across components, so the exact Schur complement is a
        # rank-per-component downdate of (A, b):
        #   A -= sum_c (J^T d)_c (J^T d)_c^T / (d^T d)_c
        #   b -= sum_c ((d^T r0)_c / (d^T d)_c) (J^T d)_c.
        # Local incoherence is still fully priced; only each component's
        # single coherent-scale direction rides free (the data term
        # determines the actual scale). For a connected reg graph this
        # reduces exactly to the former global-mode formulation.
        d_e = (pos[:, None, :] - n_pos) * edge_mask[..., None]  # (D, K, 3)
        Jtd_k = jnp.einsum("dkai,dka->di", Gk, d_e, precision=_hi)
        Jtd_j = jnp.einsum("dkai,dka->dki", Gj, d_e, precision=_hi)
        Jtd = Jtd_k - jnp.einsum("drl,dri->li", OH, Jtd_j, precision=_hi)

        # connected-component labels by min-index propagation with
        # pointer jumping (O(log D) rounds; 10 covers any D here). The
        # pull/push mins ride the existing (D, K, D) one-hot instead of
        # scatter-min — small at D<=1k, and this assembly runs once
        # per relinearization. Masked edges do not conduct.
        conn = edge_mask > 0.0  # (D, K)

        def _prop(_, lab):
            pull = jnp.where(conn, lab[reg_idx], D).min(axis=1)
            push = jnp.where(conn[..., None] & (OH > 0.0),
                             lab[:, None, None], D).min(axis=(0, 1))
            lab = jnp.minimum(lab, jnp.minimum(pull, push))
            return jnp.minimum(lab, lab[lab])  # pointer jump

        lab = jax.lax.fori_loop(0, 10, _prop,
                                jnp.arange(D, dtype=jnp.int32))
        OHc = (lab[:, None] == jnp.arange(D)).astype(jnp.float32)  # (D, D)
        # every contribution landing at Jtd row m comes from an edge in
        # m's own component (masked Gj blocks are zero), so attributing
        # whole rows by the row node's label is exact
        dtd_c = jnp.einsum("dl,d->l", OHc, jnp.sum(d_e * d_e, (1, 2)))
        dtr_c = jnp.einsum("dl,d->l", OHc, jnp.sum(d_e * r0, (1, 2)))
        inv_c = jnp.where(dtd_c > 1e-12,
                          1.0 / jnp.maximum(dtd_c, 1e-12), 0.0)
        V = (Jtd[:, :, None] * OHc[:, None, :]).reshape(D * 6, D)
        A = (A.reshape(D * 6, D * 6)
             - (V * inv_c[None, :]) @ V.T).reshape(D, 6, D, 6)
        b = b - ((V * (inv_c * dtr_c)[None, :]).sum(-1)).reshape(D, 6)

    cost0 = jnp.sum(r0 * r0)
    return reg_w2 * A, -reg_w2 * b, reg_w2 * cost0


def _matvec(A, p):
    """A @ p for a single right-hand vector as a broadcast-reduce.

    The f32 elementwise multiply + row reduction is traffic-bound (one read
    of A) and exact, whatever precision the matmul units default to."""
    return jnp.sum(A * p[None, :], axis=1)


def _pcg(A, b, x0, linear_iter: int, cg_tol: float):
    """Jacobi-PCG on the flattened (6D,) system (same structure as
    gn.solve's; unrolled 8-step trips to amortize loop overhead)."""
    n = b.shape[0]
    diag = jnp.diagonal(A)
    inv_diag = jnp.where(diag > 0, 1.0 / jnp.maximum(diag, 1e-30), 0.0)

    r0 = b - _matvec(A, x0)
    z0 = inv_diag * r0
    rz0 = jnp.vdot(r0, z0)
    UNROLL = 8

    def cond(state):
        _, _, _, _, rz, i = state
        return (i < linear_iter) & (rz > cg_tol)

    def step(state):
        x, r, z, p, rz, i = state
        active = rz > cg_tol
        ap = _matvec(A, p)
        denom = jnp.vdot(p, ap)
        alpha = jnp.where(denom > 0, rz / jnp.maximum(denom, 1e-30), 0.0)
        x2 = x + alpha * p
        r2 = r - alpha * ap
        z2 = inv_diag * r2
        rz2 = jnp.vdot(r2, z2)
        beta = jnp.where(rz > 0, rz2 / jnp.maximum(rz, 1e-30), 0.0)
        p2 = z2 + beta * p
        return (jnp.where(active, x2, x), jnp.where(active, r2, r),
                jnp.where(active, z2, z), jnp.where(active, p2, p),
                jnp.where(active, rz2, rz), i + jnp.where(active, 1, 0))

    def body(state):
        for _ in range(UNROLL):
            state = step(state)
        return state

    x, _, _, _, _, iters = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, rz0, 0))
    return x, iters


def _exp_update_dq(xi, pos):
    """Per-node update DQ for twist xi (D, 6) about the node frame:
    Trans(p) Rot(exp(omega)) Trans(-p) Trans(u) as one rigid transform
    (R, t) with t = u + p - R p."""
    u, w = xi[:, :3], xi[:, 3:]
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)
    axis = w / jnp.maximum(theta, 1e-12)
    half = 0.5 * theta
    rot = jnp.concatenate([jnp.cos(half), jnp.sin(half) * axis], -1)
    # R p via quaternion sandwich on the pure quat (0, p)
    pq = jnp.concatenate([jnp.zeros_like(pos[:, :1]), pos], -1)
    rp = dq.quat_mul(dq.quat_mul(rot, pq), dq.quat_conj(rot))[:, 1:]
    t = u + pos - rp
    return dq.dq_from_quat_translation(rot, t)


@functools.partial(
    jax.jit,
    static_argnames=("tukey_offset", "psi_data", "lambda_reg", "psi_reg",
                     "linear_iter", "cg_tol", "knn_k", "relinearize",
                     "min_update", "max_update", "incremental", "rot_prior",
                     "trans_prior", "similarity_reg"),
)
def solve(
    wf: wfield.WarpField,
    canonical_v,
    live_v,
    vert_mask=None,
    *,
    tukey_offset: float = 4.652,
    psi_data: float = 0.01,
    lambda_reg: float = 200.0,
    psi_reg: float = 1e-4,
    linear_iter: int = 256,
    cg_tol: float = 1e-12,
    knn_k: int = wfield.KNN,
    relinearize: int = 3,
    min_update: float = 0.0,
    max_update: float = 0.0,
    incremental: bool = False,
    rot_prior: float = 0.03,
    trans_prior: float = 0.0,
    similarity_reg: bool = False,
):
    """SE(3) warp solve: (updated WarpField, Se3Stats).

    `relinearize` Gauss-Newton steps; each recomputes the warped positions
    y_v through the FIXED data graph from the accumulated node updates,
    re-assembles the factorized normal equations, and solves by PCG. Robust
    (Tukey) weights follow the reference's schedule: computed once from the
    incoming state (early-out harness, dyn_fusion.cpp:189).

    `incremental`: canonical_v is ALREADY warped by the current field (the
    fusion engine's convention — it hands the solver warped positions), so
    the blend treats the current state as identity and the solved updates
    compose onto the node DQs."""
    canonical_v = jnp.asarray(canonical_v, jnp.float32)
    live_v = jnp.asarray(live_v, jnp.float32)
    N = canonical_v.shape[0]
    D = wf.capacity
    if vert_mask is None:
        vert_mask = jnp.ones((N,), bool)

    data_idx, n_sqd, n_pos, n_dq0, n_w, n_valid = wfield.neighbor_features(
        wf, canonical_v, knn_k)
    if incremental:
        n_dq0 = jnp.broadcast_to(dq.dq_identity(), n_dq0.shape)
    # PROPER DLB blend (normalized weights, joint normalization) — the
    # reference-quirk sequential-product DQB cannot blend rotations (its
    # dq_scale touches only the dual part), see wfield._dlb_from_features
    blend = wfield._dlb_from_features(canonical_v, n_pos, n_dq0, n_w, n_valid)
    y0 = dq.dq_transform_point(blend, canonical_v)

    # NORMALIZED blend weights (the DynamicFusion data term; zero rows stay
    # zero so unsupported vertices drop out of the data term)
    w_raw = wfield.transformation_weights(n_pos, n_w, canonical_v[:, None, :])
    w_raw = jnp.where(n_valid, w_raw, 0.0)
    wsum = jnp.sum(w_raw, axis=-1, keepdims=True)
    data_w = w_raw / jnp.maximum(wsum, 1e-12)

    s2 = tukey_biweights(y0, live_v, tukey_offset, psi_data)
    s2 = jnp.where(vert_mask & (wsum[:, 0] > 1e-12), s2, 0.0)
    # UNSUPPORTED vertices (min_k dist/dg_w >= 1, warp_field.cpp:34-61) are
    # node-INSERTION candidates, not data: their normalized blend weights
    # still sum to 1 but every neighbor is beyond its support radius, so
    # their residuals act through long levers and feed the omega blocks
    # leverage noise. With a saturated node budget (e.g. sampling truncated
    # by max_nodes) whole surface regions are unsupported and the rotation
    # solve blew up from frame 1 at the 512-cube workload; gating them out
    # keeps the data term inside the field's interpolation domain.
    support = jnp.where(n_valid, jnp.sqrt(n_sqd) / jnp.maximum(n_w, 1e-12),
                        jnp.inf)
    s2 = jnp.where(jnp.min(support, axis=-1) < 1.0, s2, 0.0)

    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, knn_k)
    edge_mask = (wf.mask[:, None] & wf.mask[reg_idx]).astype(jnp.float32)
    D_active = jnp.maximum(wf.count.astype(jnp.float32), 1.0)
    reg_w2 = lambda_reg / (D_active * knn_k)

    # Assembly frame: center y and the node positions on the active-node
    # centroid. The monomial factorization builds each A/b block from
    # terms ~|y|^2 that cancel down to lever scale (|y - p_k| ~ dg_w);
    # in absolute volume coordinates (~3 m) that cancellation ratio
    # reaches 1e2-1e3, and reduced-precision contraction noise (~1.5e-5
    # relative of the LARGE terms for 3-pass bf16) lands at the signal
    # scale — the solve produced tens-of-degrees garbage rotations where
    # the same math in CPU f32 was stable. The assembled system is exactly
    # shift-invariant (J depends on y and p only through -[y]x + [p]x),
    # so centering changes nothing but the roundoff; xi is solved in the
    # centered frame and composed with the TRUE node positions.
    m_act = wf.mask.astype(jnp.float32)
    center = (jnp.sum(wf.pos * m_act[:, None], axis=0)
              / jnp.maximum(jnp.sum(m_act), 1.0))
    pos_c = jnp.where(wf.mask[:, None], wf.pos - center, 0.0)

    initial_cost = jnp.sum(s2 * jnp.sum((live_v - y0) ** 2, -1))

    def gn_step(carry, _):
        upd, y = carry  # upd: accumulated per-node update DQ (D, 8)
        # reg assembled against the CURRENT composed state
        wf_cur = wf._replace(dqs=jnp.where(
            wf.mask[:, None], dq.dq_mul(upd, wf.dqs), wf.dqs))
        delta = live_v - y
        y_c = y - center  # centered assembly frame (see above)
        with jax.named_scope("gram"):
            B, Bu, Bw = _monomial_grams(data_idx, data_w, s2, y_c, delta, D)
        A_d, b_d = _assemble_data(B, Bu, Bw, pos_c, D)
        A_r, b_r, _ = _assemble_reg(wf_cur, reg_idx, edge_mask, reg_w2, D,
                                    psi_reg=psi_reg,
                                    similarity=similarity_reg)
        A = (A_d + A_r).reshape(D * 6, D * 6)
        b = (b_d + b_r).reshape(D * 6)
        if trans_prior > 0.0:
            # translation step damping scaled by the MEAN data strength:
            # weak-data nodes (silhouette rims, sparse support) otherwise
            # fit mm-scale observation wiggles each frame that leak past
            # the min_update gate into the canonical volume. Scaling by
            # the mean (not the node's own strength) is the point — it
            # dominates weak nodes while barely touching strong ones, and
            # as pure step damping real motion still converges through it
            # across relinearizations.
            duu_all = jnp.einsum("kaka->ka", A_d)[:, :3].mean(-1)
            m_active = wf.mask.astype(jnp.float32)
            mean_duu = (jnp.sum(duu_all * m_active)
                        / jnp.maximum(jnp.sum(m_active), 1.0))
            dvec_u = jnp.zeros((D, 6)).at[:, :3].set(trans_prior * mean_duu)
            A = A + jnp.diag(dvec_u.reshape(-1))
        if rot_prior > 0.0:
            # per-node rotation prior toward zero: on weakly-constrained
            # geometry (a sphere observes no rotation about its normal;
            # tangent rotations trade off against translation at mm
            # residual scale) the omega directions are near-singular and
            # soak up correspondence noise as tens of degrees of spin.
            # Price a rotation theta like a translation theta * dg_w (the
            # node's support radius), scaled by the node's OWN data
            # strength (its u-block diagonal) — real rotation signal in
            # the data dwarfs the prior, noise does not.
            duu = jnp.einsum("kaka->ka", A_d)[:, :3].mean(-1)  # (D,)
            lever2 = wf.w * wf.w
            dvec = jnp.zeros((D, 6)).at[:, 3:].set(
                (rot_prior * duu * lever2)[:, None])
            A = A + jnp.diag(dvec.reshape(-1))
        xi_flat, iters = _pcg(A, b, jnp.zeros_like(b), linear_iter, cg_tol)
        xi = xi_flat.reshape(D, 6)
        xi = jnp.where(wf.mask[:, None], xi, 0.0)
        step_dq = _exp_update_dq(xi, wf.pos)
        upd2 = dq.dq_mul(step_dq, upd)
        # relinearize: refetch updated node DQs through the fixed graph
        upd_n = _fetch_rows(data_idx, upd2)  # (N, K, 8)
        n_dq = dq.dq_mul(upd_n, n_dq0)
        blend2 = wfield._dlb_from_features(
            canonical_v, n_pos, n_dq, n_w, n_valid)
        y2 = dq.dq_transform_point(blend2, canonical_v)
        # GN safeguarding: PCG on a near-singular normal system
        # occasionally returns a step that RAISES the data cost by orders
        # of magnitude (512-cube fusion: final_cost spikes of 1e4-1e7x) —
        # its sub-trust-region components
        # still pass the step gates and accumulate as drift. Reject the
        # whole step and keep the current state (the next relinearization
        # re-assembles from there). The slack must be GENEROUS: healthy
        # steps legitimately raise the s2-weighted data cost ~30x when the
        # regularizer buys coherence with noisy rows (measured at 512-cube
        # with rot_prior=0.03; a 4x slack rejected every step and the
        # field froze at identity), so only clear blow-ups are rejected.
        c_old = jnp.sum(s2 * jnp.sum((live_v - y) ** 2, -1))
        c_new = jnp.sum(s2 * jnp.sum((live_v - y2) ** 2, -1))
        ok = c_new <= 100.0 * c_old
        upd2 = jnp.where(ok, upd2, upd)
        y2 = jnp.where(ok, y2, y)
        return (upd2, y2), iters

    upd0 = jnp.broadcast_to(dq.dq_identity(), (D, 8))
    (upd, y_fin), iters_all = jax.lax.scan(
        gn_step, (upd0, y0), None, length=max(relinearize, 1))

    if min_update > 0.0 or max_update > 0.0:
        # hard deadband on the NODE'S OWN displacement |upd(p_k) - p_k|
        # (keep static scenes static in fusion mode — sub-threshold noise
        # fits zero out entirely, real motion passes unchanged). The dq's
        # raw translation would be the displacement of the global ORIGIN,
        # which a small rotation about a node meters away turns into a
        # meter-scale number — gating on it never holds.
        #
        # max_update is the matching TRUST REGION: a per-frame step whose
        # worst-case displacement ANYWHERE IN THE NODE'S SUPPORT exceeds
        # the projective-association gate cannot be data-driven (every
        # data target lies within that gate of the warped vertex), so it
        # is a noise fit of a weak-data node — REJECT it outright rather
        # than scale it (a garbage direction at reduced magnitude still
        # seeds garbage). The support-radius term matters: a pure rotation
        # about the node moves the NODE zero while swinging its whole
        # neighborhood by 2 sin(θ/2) dg_w — measured at 512-cube the
        # un-gated solve spins rim nodes ~150° on frame 1 (t_dual ~3.9 m)
        # and either the displacement gate alone misses it or node
        # insertion cascades along the rogue warp.
        moved = dq.dq_transform_point(upd, wf.pos) - wf.pos
        norm = jnp.linalg.norm(moved, axis=-1, keepdims=True)
        keep = norm > min_update if min_update > 0.0 else norm >= 0.0
        if max_update > 0.0:
            realp = upd[:, :4]
            half = jnp.arccos(jnp.clip(
                jnp.abs(realp[:, 0])
                / jnp.maximum(jnp.linalg.norm(realp, axis=-1), 1e-12),
                0.0, 1.0))  # θ/2 of the update's rotation
            sweep = norm[:, 0] + 2.0 * jnp.sin(half) * wf.w
            keep = keep & (sweep <= max_update)[:, None]
        upd = jnp.where(keep, upd,
                        jnp.broadcast_to(dq.dq_identity(), upd.shape))

    final_cost = jnp.sum(s2 * jnp.sum((live_v - y_fin) ** 2, -1))
    real = upd[:, :4]
    ang = 2.0 * jnp.arccos(jnp.clip(jnp.abs(real[:, 0])
                                    / jnp.linalg.norm(real, axis=-1), 0, 1))
    m = wf.mask.astype(jnp.float32)
    mean_rot = jnp.sum(ang * m) / jnp.maximum(jnp.sum(m), 1.0)

    dqs = jnp.where(wf.mask[:, None], dq.dq_mul(upd, wf.dqs), wf.dqs)
    stats = Se3Stats(initial_cost, final_cost, iters_all[-1],
                     jnp.degrees(mean_rot))
    return wf._replace(dqs=dqs), stats
