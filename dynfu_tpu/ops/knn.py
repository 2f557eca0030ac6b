"""k-nearest-neighbor search and fused neighbor-state fetch.

Replaces the reference's vendored nanoflann KD-tree (include/nanoflann/,
used at warp_field.cpp:118, dyn_fusion.cpp:234, opt_solver.cpp:88) with a
dense distance computation plus vectorized selection — exact, and free of
per-query tree walks for the problem sizes involved.

Formulation notes:
* neighbor STATE is fetched by one-hot matmuls fused with the search
  (`knn_gather`, `nn1_gather`): the one-hot factor is exact in bf16 and the
  value table is split three ways into bf16 parts (`_bf16_parts`), so the
  f32 result is exact (`_onehot_fetch`) at any matmul precision;
* point matmuls pad the coordinate axis from 3 to `_PAD_K` columns;
* `_topk_argmin` extracts k minima by iterated masked argmin (exact, ties
  to the lower index — the same rule as lax.top_k and nanoflann's ordered
  results).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_hi = jax.lax.Precision.HIGHEST
_INF = jnp.float32(jnp.inf)
_PAD_K = 128  # 3-d coordinates padded to this many columns


def _pad_coords(x):
    return jnp.pad(x, ((0, 0), (0, _PAD_K - x.shape[1])))


def pairwise_sqdist(queries: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 distances (Q, P) = |q|^2 - 2 q.p + |p|^2."""
    qn = jnp.sum(queries * queries, axis=-1, keepdims=True)  # (Q, 1)
    pn = jnp.sum(points * points, axis=-1)  # (P,)
    cross = jnp.matmul(
        _pad_coords(queries), _pad_coords(points).T, precision=_hi
    )  # (Q, P), K padded
    d = qn - 2.0 * cross + pn[None, :]
    return jnp.maximum(d, 0.0)


def _topk_argmin(d: jnp.ndarray, k: int):
    """k smallest per row of d (Q, P): (values (Q,k), indices (Q,k)) sorted
    ascending, ties to the lower index. Iterated masked argmin — exact.

    Each round selects the successor of the previous pick in (value, index)
    lexicographic order — a strict total order, so successive minima ARE the
    ascending ties-to-lower-index sequence. Masking "already selected" this
    way needs only the previous round's per-row scalars, so d is never
    rewritten: every round is a pure fused read of d (the old
    rewrite-selected-to-inf formulation spent a full (Q, P) write per
    round)."""
    iota = jnp.arange(d.shape[-1], dtype=jnp.int32)
    vals, idxs = [], []
    v_prev = jnp.full(d.shape[:-1], -_INF, d.dtype)
    i_prev = jnp.full(d.shape[:-1], -1, jnp.int32)
    for _ in range(k):
        after = (d > v_prev[..., None]) | (
            (d == v_prev[..., None]) & (iota > i_prev[..., None]))
        dm = jnp.where(after, d, _INF)
        i_prev = jnp.argmin(dm, axis=-1).astype(jnp.int32)
        v_prev = jnp.min(dm, axis=-1)
        vals.append(v_prev)
        idxs.append(i_prev)
    return jnp.stack(vals, -1), jnp.stack(idxs, -1)


def knn_brute(
    queries: jnp.ndarray,
    points: jnp.ndarray,
    k: int,
    point_mask: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN: returns (indices (Q,k), sqdists (Q,k)) sorted ascending.

    Semantics match nanoflann knnSearch (sorted by distance; ties broken by
    lower index). Masked-out points are pushed to +inf so they are only
    returned when fewer than k valid points exist — callers must gate on
    `sqdists < inf` in that case.
    """
    d = pairwise_sqdist(queries, points)
    if point_mask is not None:
        d = jnp.where(point_mask[None, :], d, _INF)
    sqd, idx = _topk_argmin(d, k)
    return idx, sqd


def nn1(queries: jnp.ndarray, points: jnp.ndarray, point_mask=None):
    """1-NN (used by DynFusion::findCorrespondingFrame, dyn_fusion.cpp:212-242)."""
    d = pairwise_sqdist(queries, points)
    if point_mask is not None:
        d = jnp.where(point_mask[None, :], d, _INF)
    idx = jnp.argmin(d, axis=-1)
    return idx, jnp.min(d, axis=-1)


def nn1_blocked(queries, points, point_mask=None, block: int = 4096):
    """Blocked 1-NN: same result as nn1 with peak memory (block, P)."""
    idx, sqd = knn_blocked(queries, points, 1, point_mask, block)
    return idx[:, 0], sqd[:, 0]


@functools.partial(jax.jit, static_argnames=("k", "block"))
def knn_blocked(
    queries: jnp.ndarray,
    points: jnp.ndarray,
    k: int,
    point_mask: jnp.ndarray | None = None,
    block: int = 8192,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN over query blocks to bound the (Q, P) buffer."""
    Q = queries.shape[0]
    pad = (-Q) % block
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    nblocks = qp.shape[0] // block
    qb = qp.reshape(nblocks, block, 3)

    def one(qs):
        return knn_brute(qs, points, k, point_mask)

    idx, sqd = jax.lax.map(one, qb)
    return idx.reshape(-1, k)[:Q], sqd.reshape(-1, k)[:Q]


# ---------------------------------------------------------------------------
# fused neighbor lookups
# ---------------------------------------------------------------------------


def _bf16_parts(table: jnp.ndarray):
    """Exact three-way bf16 split of an f32 table: hi + mid + lo == table.

    Each part keeps the leading 8 significant bits of what the previous
    parts left (3 x 8 bits cover f32's 24). The parts are cut by masking
    the low 16 bits of the f32 pattern, not by f32 -> bf16 -> f32 round
    trips, which a compiler allowed excess precision may fold away (that
    would leave hi alone, a bf16-precision fetch)."""
    def trunc(x):
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        return jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                            jnp.float32)

    hi = trunc(table)
    rem = table - hi  # exact: the low 16 mantissa bits
    mid = trunc(rem)
    lo = rem - mid  # exact, <= 8 significant bits
    return tuple(x.astype(jnp.bfloat16) for x in (hi, mid, lo))


def _onehot_fetch(oh_f32: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """oh @ table with an exact-in-bf16 one-hot and the exact three-way
    bf16 split of the table (`_bf16_parts`): each output element sums one
    nonzero product per part, so the fetch is f32-exact whatever precision
    the matmul units run at."""
    oh = oh_f32.astype(jnp.bfloat16)
    out = None
    for part in _bf16_parts(table):
        term = jax.lax.dot_general(
            oh, part, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        out = term if out is None else out + term
    return out


@functools.partial(jax.jit, static_argnames=("k",))
def knn_gather(
    queries: jnp.ndarray,  # (Q, 3)
    points: jnp.ndarray,  # (D, 3)
    k: int,
    table: jnp.ndarray,  # (D, F) features to fetch per neighbor
    point_mask: jnp.ndarray | None = None,
):
    """Fused k-NN + feature fetch: (idx (Q,k), sqdists (Q,k), feats (Q,k,F)).

    Equivalent to ``idx, d = knn(...); feats = table[idx]`` but with the
    fetch as one-hot matmuls built from the argmin output — exact.
    Single-shot over Q (the (Q, D) distance matrix for the
    node-capacity D of this engine is a few hundred MB at most).
    """
    Q = queries.shape[0]
    D = points.shape[0]
    d = pairwise_sqdist(queries, points)
    if point_mask is not None:
        d = jnp.where(point_mask[None, :], d, _INF)
    sqd, idx = _topk_argmin(d, k)

    iota = jnp.arange(D, dtype=jnp.int32)
    feats = []
    for r in range(k):
        oh = (idx[:, r, None] == iota[None, :]).astype(jnp.float32)
        feats.append(_onehot_fetch(oh, table))
    return idx, sqd, jnp.stack(feats, axis=1)


@functools.partial(jax.jit, static_argnames=("block",))
def nn1_gather_sorted(
    queries: jnp.ndarray,  # (Q, 3)
    points: jnp.ndarray,  # (P, 3)
    values: jnp.ndarray,  # (P, F)
    point_mask: jnp.ndarray | None = None,
    block: int = 8192,
):
    """Windowed 1-NN + fetch for near-coincident surfaces: (vals, exact).

    Both sets are sorted along x (lax.sort with payload columns — no
    permutation gathers); each query block scans only the three point blocks
    overlapping its rank window, cutting the (Q, P) distance-matrix traffic
    — the bandwidth bound of brute-force 1-NN — by a factor ~P/(3*block).

    Exactness: the true NN satisfies |p*_x - q_x| <= dist(q, p*), so a
    window answer is provably exact whenever its distance is smaller than
    the query's x-gap to the nearest EXCLUDED block; the returned `exact`
    mask reports that certificate per query. For the engine's workload
    (live vs warped-canonical vertices, millimeters apart on the same
    surface, window spans of centimeters+) it is essentially all-true.
    """
    Q = queries.shape[0]
    P = points.shape[0]
    F = values.shape[1]
    BIG = jnp.float32(3e38)
    center = jnp.mean(points, axis=0)  # cancellation control (see nn1_gather)
    queries = queries - center
    points = points - center

    if point_mask is not None:
        pts = jnp.where(point_mask[:, None], points, BIG)
    else:
        pts = points
    # sort points by x, carrying y/z and the value columns as payloads
    p_ops = (pts[:, 0], pts[:, 1], pts[:, 2]) + tuple(
        values[:, f] for f in range(F)
    )
    p_sorted = jax.lax.sort(p_ops, num_keys=1)
    ps = jnp.stack(p_sorted[:3], axis=1)  # (P, 3)
    vs = jnp.stack(p_sorted[3:], axis=1)  # (P, F)

    # sort queries by x, carrying y/z and the original rank for un-sorting
    q_ops = (queries[:, 0], queries[:, 1], queries[:, 2],
             jnp.arange(Q, dtype=jnp.int32))
    q_sorted = jax.lax.sort(q_ops, num_keys=1)
    qs = jnp.stack(q_sorted[:3], axis=1)
    q_rank = q_sorted[3]

    padq = (-Q) % block
    qs = jnp.pad(qs, ((0, padq), (0, 0)), constant_values=BIG)
    nqb = qs.shape[0] // block
    padp = max(3 * block, ((P + block - 1) // block) * block) - P
    ps = jnp.pad(ps, ((0, padp), (0, 0)), constant_values=BIG)
    vs = jnp.pad(vs, ((0, padp), (0, 0)))
    npb = ps.shape[0] // block
    iota3 = jnp.arange(3 * block, dtype=jnp.int32)
    # x-value at the start of each point block: the window for a query block
    # is aligned by VALUE (searchsorted), not rank — rank alignment breaks
    # when the two sets carry different masked/padding fractions
    block_x0 = ps[:: block, 0]  # (npb,)

    def one(i, carry):
        val_all, dist_all, exact_all = carry
        qb = jax.lax.dynamic_slice_in_dim(qs, i * block, block, 0)
        qmid = qb[block // 2, 0]
        c = jnp.clip(
            jnp.searchsorted(block_x0, qmid).astype(jnp.int32) - 1, 0, npb - 1
        )
        lo = jnp.clip(c - 1, 0, jnp.maximum(npb - 3, 0))
        pb = jax.lax.dynamic_slice_in_dim(ps, lo * block, 3 * block, 0)
        vb = jax.lax.dynamic_slice_in_dim(vs, lo * block, 3 * block, 0)

        # BIG-sentinel rows (masked points, padding) must yield +inf distance,
        # not inf-inf=NaN (argmin would return the NaN column)
        valid_p = pb[:, 0] < 1e37
        pbz = jnp.where(valid_p[:, None], pb, 0.0)
        pn = jnp.sum(pbz * pbz, axis=-1)
        cross = jnp.matmul(_pad_coords(qb), _pad_coords(pbz).T, precision=_hi)
        qn = jnp.sum(qb * qb, axis=-1, keepdims=True)
        d = jnp.maximum(qn - 2.0 * cross + pn[None, :], 0.0)
        d = jnp.where(valid_p[None, :], d, _INF)
        j = jnp.argmin(d, axis=-1)
        dbest = jnp.min(d, axis=-1)
        oh = (iota3[None, :] == j[:, None]).astype(jnp.float32)
        vals = _onehot_fetch(oh, vb)

        # exactness certificate vs the x-ranges outside the window. A query
        # lying OUTSIDE the window's x-range has zero margin toward the
        # excluded side (its negative gap must clamp to 0, not abs to a
        # false-positive certificate).
        gap_lo = jnp.where(lo > 0,
                           jnp.maximum(qb[:, 0] - pb[0, 0], 0.0), jnp.inf)
        gap_hi = jnp.where(lo + 3 < npb,
                           jnp.maximum(pb[-1, 0] - qb[:, 0], 0.0), jnp.inf)
        gap = jnp.minimum(gap_lo, gap_hi)
        exact = dbest <= gap * gap

        val_all = jax.lax.dynamic_update_slice_in_dim(val_all, vals, i * block, 0)
        dist_all = jax.lax.dynamic_update_slice_in_dim(dist_all, dbest, i * block, 0)
        exact_all = jax.lax.dynamic_update_slice_in_dim(exact_all, exact, i * block, 0)
        return val_all, dist_all, exact_all

    val0 = jnp.zeros((nqb * block, F), jnp.float32)
    d0 = jnp.zeros((nqb * block,), jnp.float32)
    ex0 = jnp.zeros((nqb * block,), bool)
    val_s, dist_s, ex_s = jax.lax.fori_loop(0, nqb, one, (val0, d0, ex0))

    # un-sort: order results by the carried original query rank
    out_ops = (q_rank, ex_s[:Q].astype(jnp.int32)) + tuple(
        val_s[:Q, f] for f in range(F)
    )
    restored = jax.lax.sort(out_ops, num_keys=1)
    exact = restored[1] > 0
    vals = jnp.stack(restored[2:], axis=1)
    return vals, exact


def _nn1_brute_subset(qs, ps, vs, chunk: int = 32768):
    """Exact 1-NN + fetch for a SMALL query set vs ALL points: streaming
    running-min over point chunks (R x chunk elementwise distances, winner
    index tracked per chunk). No certificate —
    every point is examined, so the result is exact by construction.
    Returns (vals (R, F), found (R,)); found is False only for queries
    with no finite-distance point (BIG-masked query or empty point set).
    Ties resolve to the lowest point INDEX in ps order (= lowest x for the
    x-sorted arrays used here, matching the windowed pass)."""
    R = qs.shape[0]
    P = ps.shape[0]
    pad = (-P) % chunk
    ps = jnp.pad(ps, ((0, pad), (0, 0)), constant_values=3e38)
    nchunks = ps.shape[0] // chunk

    def body(c, carry):
        best_d, best_j = carry
        pb = jax.lax.dynamic_slice_in_dim(ps, c * chunk, chunk, 0)
        valid_p = pb[:, 0] < 1e37
        pbz = jnp.where(valid_p[:, None], pb, 0.0)
        dx = qs[:, 0:1] - pbz[None, :, 0].reshape(1, chunk)
        dy = qs[:, 1:2] - pbz[None, :, 1].reshape(1, chunk)
        dz = qs[:, 2:3] - pbz[None, :, 2].reshape(1, chunk)
        d = dx * dx + dy * dy + dz * dz
        d = jnp.where(valid_p[None, :], d, _INF)
        j = jnp.argmin(d, axis=-1).astype(jnp.int32)
        dbest = jnp.min(d, axis=-1)
        take = dbest < best_d  # strict: earlier chunks win ties
        return (jnp.where(take, dbest, best_d),
                jnp.where(take, c * chunk + j, best_j))

    d0 = jnp.full((R,), _INF, jnp.float32)
    j0 = jnp.zeros((R,), jnp.int32)
    best_d, best_j = jax.lax.fori_loop(0, nchunks, body, (d0, j0))
    # final fetch: one small (R, F) row gather — the per-chunk one-hot
    # matmul alternative materializes R x P of bf16 one-hots (~8 GB at the
    # 512-cube rescue) where this touches R*F elements once
    best_v = vs[jnp.clip(best_j, 0, vs.shape[0] - 1)]
    return best_v, best_d < 1e37


def _window_bounds(ps, block: int):
    """Order-free exactness bounds at block granularity for BIG-masked
    points ps (npb*block, 3): (pre (npb+1,), suf (npb+1,)) where
    pre[j] = max valid x over blocks < j (pre[0] = -inf) and
    suf[j] = min valid x over blocks >= j (suf[npb] = +inf). Any point
    excluded left/right of a window [lo, lo+wb) is then at least
    (q_x - pre[lo]) / (suf[lo+wb] - q_x) away in x — valid for ANY point
    order, sorted or not."""
    npb = ps.shape[0] // block
    x = ps[:, 0].reshape(npb, block)
    valid = x < 1e37
    bmax = jnp.max(jnp.where(valid, x, -jnp.inf), axis=1)
    bmin = jnp.min(jnp.where(valid, x, jnp.inf), axis=1)
    pre = jnp.concatenate([jnp.asarray([-jnp.inf], jnp.float32),
                           jax.lax.cummax(bmax)])
    suf = jnp.concatenate([
        jax.lax.cummin(bmin, reverse=True),
        jnp.asarray([jnp.inf], jnp.float32)])
    return pre, suf


def _window_sweep(qs, ps, vs, lo_blk, pre, suf, block: int,
                  window_blocks: int):
    """One windowed 1-NN pass: (vals (Qp, F), exact (Qp,)).

    qs (Qp, 3) centered queries in blocks of `block` (invalid slots carry
    x >= 1e37), ps (npb*block, 3) centered points with invalid slots
    pushed to BIG (any order), vs their fetch payload, lo_blk (nqb,) the
    window start BLOCK per query block, (pre, suf) the `_window_bounds`
    certificates. `exact` implies the TRUE global 1-NN was found: every
    point outside the window is at least gap = min(q_x - pre[lo],
    suf[lo+wb] - q_x) away, so dbest <= gap^2 certifies optimality."""
    W = window_blocks * block
    nqb = qs.shape[0] // block
    npb = ps.shape[0] // block
    F = vs.shape[1]
    iota_w = jnp.arange(W, dtype=jnp.int32)

    def one(i, carry):
        val_all, exact_all = carry
        qb = jax.lax.dynamic_slice_in_dim(qs, i * block, block, 0)
        valid_q = qb[:, 0] < 1e37
        lo = lo_blk[i]
        pb = jax.lax.dynamic_slice_in_dim(ps, lo * block, W, 0)
        vb = jax.lax.dynamic_slice_in_dim(vs, lo * block, W, 0)

        valid_p = pb[:, 0] < 1e37
        pbz = jnp.where(valid_p[:, None], pb, 0.0)
        # unrolled elementwise distances (no matmul: K=3 pads to 128 lanes
        # and HIGHEST multiplies the pass count)
        dx = qb[:, 0:1] - pbz[None, :, 0].reshape(1, W)
        dy = qb[:, 1:2] - pbz[None, :, 1].reshape(1, W)
        dz = qb[:, 2:3] - pbz[None, :, 2].reshape(1, W)
        d = dx * dx + dy * dy + dz * dz
        d = jnp.where(valid_p[None, :], d, _INF)
        j = jnp.argmin(d, axis=-1)
        dbest = jnp.min(d, axis=-1)
        oh = (iota_w[None, :] == j[:, None]).astype(jnp.float32)
        vals = _onehot_fetch(oh, vb)

        gap_lo = qb[:, 0] - pre[lo]
        gap_hi = suf[lo + window_blocks] - qb[:, 0]
        gap = jnp.maximum(jnp.minimum(gap_lo, gap_hi), 0.0)
        exact = (dbest <= gap * gap) & valid_q

        val_all = jax.lax.dynamic_update_slice_in_dim(val_all, vals, i * block, 0)
        exact_all = jax.lax.dynamic_update_slice_in_dim(exact_all, exact, i * block, 0)
        return val_all, exact_all

    val0 = jnp.zeros((nqb * block, F), jnp.float32)
    ex0 = jnp.zeros((nqb * block,), bool)
    return jax.lax.fori_loop(0, nqb, one, (val0, ex0))


@functools.partial(jax.jit, static_argnames=(
    "block", "window_blocks", "rescue", "escalate", "escalate_factor",
    "presorted", "values_fn"))
def nn1_gather_xwindow(
    queries: jnp.ndarray,  # (Q, 3) — NEARLY x-sorted (e.g. marching-cubes
    #                         emission order); sortedness affects only how
    #                         many certificates pass, never correctness
    points: jnp.ndarray,  # (P, 3)
    values: jnp.ndarray | None = None,  # (P, F); None fetches the points
    point_mask: jnp.ndarray | None = None,
    query_mask: jnp.ndarray | None = None,
    block: int = 4096,
    window_blocks: int = 3,
    rescue: int = 0,
    escalate: int = 0,
    escalate_factor: int = 4,
    presorted: bool = False,
    values_fn=None,
):
    """Windowed 1-NN + fetch for near-coincident surfaces: (vals, exact).

    The successor of `nn1_gather_sorted`, which spent its time in a
    K-padded HIGHEST distance matmul and three payload sorts; this version
      * computes window distances with unrolled elementwise broadcasts
        (exact f32, no K=3 contraction),
      * sorts ONLY the points along x (queries arrive nearly sorted from
        marching cubes' x-major emission; results are written back in
        query order, so the query sort AND the un-sort disappear),
      * keeps the one-hot bf16 value fetch and the per-query exactness
        certificate of `nn1_gather_sorted` (see there for the proof; a
        query whose window cannot be certified reports exact=False and
        must be masked by the caller — the engine counts these drops in
        FrameStats.corr_dropped).

    Failure tiers (a failure = the per-query exactness certificate cannot
    prove the window contained the global 1-NN — dense x-slabs like
    sphere pole caps, or moving-edge queries whose true NN is farther
    than the window's x-margin):

    * escalate > 0: up to `escalate` failed queries are compacted and
      re-swept with an `escalate_factor`-times wider window — the margin
      grows by the same factor, certifying moving-edge queries whose NN
      sits a few cm away. Cost scales with escalate (16k queries), not Q.
      A compacted tile can straddle BOTH pole caps (no single window
      covers two x-extremes) — those queries simply fail again and fall
      through to the brute tier.
    * rescue > 0: up to `rescue` still-failed queries get an exact
      brute-force scan over ALL points (chunk-streamed). Rescued queries are exact by
      construction; only failures beyond the capacity remain exact=False
      (the engine counts them in FrameStats.corr_dropped).
    """
    Q = queries.shape[0]
    P = points.shape[0]
    vals_in = points if values is None else values
    F = vals_in.shape[1]
    BIG = jnp.float32(3e38)

    if point_mask is not None:
        valid_p_in = point_mask
    else:
        valid_p_in = jnp.ones((P,), bool)
    # cancellation control (see nn1_gather): center on the valid cloud
    denom = jnp.maximum(jnp.sum(valid_p_in.astype(jnp.float32)), 1.0)
    center = jnp.sum(jnp.where(valid_p_in[:, None], points, 0.0), axis=0) / denom
    queries = queries - center
    points = points - center

    pts = jnp.where(valid_p_in[:, None], points, BIG)
    qs0 = queries
    if query_mask is not None:
        qs0 = jnp.where(query_mask[:, None], qs0, BIG)

    # sort points by x, carrying y/z (+ explicit value columns if any).
    # `presorted=True` skips the sort: the exactness
    # certificate is ORDER-FREE (_window_bounds), so sortedness only
    # affects how many certificates pass — callers whose point set is
    # already nearly x-ordered (a marching-cubes soup is emitted x-major,
    # and a smooth warp of one preserves near-order) lose nothing but a
    # few extra escalate-tier queries. Tie semantics: ties resolve to the
    # lowest index in ps order — with presorted that is the ORIGINAL point
    # order, which matches nanoflann's lowest-original-index pick.
    # values_fn: payload computed AFTER the sort from the SORTED points —
    # a sort's cost grows with its operand arity, so per-point payload that
    # is a pure function of the point POSITION need not ride the sort. values_fn(sorted_uncentered_points,
    # sorted_valid) -> (P, F) raw payload; masked slots are zeroed (BIG
    # coords would otherwise produce inf/NaN payload, and the one-hot
    # fetch MATMUL sums 0*inf = NaN across the whole window).
    if presorted:
        ps = pts
        vs = ps if values is None else values
    else:
        if values is None:
            p_ops = (pts[:, 0], pts[:, 1], pts[:, 2])
        else:
            p_ops = (pts[:, 0], pts[:, 1], pts[:, 2]) + tuple(
                values[:, f] for f in range(F)
            )
        p_sorted = jax.lax.sort(p_ops, num_keys=1)
        ps = jnp.stack(p_sorted[:3], axis=1)  # (P, 3)
        if values is None:
            # fetched values are the (centered) sorted coords; un-center after
            vs = ps
        else:
            vs = jnp.stack(p_sorted[3:], axis=1)  # (P, F)
    if values_fn is not None:
        assert values is None, "pass values OR values_fn, not both"
        valid_s = ps[:, 0] < 1e37
        vs = values_fn(ps + center[None, :], valid_s)
        vs = jnp.where(valid_s[:, None], vs, 0.0)
        values = vs  # fetched payload semantics from here on
        F = vs.shape[1]

    def one_pass(qs_c, wb):
        """One windowed sweep over the SORTED points for BIG-masked
        centered queries qs_c: (vals CENTERED-if-coords, exact)."""
        n = qs_c.shape[0]
        padq = (-n) % block
        qsp = jnp.pad(qs_c, ((0, padq), (0, 0)), constant_values=BIG)
        W = wb * block
        padp = max(W, ((P + block - 1) // block) * block) - P
        psp = jnp.pad(ps, ((0, padp), (0, 0)), constant_values=BIG)
        vsp = jnp.pad(vs, ((0, padp), (0, 0)))
        npb = psp.shape[0] // block
        nqb = qsp.shape[0] // block

        # window starts: per query block, on its valid-mean x — via
        # searchsorted on the sorted blocks' first x, or (presorted =
        # near-ordered, block starts not guaranteed monotone) the
        # order-free nearest-block-mean placement
        qx = qsp[:, 0].reshape(nqb, block)
        valid_q = qx < 1e37
        nq = jnp.maximum(jnp.sum(valid_q, axis=1).astype(jnp.float32), 1.0)
        qmid = jnp.sum(jnp.where(valid_q, qx, 0.0), axis=1) / nq
        if presorted:
            px = psp[:, 0].reshape(npb, block)
            vp = px < 1e37
            nv = jnp.maximum(jnp.sum(vp, axis=1).astype(jnp.float32), 1.0)
            bmean = jnp.sum(jnp.where(vp, px, 0.0), axis=1) / nv
            bmean = jnp.where(jnp.any(vp, axis=1), bmean, BIG)
            c = jnp.argmin(jnp.abs(qmid[:, None] - bmean[None, :]),
                           axis=1).astype(jnp.int32)
        else:
            block_x0 = psp[::block, 0]
            c = jnp.clip(jnp.searchsorted(block_x0, qmid).astype(jnp.int32) - 1,
                         0, npb - 1)
        lo_blk = jnp.clip(c - (wb - 1) // 2, 0, max(npb - wb, 0))

        pre, suf = _window_bounds(psp, block)
        val_s, ex_s = _window_sweep(qsp, psp, vsp, lo_blk, pre, suf,
                                    block, wb)
        return val_s[:n], ex_s[:n]

    vals, exact = one_pass(qs0, window_blocks)

    if escalate:
        vals, exact = _scatter_pass(
            vals, exact, qs0, min(escalate, Q),
            lambda fq: one_pass(fq, window_blocks * escalate_factor))
    if rescue:
        vals, exact = _brute_rescue(vals, exact, qs0, ps, vs,
                                    min(rescue, Q))

    if values is None:
        vals = vals + center[None, :]  # un-center fetched coordinates
    return vals, exact


def _scatter_pass(vals, exact, qs0, R: int, pass_fn):
    """Compact up to R certificate-failed queries, run `pass_fn` on the
    compacted (BIG-padded) query array, scatter back the results that came
    back exact. Failures beyond R — or still inexact after the pass — keep
    exact=False (the caller's drop counter is the signal)."""
    Q = qs0.shape[0]
    failed = (qs0[:, 0] < 1e37) & ~exact
    fidx = jnp.nonzero(failed, size=R, fill_value=Q)[0]
    fok = fidx < Q
    fq = jnp.where(fok[:, None], qs0[jnp.minimum(fidx, Q - 1)],
                   jnp.float32(3e38))
    rvals, rex = pass_fn(fq)
    rex = rex & fok
    sidx = jnp.where(rex, fidx, Q)  # Q = out of bounds -> dropped
    vals = vals.at[sidx].set(rvals, mode="drop")
    exact = exact.at[sidx].set(True, mode="drop")
    return vals, exact


def _brute_rescue(vals, exact, qs0, ps, vs, R: int):
    """Exact brute-force tier: `_scatter_pass` around `_nn1_brute_subset`
    (every rescued query is exact by construction)."""
    return _scatter_pass(vals, exact, qs0, R,
                         lambda fq: _nn1_brute_subset(fq, ps, vs))


@functools.partial(jax.jit, static_argnames=("block",))
def nn1_gather(
    queries: jnp.ndarray,  # (Q, 3)
    points: jnp.ndarray,  # (P, 3)
    values: jnp.ndarray,  # (P, F)
    point_mask: jnp.ndarray | None = None,
    block: int = 8192,
):
    """Fused 1-NN + value fetch for LARGE point sets: (idx (Q,), vals (Q,F)).

    The fetch turns the argmin into an exact 0/1 one-hot (ties to the lower
    index, nanoflann-style single pick) and contracts it with `values` as
    bf16 matmuls over a hi/mid/lo-split table — f32-exact.

    The distance matrix keeps only the argmin-relevant terms (|p|^2 - 2 q.p;
    the per-row |q|^2 shifts every candidate equally) in f32 — bf16 would be
    cheaper but catastrophically cancels: |p|^2 is meters^2-scale while
    neighbor separations are millimeters.
    """
    Q = queries.shape[0]
    P = points.shape[0]
    # center on the cloud: |q-c|, |p-c| ~ scene extents instead of absolute
    # coordinates, which shrinks the cancellation error of the
    # pn - 2 q.p distance form by the square of the ratio
    center = jnp.mean(points, axis=0)
    queries = queries - center
    points = points - center
    pad = (-Q) % block
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    nblocks = qp.shape[0] // block
    qb = qp.reshape(nblocks, block, 3)
    iota = jnp.arange(P, dtype=jnp.int32)
    pn = jnp.sum(points * points, axis=-1)  # (P,)
    pp = _pad_coords(points)

    def one(qs):
        cross = jnp.matmul(_pad_coords(qs), pp.T, precision=_hi)
        d = pn[None, :] - 2.0 * cross
        if point_mask is not None:
            d = jnp.where(point_mask[None, :], d, _INF)
        idx = jnp.argmin(d, axis=-1)
        oh = (iota[None, :] == idx[:, None]).astype(jnp.float32)
        vals = _onehot_fetch(oh, values)
        return idx, vals

    idx, vals = jax.lax.map(one, qb)
    return idx.reshape(-1)[:Q], vals.reshape(-1, values.shape[1])[:Q]
