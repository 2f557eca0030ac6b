"""Plain float64 numpy references for the engine's hot stages.

Each function restates the semantics of one jitted stage in straightforward
numpy, independent of the code under test: the tests compare the stages
against these at small sizes on the CPU, and `chip_smoke.py` compares them
at the real 512-cube widths on the GPU.
"""

from __future__ import annotations

import numpy as np


def knn(points, nodes, k: int, node_mask=None, chunk: int = 8192):
    """Exact k-NN of points (Q, 3) among nodes (D, 3): (idx (Q, k), sqd
    (Q, k)) ascending, ties to the lower index; masked nodes sit at +inf."""
    points = np.asarray(points, np.float64)
    nodes = np.asarray(nodes, np.float64)
    idx = np.empty((len(points), k), np.int64)
    sqd = np.empty((len(points), k), np.float64)
    for s in range(0, len(points), chunk):
        d = ((points[s:s + chunk, None, :] - nodes[None]) ** 2).sum(-1)
        if node_mask is not None:
            d[:, ~np.asarray(node_mask, bool)] = np.inf
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        idx[s:s + chunk] = order
        sqd[s:s + chunk] = np.take_along_axis(d, order, 1)
    return idx, sqd


def _qmul(a, b):
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _dq_mul(a, b):
    return np.concatenate([_qmul(a[..., :4], b[..., :4]),
                           _qmul(a[..., :4], b[..., 4:])
                           + _qmul(a[..., 4:], b[..., :4])], -1)


def _dq_transform(dq, v):
    rw, rv, dw, dv = dq[..., :1], dq[..., 1:4], dq[..., 4:5], dq[..., 5:8]
    return (v + 2.0 * np.cross(rv, np.cross(rv, v) + rw * v)
            + 2.0 * (rw * dv - dw * rv + np.cross(rv, dv)))


def _dq_rotate(dq, v):
    r = dq[..., :4]
    vq = np.concatenate([np.zeros_like(v[..., :1]), v], -1)
    conj = r * np.array([1.0, -1.0, -1.0, -1.0])
    return _qmul(_qmul(r, vq), conj)[..., 1:]


def warp(points, normals, pos, dqs, w, mask, k: int = 8, blend: str = "dqb",
         idx=None):
    """Warp points and normals through the node field.

    blend="dqb": the reference's sequential product of dual-scaled node DQs
    in nearest-first order, real part normalized, normals transformed like
    points (warp_field.cpp:127-171). blend="dlb": normalized-weight linear
    blend, sign-aligned to the nearest node, jointly normalized; normals
    rotated only. `idx` (Q, k) fixes the neighbour order (nearest first,
    -1 for an absent neighbour) instead of the float64 k-NN, for
    comparisons where float32 distance ties may order neighbours
    differently. Returns (warped points, warped normals) in float64."""
    p = np.asarray(points, np.float64)
    n = np.asarray(normals, np.float64)
    pos = np.asarray(pos, np.float64)
    dqs = np.asarray(dqs, np.float64)
    w = np.asarray(w, np.float64)
    mask = np.asarray(mask, bool)
    if idx is None:
        idx, sqd = knn(p, pos, k, mask)
    else:
        given = np.asarray(idx, np.int64)
        idx = np.maximum(given, 0)
        sqd = np.where((given >= 0) & mask[idx], 0.0, np.inf)
    valid = mask[idx] & np.isfinite(sqd)
    nw = np.exp(-((p[:, None, :] - pos[idx]) ** 2).sum(-1)
                / (2.0 * w[idx] ** 2))
    ndq = dqs[idx]
    ident = np.array([1.0, 0, 0, 0, 0, 0, 0, 0])
    if blend == "dqb":
        scaled = ndq.copy()
        scaled[..., 4:] *= nw[..., None]
        scaled = np.where(valid[..., None], scaled, ident)
        acc = np.broadcast_to(ident, (len(p), 8)).copy()
        for i in range(k):
            acc = _dq_mul(acc, scaled[:, i])
        acc[:, :4] /= np.linalg.norm(acc[:, :4], axis=-1, keepdims=True)
        return _dq_transform(acc, p), _dq_transform(acc, n)
    wv = np.where(valid, nw, 0.0)
    wsum = wv.sum(-1, keepdims=True)
    wn = wv / np.maximum(wsum, 1e-12)
    sign = np.where((ndq[..., :4] * ndq[:, :1, :4]).sum(-1, keepdims=True)
                    < 0.0, -1.0, 1.0)
    acc = (wn[..., None] * ndq * sign).sum(1)
    acc = np.where(wsum > 1e-12, acc, ident)
    acc /= np.linalg.norm(acc[:, :4], axis=-1, keepdims=True)
    return _dq_transform(acc, p), _dq_rotate(acc, n)


def _pair_sums(idx, coef, D: int):
    """sum_v coef_v w_va w_vb scattered at (idx_va, idx_vb): (D, D)."""
    ia = idx[:, :, None] * D + idx[:, None, :]
    return np.bincount(ia.ravel(), weights=coef.ravel(),
                       minlength=D * D).reshape(D, D)


def data_normal(idx, w, s2, delta, D: int):
    """A = W^T diag(s2) W (D, D), b = W^T (s2 delta) (D, 3) for the
    K-sparse weight rows W[v, idx[v, r]] = w[v, r] (duplicates add)."""
    idx = np.asarray(idx, np.int64)
    w = np.asarray(w, np.float64)
    s2 = np.asarray(s2, np.float64)
    delta = np.asarray(delta, np.float64)
    A = _pair_sums(idx, s2[:, None, None] * w[:, :, None] * w[:, None, :], D)
    sw = s2[:, None] * w
    b = np.stack([np.bincount(idx.ravel(), (sw[:, :, None] * delta[:, None, c:c + 1]
                                            ).ravel(), minlength=D)
                  for c in range(3)], -1)
    return A, b


def monomial_grams(idx, w, s2, y, delta, D: int):
    """(B (10, D, D), Bu (D, 3), Bw (D, 3)) of the SE(3) data term:
    B[m] = W^T diag(s2 m(y)) W over the monomials [1, yx, yy, yz, yx yx,
    yx yy, yx yz, yy yy, yy yz, yz yz], Bu = W^T (s2 delta), Bw = W^T
    (s2 y x delta)."""
    idx = np.asarray(idx, np.int64)
    w = np.asarray(w, np.float64)
    s2 = np.asarray(s2, np.float64)
    y = np.asarray(y, np.float64)
    delta = np.asarray(delta, np.float64)
    yx, yy, yz = y[:, 0], y[:, 1], y[:, 2]
    monos = [np.ones_like(s2), yx, yy, yz, yx * yx, yx * yy, yx * yz,
             yy * yy, yy * yz, yz * yz]
    ww = w[:, :, None] * w[:, None, :]
    B = np.stack([_pair_sums(idx, (s2 * m)[:, None, None] * ww, D)
                  for m in monos])
    _, Bu = data_normal(idx, w, s2, delta, D)
    _, Bw = data_normal(idx, w, s2, np.cross(y, delta), D)
    return B, Bu, Bw


def emit_triangles(tris, t_offsets, n_tris, max_tris: int):
    """Loop form of marching cubes' triangle emission: slot j < n_tris[v]
    of voxel v lands at row t_offsets[v] + j, rows >= max_tris dropped."""
    tris = np.asarray(tris, np.float32)
    out = np.zeros((max_tris, tris.shape[2]), np.float32)
    for v in range(len(tris)):
        for j in range(int(n_tris[v])):
            row = int(t_offsets[v]) + j
            if row < max_tris:
                out[row] = tris[v, j]
    return out
