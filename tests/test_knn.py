"""k-NN parity vs exact numpy reference (the nanoflann-replacement bar:
SURVEY.md hard part #4 — the dense search must return the same neighbor sets
as a KD-tree or parity drifts through the data graph)."""

import numpy as np
import pytest

from dynfu_tpu.ops import knn


def numpy_knn(q, p, k, mask=None):
    d = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[None, :], d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, axis=1)


def test_knn_matches_exact():
    rng = np.random.RandomState(0)
    q = rng.randn(257, 3).astype(np.float32)
    p = rng.randn(123, 3).astype(np.float32)
    idx, sqd = knn.knn_brute(q, p, 8)
    ridx, rsqd = numpy_knn(q, p, 8)
    np.testing.assert_array_equal(np.asarray(idx), ridx)
    np.testing.assert_allclose(np.asarray(sqd), rsqd, rtol=1e-5, atol=1e-6)


def test_knn_sorted_ascending():
    rng = np.random.RandomState(1)
    q = rng.randn(50, 3).astype(np.float32)
    p = rng.randn(64, 3).astype(np.float32)
    _, sqd = knn.knn_brute(q, p, 8)
    s = np.asarray(sqd)
    assert (np.diff(s, axis=1) >= -1e-7).all()


def test_knn_mask():
    rng = np.random.RandomState(2)
    q = rng.randn(20, 3).astype(np.float32)
    p = rng.randn(40, 3).astype(np.float32)
    mask = np.arange(40) < 25
    idx, sqd = knn.knn_brute(q, p, 8, mask)
    assert (np.asarray(idx) < 25).all()
    ridx, _ = numpy_knn(q, p, 8, mask)
    np.testing.assert_array_equal(np.asarray(idx), ridx)


def test_knn_fewer_points_than_k():
    rng = np.random.RandomState(3)
    q = rng.randn(5, 3).astype(np.float32)
    p = rng.randn(10, 3).astype(np.float32)
    mask = np.arange(10) < 4  # only 4 valid, k=8
    _, sqd = knn.knn_brute(q, p, 8, mask)
    s = np.asarray(sqd)
    assert np.isfinite(s[:, :4]).all()
    assert np.isinf(s[:, 4:]).all()


def test_nn1_matches():
    rng = np.random.RandomState(4)
    q = rng.randn(100, 3).astype(np.float32)
    p = rng.randn(77, 3).astype(np.float32)
    idx, _ = knn.nn1(q, p)
    ridx, _ = numpy_knn(q, p, 1)
    np.testing.assert_array_equal(np.asarray(idx), ridx[:, 0])


def test_knn_blocked_equals_brute():
    rng = np.random.RandomState(5)
    q = rng.randn(1000, 3).astype(np.float32)
    p = rng.randn(333, 3).astype(np.float32)
    i1, d1 = knn.knn_brute(q, p, 8)
    i2, d2 = knn.knn_blocked(q, p, 8, block=256)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-6)


def test_nn1_gather_sorted_matches_exact():
    """Windowed sorted 1-NN equals brute-force on surface-like data."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(11)
    base = np.sort(rng.rand(4000).astype(np.float32)) * 2.0
    pts = np.stack(
        [base, np.cos(base * 7) * 0.4 + 1.0, np.sin(base * 7) * 0.4 + 1.0], -1
    ).astype(np.float32)
    queries = pts + rng.randn(4000, 3).astype(np.float32) * 0.003
    vals = np.concatenate([pts, pts * 2], 1).astype(np.float32)

    got, exact = knn.nn1_gather_sorted(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals), block=512
    )
    _, want = knn.nn1_gather(jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals))
    got, want, exact = np.asarray(got), np.asarray(want), np.asarray(exact)
    assert exact.mean() > 0.999  # certificate essentially always holds
    # near-equidistant candidates resolve differently under f32 noise
    # (~2e-7 m^2 at unit coordinate scale = sub-mm); require distance
    # optimality up to that noise and near-total agreement
    dg = np.sum((queries - got[:, :3]) ** 2, axis=1)
    dw = np.sum((queries - want[:, :3]) ** 2, axis=1)
    assert (dg[exact] <= dw[exact] + 5e-7).all()
    same = np.isclose(got, want, atol=1e-5).all(1)
    assert same[exact].mean() > 0.95


def test_nn1_gather_sorted_respects_mask():
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(5)
    pts = rng.rand(600, 3).astype(np.float32)
    queries = pts + 0.001
    mask = np.ones(600, bool)
    mask[::2] = False  # half the points masked out
    vals = pts.astype(np.float32)
    got, _ = knn.nn1_gather_sorted(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals),
        jnp.asarray(mask), block=256,
    )
    _, want = knn.nn1_gather(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(mask)
    )
    # masked points never returned: every result must be a valid point
    d = np.linalg.norm(np.asarray(got)[:, None, :] - pts[None, mask], axis=-1)
    assert d.min(axis=1).max() < 1e-5


def test_nn1_gather_xwindow_matches_exact():
    """x-windowed 1-NN (unsorted nearly-x-ordered queries) equals brute
    force wherever the certificate passes."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(11)
    base = np.sort(rng.rand(4000).astype(np.float32)) * 2.0
    pts = np.stack(
        [base, np.cos(base * 7) * 0.4 + 1.0, np.sin(base * 7) * 0.4 + 1.0], -1
    ).astype(np.float32)
    # queries: jittered points in nearly-sorted order (marching-cubes-like)
    queries = pts + rng.randn(4000, 3).astype(np.float32) * 0.003
    vals = np.concatenate([pts, pts * 2], 1).astype(np.float32)

    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals), block=512
    )
    _, want = knn.nn1_gather(jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals))
    got, want, exact = np.asarray(got), np.asarray(want), np.asarray(exact)
    assert exact.mean() > 0.999
    dg = np.sum((queries - got[:, :3]) ** 2, axis=1)
    dw = np.sum((queries - want[:, :3]) ** 2, axis=1)
    assert (dg[exact] <= dw[exact] + 5e-7).all()
    same = np.isclose(got, want, atol=1e-5).all(1)
    assert same[exact].mean() > 0.95


def test_nn1_gather_xwindow_fetch_points_and_masks():
    """values=None fetches the point coordinates themselves (un-centered),
    point_mask excludes points, query_mask marks queries inexact."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(5)
    pts = (rng.rand(600, 3).astype(np.float32) + np.float32([5, -3, 2]))
    order = np.argsort(pts[:, 0])
    queries = pts[order] + 0.001
    pmask = np.ones(600, bool)
    pmask[::2] = False
    qmask = np.ones(600, bool)
    qmask[-7:] = False
    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), None,
        jnp.asarray(pmask), jnp.asarray(qmask), block=256,
    )
    got, exact = np.asarray(got), np.asarray(exact)
    # masked queries are never certified
    assert not exact[-7:].any()
    # every certified result is a valid (unmasked) point, exactly
    d = np.linalg.norm(got[exact][:, None, :] - pts[None, pmask], axis=-1)
    assert d.min(axis=1).max() < 1e-5
    # and is the true masked-brute-force NN
    _, want = knn.nn1_gather(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(pts),
        jnp.asarray(pmask))
    want = np.asarray(want)
    dg = np.sum((queries - got) ** 2, axis=1)
    dw = np.sum((queries - want) ** 2, axis=1)
    assert (dg[exact] <= dw[exact] + 5e-7).all()


def test_nn1_gather_xwindow_unsorted_queries_still_correct():
    """Fully shuffled queries: efficiency degrades (certificates fail) but
    every certified answer must still be the exact NN."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(3)
    pts = rng.rand(3000, 3).astype(np.float32)
    queries = rng.permutation(pts + 0.002)
    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), None, block=256)
    got, exact = np.asarray(got), np.asarray(exact)
    _, want = knn.nn1_gather(jnp.asarray(queries), jnp.asarray(pts),
                             jnp.asarray(pts))
    want = np.asarray(want)
    dg = np.sum((queries - got) ** 2, axis=1)
    dw = np.sum((queries - want) ** 2, axis=1)
    assert (dg[exact] <= dw[exact] + 5e-7).all()


def test_nn1_gather_xwindow_rescue_pole_caps():
    """Dense x-slabs (thousands of points sharing one x — sphere pole
    caps) defeat the narrow first-pass window; the rescue pass must
    recover the exact 1-NN for every failed query."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(13)
    # two dense slabs at x=0 and x=2 plus a sparse band between
    slab = lambda x0, n: np.stack(
        [np.full(n, x0, np.float32),
         rng.rand(n).astype(np.float32),
         rng.rand(n).astype(np.float32)], -1)
    pts = np.concatenate([slab(0.0, 3000), slab(2.0, 3000),
                          slab(1.0, 200)]).astype(np.float32)
    order = np.argsort(pts[:, 0], kind="stable")
    pts = pts[order]
    queries = pts + rng.randn(*pts.shape).astype(np.float32) * 1e-3

    got_n, exact_n = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), block=256, window_blocks=3)
    exact_n = np.asarray(exact_n)
    assert (~exact_n).sum() > 100  # the narrow window really does fail here

    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), block=256, window_blocks=3,
        rescue=8192)
    got, exact = np.asarray(got), np.asarray(exact)
    assert exact.all()  # 32*256 = 8192 >= P: rescue window covers everything

    d = ((queries[:, None, :3] - pts[None, :, :3]) ** 2).sum(-1)
    want = pts[d.argmin(1)]
    dg = ((queries - got) ** 2).sum(1)
    dw = ((queries - want) ** 2).sum(1)
    np.testing.assert_allclose(dg, dw, rtol=1e-4, atol=1e-7)


def test_nn1_gather_xwindow_rescue_respects_masks_and_values():
    """Rescue path: fetched VALUES and masks behave identically to the
    first pass (masked points never selected, masked queries never
    rescued)."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(17)
    n = 2048
    pts = np.stack([np.zeros(n, np.float32),  # one giant x-slab
                    rng.rand(n).astype(np.float32),
                    rng.rand(n).astype(np.float32)], -1)
    vals = rng.randn(n, 5).astype(np.float32)
    pmask = np.ones(n, bool)
    pmask[::3] = False
    queries = pts + rng.randn(n, 3).astype(np.float32) * 1e-3
    qmask = np.ones(n, bool)
    qmask[:100] = False

    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals),
        jnp.asarray(pmask), jnp.asarray(qmask),
        block=256, window_blocks=2,
        rescue=2048)
    got, exact = np.asarray(got), np.asarray(exact)
    assert not exact[:100].any()  # masked queries stay unexact
    assert exact[100:].all()

    d = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    d[:, ~pmask] = np.inf
    want = vals[d.argmin(1)]
    np.testing.assert_allclose(got[100:], want[100:], rtol=1e-4, atol=1e-6)


def test_nn1_gather_xwindow_escalate_moving_edge():
    """Escalation tier: a displaced subpopulation (the engine's moving-edge
    failure mode — warped vertices jump several window-widths in rank) makes
    base windows fail; the 4x escalate window certifies them EXACTLY, with
    no brute tier at all."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(3)
    base = np.sort(rng.rand(4000).astype(np.float32)) * 2.0
    pts = np.stack(
        [base, np.cos(base * 7) * 0.4 + 1.0, np.sin(base * 7) * 0.4 + 1.0],
        -1).astype(np.float32)
    # displace a contiguous surface region by ~25 block-widths of x
    moved = pts.copy()
    moved[1200:1900, 0] += 0.025
    queries = moved + rng.randn(4000, 3).astype(np.float32) * 0.003
    vals = np.concatenate([moved, moved * 2], 1).astype(np.float32)

    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(moved), jnp.asarray(vals),
        block=128, window_blocks=3, escalate=2048, escalate_factor=8,
        rescue=0)
    got, exact = np.asarray(got), np.asarray(exact)
    assert exact.all()
    d = ((queries[:, None].astype(np.float64)
          - moved[None].astype(np.float64)) ** 2).sum(-1)
    dg = ((queries - got[:, :3]).astype(np.float64) ** 2).sum(1)
    assert (dg <= d.min(1) + 1e-7).all()


def test_nn1_gather_xwindow_shuffled_points_rescued():
    """FULLY shuffled points (the internal sort restores order) with masked
    entries: escalate + rescue deliver the exact NN for every query."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(9)
    pts = rng.rand(2000, 3).astype(np.float32)
    pts = pts[rng.permutation(2000)]
    queries = rng.rand(1000, 3).astype(np.float32)
    pmask = np.ones(2000, bool)
    pmask[::5] = False

    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), None, jnp.asarray(pmask),
        block=256, escalate=1024, rescue=1024)
    got, exact = np.asarray(got), np.asarray(exact)
    assert exact.all()
    d = ((queries[:, None].astype(np.float64)
          - pts[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~pmask] = np.inf
    dg = ((queries - got).astype(np.float64) ** 2).sum(1)
    assert (dg <= d.min(1) + 1e-7).all()


def test_nn1_gather_xwindow_query_mask_and_drop_count():
    """Masked queries are never exact; rescue capacity bounds how many
    failures get repaired."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(21)
    pts = rng.rand(1024, 3).astype(np.float32)
    queries = rng.rand(1024, 3).astype(np.float32)
    qmask = np.ones(1024, bool)
    qmask[:50] = False
    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), None, None,
        jnp.asarray(qmask), block=256, window_blocks=1, rescue=64)
    exact = np.asarray(exact)
    assert not exact[:50].any()
    # rescue=64 can't fix everything a 1-block window misses on a random
    # 3D cloud: some drops may remain, but at least the rescued are exact
    assert exact.sum() >= 64


def test_nn1_gather_xwindow_presorted_near_order():
    """presorted=True skips the internal sort; on NEARLY x-ordered points
    (marching-cubes emission order perturbed by a smooth warp) the
    order-free certificate + tiers still deliver the exact NN everywhere,
    with values fetched in the ORIGINAL point order."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(3)
    # voxel-granular x-major order with intra-voxel disorder + smooth drift
    base = np.sort(rng.rand(2048).astype(np.float32))
    x = base + 0.01 * rng.randn(2048).astype(np.float32)
    pts = np.stack([x, rng.rand(2048).astype(np.float32),
                    rng.rand(2048).astype(np.float32)], 1)
    vals = rng.rand(2048, 5).astype(np.float32)
    pmask = np.ones(2048, bool)
    pmask[::7] = False
    queries = (pts + 0.003 * rng.randn(2048, 3).astype(np.float32))[
        rng.permutation(2048)][:1500]

    got, exact = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(vals),
        jnp.asarray(pmask), block=256, escalate=1024, rescue=1024,
        presorted=True)
    got, exact = np.asarray(got), np.asarray(exact)
    assert exact.all()
    d = ((queries[:, None].astype(np.float64)
          - pts[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~pmask] = np.inf
    np.testing.assert_allclose(got, vals[d.argmin(1)], rtol=0, atol=1e-6)


def test_nn1_gather_xwindow_presorted_matches_sorted_path():
    """On already-x-sorted points the presorted and sorting paths agree
    exactly (coordinates fetch, no tiers needed)."""
    import jax.numpy as jnp

    from dynfu_tpu.ops import knn

    rng = np.random.RandomState(11)
    pts = rng.rand(1024, 3).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    queries = pts + 0.002 * rng.randn(1024, 3).astype(np.float32)

    a, ea = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), None, None, block=128,
        escalate=512, rescue=512)
    b, eb = knn.nn1_gather_xwindow(
        jnp.asarray(queries), jnp.asarray(pts), None, None, block=128,
        escalate=512, rescue=512, presorted=True)
    assert np.asarray(ea).all() and np.asarray(eb).all()
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_knn_gather_duplicate_points_tie_order():
    """Exact duplicates: ties resolve to the LOWER index (nanoflann order),
    and the fetched features follow the chosen indices."""
    p = np.array([[0.5, 0, 0]] * 4 + [[2.0, 0, 0]] * 4, np.float32)
    q = np.zeros((3, 3), np.float32)
    t = np.arange(8, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
    idx, _, feats = knn.knn_gather(q, p, 4, t, None)
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.tile([0, 1, 2, 3], (3, 1)))
    np.testing.assert_array_equal(np.asarray(feats)[..., 0],
                                  np.tile([0.0, 1, 2, 3], (3, 1)))


def test_knn_gather_fewer_valid_nodes_than_k():
    """With fewer than k valid nodes the valid ones come back first, each
    exactly once, at their float64 distances and features; the remaining
    slots carry an infinite distance, so the warp's Gaussian weight for
    them is exactly zero."""
    from dynfu_tpu.utils import reference

    rng = np.random.RandomState(17)
    D, Q, k = 8, 140, 8
    pts = rng.rand(D, 3).astype(np.float32)
    mask = np.array([True, True, True] + [False] * 5)
    table = rng.rand(D, 5).astype(np.float32)
    queries = rng.rand(Q, 3).astype(np.float32)

    idx, sqd, feats = knn.knn_gather(queries, pts, k, table, mask)
    idx, sqd, feats = np.asarray(idx), np.asarray(sqd), np.asarray(feats)
    want_i, want_d = reference.knn(queries, pts, 3, mask)
    np.testing.assert_array_equal(idx[:, :3], want_i)
    np.testing.assert_allclose(sqd[:, :3], want_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(feats[:, :3], table[want_i])
    assert np.isinf(sqd[:, 3:]).all()


@pytest.mark.parametrize("window_blocks", [1, 3])
def test_window_sweep_matches_brute_force_1nn(window_blocks):
    """`_window_sweep` (the XLA correspondence sweep): every query it
    certifies exact gets the true 1-NN (float64 brute force), and its
    payload fetch returns that point's values exactly."""
    import jax.numpy as jnp

    rng = np.random.RandomState(31 + window_blocks)
    P, Q, block = 2048, 1792, 256
    base = np.sort(rng.rand(P).astype(np.float32)) * 2.0
    pts = np.stack([base, np.cos(base * 5) * 0.3, np.sin(base * 5) * 0.3],
                   -1).astype(np.float32)
    queries = pts[:Q] + rng.randn(Q, 3).astype(np.float32) * 0.002
    vals = rng.randn(P, 4).astype(np.float32)
    pre, suf = knn._window_bounds(jnp.asarray(pts), block)
    npb, nqb = P // block, Q // block
    lo = np.clip(np.arange(nqb) - (window_blocks - 1) // 2, 0,
                 npb - window_blocks).astype(np.int32)
    got, exact = knn._window_sweep(jnp.asarray(queries), jnp.asarray(pts),
                                   jnp.asarray(vals), jnp.asarray(lo), pre,
                                   suf, block, window_blocks)
    got, exact = np.asarray(got), np.asarray(exact)
    assert exact.mean() > 0.5
    d = ((queries[:, None].astype(np.float64)
          - pts[None].astype(np.float64)) ** 2).sum(-1)
    nn = d.argmin(1)
    np.testing.assert_array_equal(got[exact], vals[nn[exact]])
