"""Projective ICP: pose recovery on synthetic height-field frames and the
degenerate-plane failure guard."""

import numpy as np

import jax.numpy as jnp

from dynfu_tpu.core import se3
from dynfu_tpu.core.camera import Intr
from dynfu_tpu.ops import imgproc
from dynfu_tpu.rigid import icp

INTR = Intr(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160


def heightfield_depth():
    """A wavy surface ~1.5 m away — constrains all 6 DOF."""
    u = np.arange(W)[None, :]
    v = np.arange(H)[:, None]
    z = 1.5 + 0.08 * np.sin(u / 12.0) + 0.06 * np.cos(v / 9.0) + 0.02 * np.sin(
        (u + v) / 7.0
    )
    return (z * 1000).astype(np.int32)


def make_frame(depth_mm):
    return imgproc.compute_points_normals(jnp.asarray(depth_mm), INTR)


def apply_inv_transform(points, normals, R, t):
    """View the same surface from a camera moved by (R, t): in the new frame
    the points are T^-1 * p."""
    Rinv = R.T
    p = np.asarray(points)
    n = np.asarray(normals)
    sh = p.shape
    p2 = (p.reshape(-1, 3) - t) @ Rinv.T
    n2 = n.reshape(-1, 3) @ Rinv.T
    return (
        jnp.asarray(p2.reshape(sh), jnp.float32),
        jnp.asarray(n2.reshape(sh), jnp.float32),
    )


def run_icp(R_true, t_true, iters=(10, 5, 4, 0)):
    prev_p, prev_n = make_frame(heightfield_depth())
    curr_p, curr_n = apply_inv_transform(prev_p, prev_n, R_true, t_true)
    prev_pyr = icp.build_pyramids(prev_p, prev_n, len(iters))
    curr_pyr = icp.build_pyramids(curr_p, curr_n, len(iters))
    (R, t), ok = icp.estimate_transform(curr_pyr, prev_pyr, INTR, iters=iters)
    return np.asarray(R), np.asarray(t), bool(ok)


def test_identity_stays_identity():
    R, t, ok = run_icp(np.eye(3), np.zeros(3))
    assert ok
    np.testing.assert_allclose(R, np.eye(3), atol=5e-4)
    np.testing.assert_allclose(t, 0.0, atol=5e-4)


def test_recovers_small_translation():
    t_true = np.array([0.01, -0.008, 0.012], np.float32)
    R, t, ok = run_icp(np.eye(3), t_true)
    assert ok
    np.testing.assert_allclose(t, t_true, atol=1.5e-3)
    np.testing.assert_allclose(R, np.eye(3), atol=1e-3)


def test_recovers_small_rotation_and_translation():
    rvec = np.array([0.01, -0.015, 0.02], np.float32)
    R_true, _ = se3.from_rodrigues(jnp.asarray(rvec), jnp.zeros(3))
    R_true = np.asarray(R_true)
    t_true = np.array([-0.005, 0.01, 0.008], np.float32)
    R, t, ok = run_icp(R_true, t_true)
    assert ok
    np.testing.assert_allclose(R, R_true, atol=2e-3)
    np.testing.assert_allclose(t, t_true, atol=3e-3)


def test_degenerate_plane_raises_flag():
    """A fronto-parallel plane constrains only 3 DOF: det(A) collapses and
    the reference would abort + reset (projective_icp.cpp:181-191)."""
    depth = np.full((H, W), 1500, np.int32)
    p, n = make_frame(depth)
    pyr = icp.build_pyramids(p, n, 4)
    (_, _), ok = icp.estimate_transform(pyr, pyr, INTR)
    # perfectly flat + perfectly aligned -> b = 0; either the det guard fires
    # or the solve returns ~0. Inject a slight perturbation to force the
    # singular path to matter:
    p2, n2 = apply_inv_transform(p, n, np.eye(3), np.array([0.0, 0.0, 0.01]))
    pyr2 = icp.build_pyramids(p2, n2, 4)
    (R, t), ok2 = icp.estimate_transform(pyr2, pyr, INTR)
    if bool(ok2):
        # if the system stayed numerically non-singular, z must be recovered
        assert abs(float(t[2]) - 0.01) < 2e-3
    assert np.isfinite(np.asarray(t)).all()


def test_stencil_association_matches_gather():
    """The stencil-select fast path (shifted selects instead of element
    gathers) recovers the same pose as the exact gather
    variant whenever the flow fits the window — the converged regime every
    real frame ends in."""
    rvec = np.array([0.008, -0.012, 0.015], np.float32)
    R_true, _ = se3.from_rodrigues(jnp.asarray(rvec), jnp.zeros(3))
    R_true = np.asarray(R_true)
    t_true = np.array([0.008, -0.006, 0.01], np.float32)

    prev_p, prev_n = make_frame(heightfield_depth())
    curr_p, curr_n = apply_inv_transform(prev_p, prev_n, R_true, t_true)
    iters = (10, 5, 4, 0)
    prev_pyr = icp.build_pyramids(prev_p, prev_n, len(iters))
    curr_pyr = icp.build_pyramids(curr_p, curr_n, len(iters))

    (Rg, tg), okg = icp.estimate_transform(curr_pyr, prev_pyr, INTR,
                                           iters=iters)
    (Rs, ts), oks = icp.estimate_transform_stencil(curr_pyr, prev_pyr, INTR,
                                                   iters=iters)
    assert okg and oks
    np.testing.assert_allclose(np.asarray(Rs), R_true, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ts), t_true, atol=3e-3)
    # and close to the gather solution itself
    np.testing.assert_allclose(np.asarray(Rs), np.asarray(Rg), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ts), np.asarray(tg), atol=1.5e-3)


def test_stencil_fetch_matches_indexing():
    """_fetch_stencil == img[vi, ui] wherever the flow fits the radius,
    NaN outside."""
    rng = np.random.RandomState(4)
    img = rng.randn(24, 32, 3).astype(np.float32)
    ys, xs = np.mgrid[0:24, 0:32]
    vi = np.clip(ys + rng.randint(-4, 5, ys.shape), 0, 23).astype(np.int32)
    ui = np.clip(xs + rng.randint(-4, 5, xs.shape), 0, 31).astype(np.int32)
    out = np.asarray(icp._fetch_stencil(
        jnp.asarray(img), jnp.asarray(vi), jnp.asarray(ui), 3))
    inside = (np.abs(vi - ys) <= 3) & (np.abs(ui - xs) <= 3)
    np.testing.assert_array_equal(out[inside], img[vi, ui][inside])
    assert np.isnan(out[~inside]).all()
