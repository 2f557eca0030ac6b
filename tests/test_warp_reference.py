"""The warp field's XLA paths against the float64 numpy blend
(dynfu_tpu/utils/reference.py): both blend semantics, the normal quirks,
far points and the unsupported ratio."""

import numpy as np
import jax.numpy as jnp
import pytest

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.utils import reference
from dynfu_tpu.warp import field as wfield


def _field(rng, n=12, cap=16):
    nodes = (rng.rand(n, 3).astype(np.float32) - 0.5) * 0.6
    wf = wfield.init_warpfield(
        nodes, weights=rng.uniform(0.1, 0.4, n).astype(np.float32),
        capacity=cap)
    # non-trivial node transforms: small rotations + translations
    rod = jnp.asarray(rng.randn(cap, 3).astype(np.float32) * 0.05)
    t = jnp.asarray(rng.randn(cap, 3).astype(np.float32) * 0.01)
    dqs = dq.dq_from_rodrigues(rod, t)
    return wf._replace(dqs=jnp.where(wf.mask[:, None], dqs, wf.dqs))


def _warp(wf, pts, nrm, blend):
    fn = {"dqb": wfield.warp_points_normals,
          "dlb": wfield.warp_points_normals_dlb}[blend]
    got_p, got_n = fn(wf, jnp.asarray(pts), jnp.asarray(nrm))
    want_p, want_n = reference.warp(pts, nrm, wf.pos, wf.dqs, wf.w, wf.mask,
                                    k=wfield.KNN, blend=blend)
    return (np.asarray(got_p), np.asarray(got_n)), (want_p, want_n)


@pytest.mark.parametrize("blend", ["dqb", "dlb"])
def test_warp_matches_float64_blend(blend):
    rng = np.random.RandomState(3 if blend == "dqb" else 11)
    wf = _field(rng)
    pts = (rng.rand(300, 3).astype(np.float32) - 0.5) * 0.6
    nrm = rng.randn(300, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    (got_p, got_n), (want_p, want_n) = _warp(wf, pts, nrm, blend)
    np.testing.assert_allclose(got_p, want_p, atol=2e-5)
    np.testing.assert_allclose(got_n, want_n, atol=2e-5)


@pytest.mark.parametrize("blend", ["dqb", "dlb"])
def test_warp_far_points_are_identity(blend):
    """Queries out of every node's reach see zero Gaussian weights: both
    blends warp them (and their normals) by identity up to the nodes'
    rotation quirk — exactly as the float64 blend does."""
    rng = np.random.RandomState(7)
    wf = _field(rng, n=6)
    far = np.full((130, 3), 30.0, np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (130, 1)).astype(np.float32)
    (got_p, got_n), (want_p, want_n) = _warp(wf, far, nrm, blend)
    np.testing.assert_allclose(got_p, want_p, atol=1e-4)
    np.testing.assert_allclose(got_n, want_n, atol=1e-5)
    if blend == "dlb":
        np.testing.assert_allclose(got_p, far, atol=1e-4)


def test_unsupported_mask_matches_float64_ratio():
    """unsupported_mask == (min over the 8-NN of dist / dg_w >= 1) in
    float64, including masked-out query points."""
    rng = np.random.RandomState(13)
    wf = _field(rng)
    pts = (rng.rand(400, 3).astype(np.float32) - 0.5) * 1.2
    pmask = rng.rand(400) < 0.8
    got = np.asarray(wfield.unsupported_mask(wf, jnp.asarray(pts),
                                             jnp.asarray(pmask)))
    idx, sqd = reference.knn(pts, wf.pos, wfield.KNN, wf.mask)
    ratio = np.sqrt(sqd) / np.asarray(wf.w, np.float64)[idx]
    want = (ratio.min(axis=1) >= 1.0) & pmask
    np.testing.assert_array_equal(got, want)
