"""Warp-solve parity tests, ported from the reference's Opt integration suite
(test/opt_optimisation_test.cpp, 7 live tests, tolerance 1e-3).

Each scenario builds the same synthetic node groups and vertex sets as the
reference fixture, runs the GN solve, and asserts that every source vertex —
warped through warpfield DQB exactly like the reference's post-solve check
(calcDQB(v)->transformVertex(v)) — lands on its live target within 1e-3.

The fixture's solver settings (opt_optimisation_test.cpp:36-44): LM with
earlyOut, 16 nonlinear / 256 linear iterations, lambda = 0 (pure data term).
"""

import numpy as np
import pytest

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.solver import gn
from dynfu_tpu.warp import field as wfield

MAX_ERROR = 1e-3
EPSILON_DYNFU = 0.0015
TUKEY_OFFSET = 4.652
PSI_DATA = 1e-2
LAMBDA = 0.0
PSI_REG = 1e-4
DG_W = 2.0

GROUP1 = np.array(
    [
        [3, 1, -1], [1, 1, 1], [-1, 2, 3], [-1, -1, 1],
        [-2, -1, -1], [2, -1, -3], [-1, 1, -1], [2, 1, 1],
    ],
    np.float32,
)

GROUP2 = np.array(
    [
        [10, 10, 10], [9, 11.1, 10], [10, 9, 10], [10, 12, 9], [9, 11, 10],
        [12, 10, 9], [9, 9, 12], [10.5, 9, 9], [10.5, 12, 12], [11, 11, 10.9],
    ],
    np.float32,
)

ALL_NODES = np.concatenate([GROUP1, GROUP2], axis=0)


def make_wf(nodes):
    return wfield.init_warpfield(nodes, weights=DG_W)


def run_solve(wf, source, target, **over):
    # the reference fixture's full schedule (opt_optimisation_test.cpp:36-44
    # / dyn_fusion.cpp:183-189): 24 outer / 16 nonlinear / 256 linear,
    # earlyOut
    kw = dict(
        tukey_offset=TUKEY_OFFSET, psi_data=PSI_DATA, lambda_reg=LAMBDA,
        psi_reg=PSI_REG, linear_iter=256, nonlinear_iter=16, num_iter=24,
        early_out=True,
    )
    kw.update(over)
    wf2, stats = gn.solve(
        wf,
        np.asarray(source, np.float32),
        np.asarray(target, np.float32),
        **kw,
    )
    return wf2, stats


def assert_warp_matches(wf, vertices, targets, tol=MAX_ERROR):
    blend = wfield.calc_dqb(wf, np.asarray(vertices, np.float32))
    warped = dq.dq_transform_point(blend, np.asarray(vertices, np.float32))
    np.testing.assert_allclose(np.asarray(warped), np.asarray(targets, np.float32), atol=tol)


def test_single_vertex_one_group():
    # opt_optimisation_test.cpp:212-240
    wf = make_wf(GROUP1)
    src = [[0, 0.04, 0]]
    tgt = [[0.01, 0.03, 0]]
    wf, _ = run_solve(wf, src, tgt)
    assert_warp_matches(wf, src, tgt)


def test_two_vertices_one_static():
    # opt_optimisation_test.cpp:243-277
    wf = make_wf(ALL_NODES)
    src = [[0, 0.05, 1], [2, 2, 2]]
    tgt = [[0.01, 0.04, 1.01], [2, 2, 2]]
    wf, _ = run_solve(wf, src, tgt)
    assert_warp_matches(wf, src, tgt)


SRC5 = [[-3, -3, -3], [-2, -2, -2], [0.01, 0.01, 0.01], [2, 2, 2], [3, 3, 3]]
TGT5 = [[-2.99, -2.99, -2.99], [-1.99, -1.99, -1.99], [0.02, 0.02, 0.02],
        [2.01, 2.01, 2.01], [3.01, 3.01, 3.01]]


def test_multiple_vertices_one_group():
    # opt_optimisation_test.cpp:280-326
    wf = make_wf(GROUP1)
    wf, _ = run_solve(wf, SRC5, TGT5)
    assert_warp_matches(wf, SRC5, TGT5)


def test_one_group_vertices_two_groups_nodes():
    # opt_optimisation_test.cpp:329-375
    wf = make_wf(ALL_NODES)
    wf, _ = run_solve(wf, SRC5, TGT5)
    assert_warp_matches(wf, SRC5, TGT5)


def test_two_groups_vertices_two_groups_nodes():
    # opt_optimisation_test.cpp:378-452
    wf = make_wf(ALL_NODES)
    src = SRC5 + [[12, 12, 12], [11, 11, 11], [10, 10, 10], [10.5, 10.5, 10.5], [11.5, 11.5, 11.5]]
    tgt = TGT5 + [[11.99, 11.99, 11.99], [10.99, 10.99, 10.99], [9.99, 9.99, 9.99],
                  [10.51, 10.51, 10.51], [11.49, 11.49, 11.49]]
    wf, _ = run_solve(wf, src, tgt)
    assert_warp_matches(wf, src, tgt)


SRC5B = [[-3, -3, -3], [-2, -2, -2], [0.04, 0.04, 0.04], [2, 2, 2], [3, 3, 3]]
TGT5B = [[-2.99, -2.99, -2.99], [-1.99, -1.99, -1.99], [0.05, 0.05, 0.05],
         [2.01, 2.01, 2.01], [3.01, 3.01, 3.01]]
TGT5C = [[-2.98, -2.98, -2.98], [-1.98, -1.98, -1.98], [0.06, 0.06, 0.06],
         [2.02, 2.02, 2.02], [3.02, 3.02, 3.02]]


def test_warp_twice_sequential():
    # opt_optimisation_test.cpp:454-528: solve, re-warp canonical, solve again;
    # final check warps the ORIGINAL canonical vertices through the composed field.
    wf = make_wf(GROUP1)
    wf, _ = run_solve(wf, SRC5B, TGT5B)
    assert_warp_matches(wf, SRC5B, TGT5B)

    blend = wfield.calc_dqb(wf, np.asarray(SRC5B, np.float32))
    warped1 = np.asarray(dq.dq_transform_point(blend, np.asarray(SRC5B, np.float32)))

    wf, _ = run_solve(wf, warped1, TGT5C)
    assert_warp_matches(wf, SRC5B, TGT5C)


def test_warp_thrice_sequential():
    # opt_optimisation_test.cpp:530-630
    wf = make_wf(GROUP1)
    wf, _ = run_solve(wf, SRC5B, TGT5B)
    assert_warp_matches(wf, SRC5B, TGT5B)

    blend = wfield.calc_dqb(wf, np.asarray(SRC5B, np.float32))
    warped1 = np.asarray(dq.dq_transform_point(blend, np.asarray(SRC5B, np.float32)))
    wf, _ = run_solve(wf, warped1, TGT5C)
    assert_warp_matches(wf, SRC5B, TGT5C)

    blend = wfield.calc_dqb(wf, np.asarray(warped1, np.float32))
    warped2 = np.asarray(dq.dq_transform_point(blend, np.asarray(warped1, np.float32)))
    tgt3 = [[-2.96, -2.96, -2.96], [-1.96, -1.96, -1.96], [0.09, 0.09, 0.09],
            [2.04, 2.04, 2.04], [3.05, 3.05, 3.05]]
    wf, _ = run_solve(wf, warped2, tgt3)
    # reference checks warped1 (canonicalFrameWarpedToLive) against tgt3
    assert_warp_matches(wf, warped1, tgt3)


def test_warp_and_reverse():
    # opt_optimisation_test.cpp:632-698: forward solve then reverse solve;
    # the reverse check asserts live vertices map to themselves (fixed point).
    wf = make_wf(GROUP1)
    wf, _ = run_solve(wf, SRC5B, TGT5B)
    assert_warp_matches(wf, SRC5B, TGT5B)

    wf, _ = run_solve(wf, TGT5B, SRC5B)
    assert_warp_matches(wf, SRC5B, SRC5B)


def test_solver_cost_decreases():
    wf = make_wf(GROUP1)
    _, stats = run_solve(wf, SRC5B, TGT5B)
    assert float(stats.final_cost) <= float(stats.initial_cost)
    assert float(stats.final_cost) < 1e-8


def test_solve_with_padded_capacity():
    """New-framework property: solving with capacity padding (mask discipline)
    must give identical results to the tight layout."""
    wf_tight = make_wf(GROUP1)
    wf_pad = wfield.init_warpfield(GROUP1, weights=DG_W, capacity=64)
    a, _ = run_solve(wf_tight, SRC5B, TGT5B)
    b, _ = run_solve(wf_pad, SRC5B, TGT5B)
    va = np.asarray(dq.dq_transform_point(wfield.calc_dqb(a, np.asarray(SRC5B, np.float32)),
                                          np.asarray(SRC5B, np.float32)))
    vb = np.asarray(dq.dq_transform_point(wfield.calc_dqb(b, np.asarray(SRC5B, np.float32)),
                                          np.asarray(SRC5B, np.float32)))
    np.testing.assert_allclose(va, vb, atol=1e-5)


def test_outer_reweighting_downweights_outliers():
    """Outer iterations without earlyOut (Opt's never-exercised full outer
    schedule, preNonlinearSolve re-weighting) must not be worse than the
    earlyOut single pass, and should recover the inlier motion despite
    corrupted targets."""
    wf = make_wf(GROUP1)
    src = np.asarray(SRC5B, np.float32)
    tgt = np.asarray(TGT5B, np.float32).copy()
    tgt_bad = tgt.copy()
    tgt_bad[2] += 0.5  # gross outlier, far beyond the tukey cutoff

    wf1, _ = gn.solve(wf, src, tgt_bad, tukey_offset=TUKEY_OFFSET,
                      psi_data=PSI_DATA, lambda_reg=0.0,
                      num_iter=1, early_out=True)
    wf4, _ = gn.solve(wf, src, tgt_bad, tukey_offset=TUKEY_OFFSET,
                      psi_data=PSI_DATA, lambda_reg=0.0,
                      num_iter=4, early_out=False)

    def err(w):
        blend = wfield.calc_dqb(w, src)
        warped = np.asarray(dq.dq_transform_point(blend, src))
        keep = [0, 1, 3, 4]  # inliers
        return np.abs(warped[keep] - tgt[keep]).max()

    assert err(wf4) <= err(wf1) + 1e-6
    assert err(wf4) < 2e-3


def test_full_schedule_matches_earlyout_on_linear_energy():
    """The energy is linear in the translations, so the 16 frozen-weight
    inner relinearizations (and, on a clean fixture, the extra outer
    iterations) must leave the answer unchanged — the property that makes
    the reference's earlyOut break lossless."""
    wf0 = make_wf(GROUP1)
    a, _ = run_solve(wf0, SRC5B, TGT5B, nonlinear_iter=1, num_iter=1)
    b, _ = run_solve(wf0, SRC5B, TGT5B, nonlinear_iter=16, num_iter=24,
                     early_out=True)
    c, _ = run_solve(wf0, SRC5B, TGT5B, nonlinear_iter=16, num_iter=3,
                     early_out=False)
    src = np.asarray(SRC5B, np.float32)

    def warped(w):
        return np.asarray(dq.dq_transform_point(wfield.calc_dqb(w, src), src))

    np.testing.assert_allclose(warped(a), warped(b), atol=1e-5)
    np.testing.assert_allclose(warped(b), np.asarray(TGT5B, np.float32),
                               atol=MAX_ERROR)
    np.testing.assert_allclose(warped(c), np.asarray(TGT5B, np.float32),
                               atol=MAX_ERROR)


def test_huber_weights_computed_on_schedule():
    """updateHuberWeights parity: identity warp state -> zero node-pair
    disagreement -> all Huber weights 1 (opt_solver.cpp:233-245); stats
    must report them (the reference uploads them to Opt each
    preNonlinearSolve even though no energy term reads them)."""
    wf = make_wf(GROUP1)
    reg_idx, _ = wfield.find_neighbors(wf, wf.pos, 8)
    hw = np.asarray(gn.huber_weights(wf, reg_idx, PSI_REG))
    np.testing.assert_allclose(hw[: len(GROUP1)], 1.0, atol=1e-6)

    _, stats = run_solve(wf, SRC5B, TGT5B)
    assert float(stats.mean_huber) == pytest.approx(1.0, abs=1e-6)

    # after a real deformation the node transforms disagree: weights < 1
    wf2, _ = run_solve(wf, SRC5B, TGT5B)
    reg_idx2, _ = wfield.find_neighbors(wf2, wf2.pos, 8)
    hw2 = np.asarray(gn.huber_weights(wf2, reg_idx2, PSI_REG))
    assert hw2[: len(GROUP1)].min() < 1.0


def test_dense_data_normal_matches_float64_assembly():
    """gn._dense_data_normal (chunked one-hot strips, with a chunk tail and
    invalid-slot zeros) equals the float64 sparse assembly."""
    import jax.numpy as jnp

    from dynfu_tpu.solver import gn
    from dynfu_tpu.utils import reference

    rng = np.random.RandomState(42)
    N, K, D = 1000, 8, 192
    idx = rng.randint(0, D, (N, K)).astype(np.int32)
    w = rng.rand(N, K).astype(np.float32)
    w[rng.rand(N, K) < 0.2] = 0.0
    s2 = rng.rand(N).astype(np.float32)
    delta = rng.randn(N, 3).astype(np.float32) * 0.01
    A, b = gn._dense_data_normal(None, jnp.asarray(idx), jnp.asarray(w),
                                 jnp.asarray(s2), jnp.asarray(delta), D,
                                 chunk=256)
    A_r, b_r = reference.data_normal(idx, w, s2, delta, D)
    assert np.linalg.norm(np.asarray(A) - A_r) <= 1e-5 * np.linalg.norm(A_r)
    assert np.linalg.norm(np.asarray(b) - b_r) <= 1e-5 * np.linalg.norm(b_r)


def test_monomial_grams_match_float64_assembly():
    """se3._monomial_grams: all 10 monomial-weighted Grams and both rhs
    sums equal the float64 assembly."""
    import jax.numpy as jnp

    from dynfu_tpu.solver import se3
    from dynfu_tpu.utils import reference

    rng = np.random.RandomState(23)
    N, K, D = 700, 8, 24
    idx = rng.randint(0, D, (N, K)).astype(np.int32)
    w = rng.rand(N, K).astype(np.float32)
    s2 = rng.rand(N).astype(np.float32)
    y = (rng.randn(N, 3) * 0.2).astype(np.float32)
    delta = (rng.randn(N, 3) * 0.01).astype(np.float32)
    got = se3._monomial_grams(jnp.asarray(idx), jnp.asarray(w),
                              jnp.asarray(s2), jnp.asarray(y),
                              jnp.asarray(delta), D, chunk=256)
    want = reference.monomial_grams(idx, w, s2, y, delta, D)
    for g, r in zip(got, want):
        assert np.linalg.norm(np.asarray(g) - r) <= 1e-5 * np.linalg.norm(r)
