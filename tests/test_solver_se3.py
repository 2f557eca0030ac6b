"""SE(3) per-node solver (solver/se3.py): the rotations the reference
declared but never wired (energy.t:30,78). No reference fixtures exist for
rotations — correctness is established against synthetic ground-truth warps
that a translations-only solver cannot represent."""

import numpy as np
import jax.numpy as jnp

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.solver import gn, se3
from dynfu_tpu.warp import field as wfield


def _patch_scene(rng, n_nodes=12, n_verts=400, extent=0.5):
    """A plane-ish patch with nodes sprinkled over it (dg_w wide enough
    that every vertex is supported)."""
    nodes = (rng.rand(n_nodes, 3).astype(np.float32) - 0.5) * extent
    wf = wfield.init_warpfield(nodes, weights=np.full(n_nodes, 0.35,
                                                      np.float32),
                               capacity=16)
    verts = (rng.rand(n_verts, 3).astype(np.float32) - 0.5) * extent
    return wf, jnp.asarray(verts)


def test_se3_recovers_pure_translation():
    rng = np.random.RandomState(5)
    wf, verts = _patch_scene(rng)
    t_true = np.asarray([0.012, -0.007, 0.004], np.float32)
    live = verts + t_true

    wf2, stats = se3.solve(wf, verts, live, relinearize=2,
                           lambda_reg=200.0)
    warped, _ = wfield.warp_points_normals_dlb(wf2, verts, verts)
    err = np.linalg.norm(np.asarray(warped - live), axis=-1)
    assert np.median(err) < 2e-4
    assert float(stats.final_cost) < 1e-2 * float(stats.initial_cost)
    # a pure translation needs no rotation
    assert float(stats.mean_rot_deg) < 1.0


def test_se3_recovers_rotation_where_translations_cannot():
    """A rigid rotation: its DISPLACEMENT field is linear in x, so even a
    translation-only RBF field can fit the positions — but it cannot
    ROTATE anything. The SE(3) solve must (a) fit the positions, (b)
    recover the true per-node rotation angle, and (c) rotate normals
    correctly through the DLB warp — none of which exists in the
    translations-only solver (gn.solve leaves every node rotation at
    identity)."""
    rng = np.random.RandomState(7)
    wf, verts = _patch_scene(rng, n_nodes=10, n_verts=500)
    ang = 0.12  # radians, ~6.9 deg
    c, s = np.cos(ang), np.sin(ang)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    live = jnp.asarray(np.asarray(verts) @ R.T)

    # 6 relinearizations: the rotation-step damping (rot_prior) is pure
    # step damping, so the true rotation converges THROUGH it — each
    # Gauss-Newton step re-aims at the remaining residual
    wf_r, stats = se3.solve(wf, verts, live, relinearize=6,
                            lambda_reg=20.0)
    normals = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (500, 1))
    # rotate a tangent-ish normal set instead so the rotation is visible
    normals = rng.randn(500, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    warped_r, warped_n = wfield.warp_points_normals_dlb(
        wf_r, verts, jnp.asarray(normals))
    err_r = np.median(np.linalg.norm(np.asarray(warped_r - live), -1))
    assert err_r < 1e-4  # 0.015 mm measured
    # recovered node rotations match the true angle
    assert abs(float(stats.mean_rot_deg) - np.degrees(ang)) < 0.5
    # normals rotate by ~R (the translation solver cannot do this at all)
    n_err = np.linalg.norm(np.asarray(warped_n) - normals @ R.T, axis=-1)
    assert np.median(n_err) < 5e-3

    # the translation solver leaves every rotation at identity
    wf_t, _ = gn.solve(wf, verts, live, linear_iter=256)
    real_t = np.asarray(wf_t.dqs)[np.asarray(wf.mask)][:, :4]
    ang_t = 2 * np.degrees(np.arccos(np.clip(
        np.abs(real_t[:, 0]) / np.linalg.norm(real_t, axis=-1), 0, 1)))
    assert (ang_t < 1e-3).all()


def test_se3_inactive_nodes_and_unsupported_verts_untouched():
    rng = np.random.RandomState(11)
    wf, verts = _patch_scene(rng, n_nodes=9)
    far = jnp.asarray(np.full((40, 3), 50.0, np.float32))  # unsupported
    allv = jnp.concatenate([verts, far])
    live = jnp.concatenate([verts + jnp.asarray([0.01, 0, 0]), far])

    wf2, _ = se3.solve(wf, allv, live, relinearize=2)
    # inactive slots keep their identity transform
    inactive = ~np.asarray(wf.mask)
    np.testing.assert_allclose(np.asarray(wf2.dqs)[inactive],
                               np.asarray(wf.dqs)[inactive])
    # the update itself is finite and small
    t = np.asarray(dq.dq_translation(wf2.dqs))[np.asarray(wf.mask)]
    assert np.isfinite(t).all()
    assert (np.linalg.norm(t, axis=-1) < 0.05).all()


def test_se3_vert_mask_excludes_outliers():
    rng = np.random.RandomState(13)
    wf, verts = _patch_scene(rng)
    live = verts + jnp.asarray([0.008, 0.0, 0.0])
    # corrupt half the lives, but mask them out
    bad = np.asarray(live).copy()
    bad[::2] += 5.0
    mask = np.ones(bad.shape[0], bool)
    mask[::2] = False

    wf2, _ = se3.solve(wf, verts, jnp.asarray(bad), jnp.asarray(mask),
                       relinearize=2)
    warped, _ = wfield.warp_points_normals_dlb(wf2, verts, verts)
    err = np.linalg.norm(np.asarray(warped - live), axis=-1)[mask]
    assert np.median(err) < 5e-4


def test_se3_max_update_trust_region_rejects_rogue_steps():
    """max_update (the fusion engine passes fusion_corr_dist): a per-frame
    node step larger than the association gate cannot be data-driven, so
    the solve must REJECT it outright (identity), not scale it — the
    512-cube cascade this pins: an un-gated solve flung a weak-data rim
    node 3.9 m on frame 1 and node insertion then followed the rogue
    warp."""
    rng = np.random.RandomState(7)
    wf, verts = _patch_scene(rng)
    # demand an absurd deformation: targets 2 m away
    live = verts + jnp.asarray([2.0, 0.0, 0.0])

    wf2, _ = se3.solve(wf, verts, live, relinearize=2,
                       max_update=0.1)
    act = np.asarray(wf.mask)
    moved = np.asarray(dq.dq_transform_point(wf2.dqs, wf.pos) - wf.pos)[act]
    # every node's own displacement stays inside the trust region; with
    # the whole data term demanding 2 m, the rejected nodes sit at identity
    assert (np.linalg.norm(moved, axis=-1) <= 0.1 + 1e-6).all()
    # real (small) motion still passes through the same gate
    live_ok = verts + jnp.asarray([0.008, 0.0, 0.0])
    wf3, _ = se3.solve(wf, verts, live_ok, relinearize=2, max_update=0.1)
    warped, _ = wfield.warp_points_normals_dlb(wf3, verts, verts)
    err = np.linalg.norm(np.asarray(warped - live_ok), axis=-1)
    assert np.median(err) < 5e-4


def test_gn_max_update_trust_region_rejects_rogue_steps():
    rng = np.random.RandomState(8)
    wf, verts = _patch_scene(rng)
    live = verts + jnp.asarray([2.0, 0.0, 0.0])
    wf2, _ = gn.solve(wf, verts, live, max_update=0.1)
    t = np.asarray(dq.dq_translation(wf2.dqs))[np.asarray(wf.mask)]
    assert (np.linalg.norm(t, axis=-1) <= 0.1 + 1e-6).all()
    live_ok = verts + jnp.asarray([0.006, 0.0, 0.0])
    wf3, _ = gn.solve(wf, verts, live_ok, max_update=0.1)
    warped, _ = wfield.warp_points_normals(wf3, verts, verts)
    err = np.linalg.norm(np.asarray(warped - live_ok), axis=-1)
    assert np.median(err) < 5e-4


def test_se3_similarity_reg_frees_the_coherent_scale_mode():
    """similarity_reg (solver/se3.py _assemble_reg): marginalizing the
    global uniform-scale mode out of the reg quadratic. With node
    transforms carrying EXACTLY a uniform expansion (t_k = sigma p_k
    about the origin), the inter-node reg residual is r_kj = sigma
    (p_k - p_j) — entirely inside the marginalized mode — so the
    similarity assembly's rhs pull must vanish (the reg stops fighting
    the expansion) while the plain ARAP assembly pulls hard against it.
    A pure-translation field (zero reg residual) is untouched by the
    downdate, and the downdated matrix stays PSD."""
    rng = np.random.RandomState(11)
    D, K = 16, 4
    pos = rng.randn(D, 3).astype(np.float32) * 0.3
    sigma = 0.05
    # node DQs = pure translations t_k = sigma * p_k (expansion about 0)
    dqs = np.zeros((D, 8), np.float32)
    dqs[:, 0] = 1.0
    dqs[:, 5:8] = 0.5 * sigma * pos  # dual part of Trans(t): (0, t/2)
    wf = wfield.WarpField(
        pos=jnp.asarray(pos), dqs=jnp.asarray(dqs),
        w=jnp.full(D, 0.2, jnp.float32), mask=jnp.ones(D, bool),
        count=jnp.asarray(D, jnp.int32))
    reg_idx = jnp.asarray(rng.randint(0, D, (D, K)).astype(np.int32))
    em = jnp.ones((D, K), jnp.float32)

    A_p, b_p, _ = se3._assemble_reg(wf, reg_idx, em, 1.0, D)
    A_s, b_s, _ = se3._assemble_reg(wf, reg_idx, em, 1.0, D,
                                    similarity=True)
    # plain reg pulls against the expansion; similarity pull vanishes
    nb_p = float(np.linalg.norm(np.asarray(b_p)))
    nb_s = float(np.linalg.norm(np.asarray(b_s)))
    assert nb_p > 1e-3, nb_p
    assert nb_s < 1e-5 * max(nb_p, 1.0), (nb_s, nb_p)
    # downdated matrix stays PSD (exact Schur complement of a PSD system)
    w_eig = np.linalg.eigvalsh(np.asarray(A_s).reshape(D * 6, D * 6))
    assert w_eig.min() > -1e-4, w_eig.min()

    # end-to-end control: a pure translation solves as accurately with
    # the flag as without (no scale content to free)
    d = rng.randn(24, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wf2 = wfield.init_warpfield(0.3 * d,
                                weights=np.full(24, 0.3, np.float32),
                                capacity=32)
    vd = rng.randn(400, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    verts = jnp.asarray(0.3 * vd)
    live_t = verts + np.asarray([0.01, -0.004, 0.006], np.float32)
    wf3, _ = se3.solve(wf2, verts, live_t, relinearize=2,
                       lambda_reg=200.0, similarity_reg=True)
    warped_t, _ = wfield.warp_points_normals_dlb(wf3, verts, verts)
    err_t = np.median(np.linalg.norm(np.asarray(warped_t - live_t),
                                     axis=-1))
    assert err_t < 5e-4, err_t


def test_se3_similarity_reg_is_per_component():
    """similarity=True marginalizes one scale mode PER CONNECTED COMPONENT
    of the reg graph (solver/se3.py _assemble_reg). Scene shape that broke
    the global formulation (measured: bit-identical moving-camera error
    with/without the flag): a deforming object plus static background. Two
    disjoint node clusters — one carrying exactly a uniform expansion
    about its own center, one static. The reg's rhs pull on the expanding
    cluster must vanish (its scale mode rides free) while staying zero on
    the static cluster; a graph-wide single mode cannot achieve this
    because the static cluster anchors the global direction."""
    rng = np.random.RandomState(7)
    Da, Db = 10, 10
    D = Da + Db
    pos_a = rng.randn(Da, 3).astype(np.float32) * 0.2  # expanding cluster
    pos_b = rng.randn(Db, 3).astype(np.float32) * 0.2 + np.asarray(
        [3.0, 0.0, 0.0], np.float32)  # static cluster, far away
    pos = np.concatenate([pos_a, pos_b])
    sigma = 0.06
    ca = pos_a.mean(0)
    dqs = np.zeros((D, 8), np.float32)
    dqs[:, 0] = 1.0
    dqs[:Da, 5:8] = 0.5 * sigma * (pos_a - ca)  # Trans(sigma (p - ca))
    wf = wfield.WarpField(
        pos=jnp.asarray(pos), dqs=jnp.asarray(dqs),
        w=jnp.full(D, 0.2, jnp.float32), mask=jnp.ones(D, bool),
        count=jnp.asarray(D, jnp.int32))
    # K-NN edges stay inside each cluster (clusters 3 m apart)
    K = 4
    reg_idx = np.zeros((D, K), np.int32)
    for i in range(D):
        lo, hi = (0, Da) if i < Da else (Da, D)
        d2 = np.linalg.norm(pos[lo:hi] - pos[i], axis=1)
        d2[i - lo] = np.inf
        reg_idx[i] = lo + np.argsort(d2)[:K]
    reg_idx = jnp.asarray(reg_idx)
    em = jnp.ones((D, K), jnp.float32)

    A_p, b_p, _ = se3._assemble_reg(wf, reg_idx, em, 1.0, D)
    A_s, b_s, _ = se3._assemble_reg(wf, reg_idx, em, 1.0, D,
                                    similarity=True)
    nb_p = float(np.linalg.norm(np.asarray(b_p)))
    nb_s = float(np.linalg.norm(np.asarray(b_s)))
    assert nb_p > 1e-3, nb_p  # plain ARAP fights the expansion
    assert nb_s < 1e-5 * max(nb_p, 1.0), (nb_s, nb_p)
    # the downdated matrix stays PSD (exact per-component Schur)
    w_eig = np.linalg.eigvalsh(np.asarray(A_s).reshape(D * 6, D * 6))
    assert w_eig.min() > -1e-4, w_eig.min()
