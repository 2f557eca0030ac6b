"""Engine-level fusion mode (mode="fusion"): persistent canonical volume
with warped-back integration — the DynamicFusion fusion model the
reference's clear+reintegrate loop stands in for (dyn_fusion.cpp:107-116).
"""


import numpy as np


from dynfu_tpu.engine.dynfusion import DynFusion

from test_pipeline import (CENTER, RADIUS, small_dynfu_params, sphere_depth,
                           surface_error)

VOL_T = np.asarray((-0.5, -0.5, 0.25))


def _run(frames, **engine_kw):
    df = DynFusion(small_dynfu_params(), mode="fusion", **engine_kw)
    for f in frames:
        df(f)
    return df


def test_fusion_tracks_and_accumulates():
    """Tracking a translating sphere: warped canonical lands on the live
    surface, the canonical volume is NEVER cleared (weights accumulate
    beyond a single frame's worth), and the canonical surface stays at the
    canonical (frame-0) position."""
    seq = [sphere_depth((CENTER[0] + 0.004 * i, CENTER[1], CENTER[2]), RADIUS)
           for i in range(5)]
    df = _run(seq)

    # weight accumulation: clear+reintegrate caps weights at 1 everywhere;
    # persistent fusion accumulates one observation per frame
    w = np.asarray(df.vol.weight)
    assert w.max() >= 4, f"max weight {w.max()} — volume was cleared?"

    # warped canonical tracks the live surface
    wv, wm = df.warped_cloud()
    cen_live = np.asarray((CENTER[0] + 0.016, CENTER[1], CENTER[2])) - VOL_T
    werr = surface_error(wv, np.asarray(wm), cen_live, RADIUS)
    assert np.median(werr) < 0.008, f"median warped err {np.median(werr)}"

    # canonical surface stays at the canonical position (it must NOT drift
    # toward the live pose — that's what the warp is for)
    cv, cm = df.canonical.vertices, np.asarray(df.canonical.mask)
    cerr = surface_error(cv, cm, np.asarray(CENTER) - VOL_T, RADIUS)
    assert np.median(cerr) < 0.008, f"median canonical err {np.median(cerr)}"

    # observability: healthy run has no capacity overflow
    fs = df.last_frame_stats
    assert int(fs.mc_dropped) == 0
    assert int(fs.band.n_captured) == int(fs.band.n_band)
    assert int(fs.band.n_updated) > 0


def test_fusion_beats_single_frame_discretization():
    """Re-observing a STATIC sphere must reduce canonical surface error
    below the frame-1 level (supersampling across frames averages out depth
    quantization + point-sampling noise) — the property the parity
    clear+reintegrate loop cannot have."""
    f = sphere_depth(CENTER, RADIUS)
    cen_vol = np.asarray(CENTER) - VOL_T

    df = DynFusion(small_dynfu_params(), mode="fusion")
    df(f)
    e0 = np.median(surface_error(df.canonical.vertices,
                                 np.asarray(df.canonical.mask),
                                 cen_vol, RADIUS))
    for _ in range(6):
        df(f)
    e1 = np.median(surface_error(df.canonical.vertices,
                                 np.asarray(df.canonical.mask),
                                 cen_vol, RADIUS))
    assert e1 <= e0 * 1.05, (e0, e1)  # must not get worse
    # and the warp stays ~identity (no spurious deformation invented)
    wv, wm = df.warped_cloud()
    werr = np.median(surface_error(wv, np.asarray(wm), cen_vol, RADIUS))
    assert werr < 0.006


def test_fusion_mode_flag_validation():
    import pytest

    with pytest.raises(ValueError):
        DynFusion(small_dynfu_params(), mode="bogus")
    assert DynFusion(small_dynfu_params()).mode == "parity"
    assert DynFusion(small_dynfu_params(), strict_parity=False).mode == "fixed"


def test_fusion_with_se3_rotations():
    """mode="fusion" with solver_rotations=True: the per-node SE(3) solve
    (solver/se3.py) + proper DLB warp replace the translations-only solve.
    Same tracking contract as the translation path on a translating sphere
    (whose motion needs no rotation — the rotation unknowns must stay
    quiet, not inject noise)."""
    import dataclasses

    params = dataclasses.replace(small_dynfu_params(),
                                 solver_rotations=True, se3_relinearize=2)
    seq = [sphere_depth((CENTER[0] + 0.004 * i, CENTER[1], CENTER[2]), RADIUS)
           for i in range(5)]
    df = DynFusion(params, mode="fusion")
    for f in seq:
        df(f)

    wv, wm = df.warped_cloud()
    cen_live = np.asarray((CENTER[0] + 0.016, CENTER[1], CENTER[2])) - VOL_T
    werr = surface_error(wv, np.asarray(wm), cen_live, RADIUS)
    assert np.median(werr) < 0.008, f"median warped err {np.median(werr)}"

    cv, cm = df.canonical.vertices, np.asarray(df.canonical.mask)
    cerr = surface_error(cv, cm, np.asarray(CENTER) - VOL_T, RADIUS)
    assert np.median(cerr) < 0.008, f"median canonical err {np.median(cerr)}"

    fs = df.last_frame_stats
    assert int(fs.mc_dropped) == 0
    # the solve must report a finite, bounded mean rotation (translating
    # sphere: rotations weakly observable -> the rot_prior step damping
    # keeps the noise-fit spin bounded)
    assert float(fs.solve.mean_rot_deg) < 15.0


def test_fusion_warmup_improves_static_canonical():
    """fusion_warmup_frames: integrating the first post-bootstrap frames
    without a solve keeps frame-0 discretization noise from being warped
    into the canonical volume (see DynFuParams)."""
    import dataclasses

    seq = [sphere_depth(CENTER, RADIUS) for _ in range(8)]

    def err(warmup):
        params = dataclasses.replace(small_dynfu_params(),
                                     solver_rotations=True,
                                     fusion_warmup_frames=warmup)
        df = DynFusion(params, mode="fusion")
        for f in seq:
            df(f)
        cv, cm = df.canonical.vertices, np.asarray(df.canonical.mask)
        return np.median(surface_error(cv, cm, np.asarray(CENTER) - VOL_T,
                                       RADIUS))

    assert err(2) < err(0) - 1e-4


def test_fusion_camera_tracking_moving_camera():
    """fusion_camera_tracking=True: a TRANSLATING camera over a static
    scene is tracked by frame-to-frame projective ICP — the recovered pose
    matches the true camera motion and the canonical surface quality is
    comparable to the static-camera run (the capability the parity
    reference stubbed out, dyn_fusion.cpp:102-105)."""
    import dataclasses

    from test_pipeline import scene_depth

    params = dataclasses.replace(small_dynfu_params(),
                                 fusion_camera_tracking=True)
    cams = [np.asarray([0.002 * i, -0.001 * i, 0.0015 * i])
            for i in range(6)]
    df = DynFusion(params, mode="fusion")
    for c in cams:
        df(scene_depth(cam_t=c))

    R, t = df.poses[-1]
    np.testing.assert_allclose(np.asarray(t), cams[-1], atol=0.004)
    ang = np.degrees(np.arccos(np.clip((np.trace(np.asarray(R)) - 1) / 2,
                                       -1, 1)))
    assert ang < 1.0, f"spurious rotation {ang} deg"

    # canonical quality comparable to the static-camera run
    cv, cm = df.canonical.vertices, np.asarray(df.canonical.mask)
    cerr = np.median(surface_error(cv, cm, np.asarray(CENTER) - VOL_T,
                                   RADIUS))
    df0 = DynFusion(small_dynfu_params(), mode="fusion")
    for _ in cams:
        df0(scene_depth())
    cv0, cm0 = df0.canonical.vertices, np.asarray(df0.canonical.mask)
    cerr0 = np.median(surface_error(cv0, cm0, np.asarray(CENTER) - VOL_T,
                                    RADIUS))
    assert cerr < max(2.0 * cerr0, 0.006), (cerr, cerr0)


def test_fusion_camera_tracking_static_is_stable():
    """Tracking enabled on a perfectly static camera must not degrade the
    static behavior: the recovered pose stays ~identity and the canonical
    error matches the tracking-off run closely."""
    import dataclasses

    from test_pipeline import scene_depth

    params = dataclasses.replace(small_dynfu_params(),
                                 fusion_camera_tracking=True)
    # 3-sphere scene: a single sphere leaves rotation about its center
    # unobservable and the gauge freedom bleeds into the translation
    seq = [scene_depth() for _ in range(5)]
    df = DynFusion(params, mode="fusion")
    for f in seq:
        df(f)
    R, t = df.poses[-1]
    # per-frame ICP noise at this tiny resolution (120x160, mm-quantized
    # depth) is ~0.5 mm; 5 frames of random-walk stay under 4 mm
    assert np.linalg.norm(np.asarray(t)) < 0.004, t
    cv, cm = df.canonical.vertices, np.asarray(df.canonical.mask)
    cerr = np.median(surface_error(cv, cm, np.asarray(CENTER) - VOL_T,
                                   RADIUS))
    df0 = _run(seq)
    cv0, cm0 = df0.canonical.vertices, np.asarray(df0.canonical.mask)
    cerr0 = np.median(surface_error(cv0, cm0, np.asarray(CENTER) - VOL_T,
                                    RADIUS))
    assert cerr < cerr0 + 0.002, (cerr, cerr0)


def test_fusion_512_caps_pin_stability_fixes():
    """Pin the 512-cube SE(3)-fusion stabilization knobs (r3 commit
    aebe61e + the band-capture fix). These values were established by
    measurement and their failure modes are catastrophic, so the preset is
    a regression surface:

    * resolution-independent node DENSITY: fusion node stride scales with
      the soup size (stride 256 at 512-cube = 878 nodes whose near-equal
      8-NN weights leave per-node cancellation modes data-null — the SE(3)
      solve explodes to ~8 m warped error by frame 5; stride 512 / 439
      nodes is stable at 0.5 mm);
    * fusion band column budget 128: the truncation-band auto estimate
      silently truncates capture on sphere-tangent z-columns from frame 5
      (n_captured < n_band; the canonical decays where updated least);
    * band capacity 1 << 19 voxels (1.33x headroom over the stable-run
      band of ~395k; the 565k/786k figures in an earlier draft came from
      a DIVERGING run — params.py rationale).
    """
    from dynfu_tpu.engine.params import DynFuParams

    caps = DynFuParams.caps_for_volume(512, fusion=True)
    assert caps["node_sample_step"] == 512
    assert caps["fusion_col_budget"] == 128
    assert caps["fusion_max_active"] == 1 << 19
    # r4: fusion consumes the canonical at unique-vertex granularity and
    # damps rotation noise at this node density (0.37-0.42 mm warped
    # through 16 frames; 0.03 drifts to 10 mm — params.py rationale);
    # buffers sized to the measured stable workload (39k verts, 439+
    # nodes, 395k band)
    assert caps["corr_unique_edges"] and caps["max_edge_verts"] == 1 << 16
    assert caps["se3_rot_prior"] == 0.3
    # r5: one relinearization measures 0.459 mm warped vs 0.441 at two on
    # the 12-frame bench — both far inside the <=1 mm bar — and each step
    # is a full Gram + assembly + PCG pass
    assert caps["se3_relinearize"] == 1
    assert caps["max_nodes"] == 640 and caps["max_new_nodes"] == 256
    assert DynFuParams.caps_for_volume(448, fusion=True)[
        "node_sample_step"] == 512
    # parity-mode 512 presets: stride-256 deviation + unique-edge hot path
    p = DynFuParams.caps_for_volume(512)
    assert p["node_sample_step"] == 256
    assert p["corr_unique_edges"] and p["max_edge_verts"] == 49152
