"""End-to-end on the vendored umbrella sequence (data/umbrella).

The reference's only e2e check is the demo on the real VolumeDeform
umbrella Kinect recording (download_data.sh:3-13, demo.cpp:67-131). Its
mirrors are unreachable from this environment, so data/umbrella is a
Kinect-v1 sensor-model rendering of the same scene class (opening/closing
scalloped canopy + handle + wall; disparity quantization, occlusion
shadows, grazing dropout — io/kinect_sim.py). These tests drive the REAL
dataset path — PNG loader -> engine -> outputs — and pin golden statistics
so pipeline drift on realistic (noisy, holey, discontinuous) data is
caught, which the synthetic-sphere suites cannot do.
"""

import os

import numpy as np
import pytest


from dynfu_tpu.core.camera import Intr
from dynfu_tpu.engine.dynfusion import DynFusion
from dynfu_tpu.engine.params import DynFuParams, KinFuParams
from dynfu_tpu.io import meshio
from dynfu_tpu.io.kinect_sim import umbrella_frame

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "umbrella")


def _downsampled(i, step=4):
    """Vendored frame i subsampled to 120x160 (CPU-budget resolution).
    Point subsampling keeps the sensor model's statistics (a box filter
    would average away the quantization/shadow structure)."""
    path = os.path.join(DATA, "depth", f"frame{i:04d}.png")
    return meshio.load_depth_png(path)[::step, ::step].astype(np.int32)


def small_params(mode_dims=96, **over):
    step = 4
    intr = Intr(525.0 / step, 525.0 / step, 640 / (2 * step) - 0.5,
                480 / (2 * step) - 0.5)
    base = dict(max_vertices=1 << 16, max_mc_voxels=1 << 14,
                max_nodes=256, max_new_nodes=128,
                fusion_max_active=1 << 17,
                # the floor fills whole z-columns (see mc.py col_budget)
                mc_col_budget=95)
    base.update(over)
    return DynFuParams(
        kinfu=KinFuParams(rows=120, cols=160, intr=intr,
                          volume_dims=(mode_dims,) * 3),
        **base,
    )


def test_vendored_bytes_deterministic():
    """The generator is seed-deterministic: frame 3's vendored PNG decodes
    to exactly a fresh render. Guards against silent dataset drift (the
    goldens below depend on the exact vendored depths)."""
    vendored = meshio.read_png(os.path.join(DATA, "depth", "frame0003.png"))
    fresh = umbrella_frame(3, frames=16)
    np.testing.assert_array_equal(vendored, fresh.astype(np.uint16))


def test_sequence_sensor_statistics():
    """The sensor model produces Kinect-class data: partial validity (holes
    + shadows), mm quantization coarser than 1 mm at 2 m, and a moving
    canopy between frames."""
    d0 = _downsampled(0, step=1)
    d8 = _downsampled(8, step=1)
    valid = (d0 > 0).mean()
    assert 0.90 < valid < 0.99  # holes/shadows exist but scene is covered
    # disparity quantization: distinct wall depths around 2.15 m must be
    # spaced > 3 mm (1/8-px steps of d = fb/z)
    wall = d0[(d0 > 2100) & (d0 < 2190)]
    lev = np.unique(wall)
    assert np.median(np.diff(lev)) >= 3
    # the canopy opens: in the upper third of the image (canopy region)
    # frame 8 has far more near-surface pixels than the closed frame 0
    top0, top8 = d0[:160], d8[:160]
    near0 = ((top0 > 900) & (top0 < 1300)).sum()
    near8 = ((top8 > 900) & (top8 < 1300)).sum()
    assert near8 > 2 * near0, (near0, near8)


@pytest.mark.parametrize("mode", ["parity", "fusion"])
def test_umbrella_engine_runs(mode):
    """6 frames of the real-data path through the engine in both parity and
    persistent-fusion modes: surfaces extracted every frame, observability
    counters clean, mesh vertex counts in the golden band."""
    eng = DynFusion(small_params(), mode=mode)
    counts = []
    for i in range(6):
        eng(_downsampled(i))
        counts.append(int(eng.mesh_vertices[1]))
    assert all(c > 3000 for c in counts[1:]), counts
    fs = eng.last_frame_stats
    assert int(fs.mc_dropped) == 0
    if mode == "fusion":
        assert int(fs.band.n_captured) == int(fs.band.n_band)
        # persistent volume accumulates multi-frame weight
        assert int(np.asarray(eng.vol.weight).max()) >= 4
    # the warped canonical stays on the live surface: project the warped
    # cloud into the live frame and compare depths (self-consistency golden
    # that needs no ground-truth geometry)
    wv, wm = eng.warped_cloud()
    v = np.asarray(wv)[np.asarray(wm)]
    p = eng.params
    vol_t = np.asarray([-1.5, -1.5, 0.5])
    cam = v + vol_t
    z = cam[:, 2]
    u = (p.intr.fx * cam[:, 0] / z + p.intr.cx).round().astype(int)
    vv = (p.intr.fy * cam[:, 1] / z + p.intr.cy).round().astype(int)
    d = _downsampled(5)
    inb = (u >= 0) & (u < 160) & (vv >= 0) & (vv < 120) & (z > 0)
    dz = d[vv[inb], u[inb]] / 1000.0
    ok = dz > 0
    err_mm = np.abs(dz[ok] - z[inb][ok]) * 1000
    assert np.median(err_mm) < 25.0, np.median(err_mm)
