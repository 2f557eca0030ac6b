#!/usr/bin/env python
"""Smoke run of the DynamicFusion main path on one GPU (smoke, not benchmark).

    python chip_smoke.py           # one GPU, every phase below
    python chip_smoke.py --multi   # four GPUs: the sharded engine only

Single-GPU phases, all at the 512-cube / 640x480 widths:
  1. numerics — each hot stage against the plain float64 reference
     (dynfu_tpu/utils/reference.py) or its gather formulation;
  2. parity DynFusion through utils.benchmarks.run_benchmark;
  3. SE(3) persistent-canonical fusion through run_fusion_benchmark;
  4. rigid KinFu through run_rigid_benchmark;
  5. the `dynfu` CLI in-process: synth, then run.
With --multi: ShardedDynFusion over four GPUs against DynFusion on GPU 0,
in parity mode and in SE(3) fusion mode, 6 frames each.

Every phase runs in this one process. The script exits 2 when JAX finds no
GPU or the repository is not beside it, 1 when any check fails, and prints
as its last line {"ok": true, "device": {...}} only when every check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
DIMS = 512
ROWS, COLS = 480, 640
SEED = 0


def _intr():
    from dynfu_tpu.core.camera import Intr

    return Intr(525.0, 525.0, COLS / 2 - 0.5, ROWS / 2 - 0.5)


def _sphere(i: int):
    import numpy as np

    from dynfu_tpu.io.datasets import sphere_depth

    return np.asarray(sphere_depth((0.004 * i, 0.0, 1.5), 0.5, ROWS, COLS,
                                   525.0, 525.0, COLS / 2 - 0.5,
                                   ROWS / 2 - 0.5), np.uint16)


def _params(dims: int, fusion: bool = False, **kw):
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams

    caps = DynFuParams.caps_for_volume(dims, fusion=fusion)
    caps.update(kw)
    return DynFuParams(kinfu=KinFuParams(rows=ROWS, cols=COLS, intr=_intr(),
                                         volume_dims=(dims,) * 3), **caps)


class Checks:
    """Collects named pass/fail checks and prints one line per check."""

    def __init__(self):
        self.failed: list[str] = []

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def _rel_fro(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _perturbed_field(wf, rng):
    """The engine's node field with small random node transforms."""
    import jax.numpy as jnp

    from dynfu_tpu.core import dualquat as dq

    cap = wf.capacity
    rod = jnp.asarray(rng.randn(cap, 3).astype("float32") * 0.05)
    t = jnp.asarray(rng.randn(cap, 3).astype("float32") * 0.01)
    dqs = dq.dq_from_rodrigues(rod, t)
    return wf._replace(dqs=jnp.where(wf.mask[:, None], dqs, wf.dqs))


def _warp_parts(wf, pts, nrm, blend: str):
    """The warp of warp/field.py as one program that also returns its
    neighbour order: (points, normals, idx with -1 for absent slots)."""
    import jax
    import jax.numpy as jnp

    from dynfu_tpu.core import dualquat as dq
    from dynfu_tpu.warp import field as wfield

    @jax.jit
    def run(wf, pts, nrm):
        idx, _, n_pos, n_dq, n_w, valid = wfield.neighbor_features(wf, pts)
        if blend == "dqb":
            b = wfield._dqb_from_features(pts, n_pos, n_dq, n_w, valid)
            out_n = dq.dq_transform_normal(b, nrm)
        else:
            b = wfield._dlb_from_features(pts, n_pos, n_dq, n_w, valid)
            out_n = dq.dq_rotate_vector(b, nrm)
        return (dq.dq_transform_point(b, pts), out_n,
                jnp.where(valid, idx, -1))

    return run(wf, pts, nrm)


def phase_numerics(c: Checks, dims: int = DIMS) -> dict:
    """Each hot stage at real widths against its plain reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial import cKDTree

    from dynfu_tpu.core import se3 as core_se3
    from dynfu_tpu.engine import dynfusion as dyn
    from dynfu_tpu.mesh import mc
    from dynfu_tpu.ops import imgproc
    from dynfu_tpu.solver import gn, se3
    from dynfu_tpu.utils import reference
    from dynfu_tpu.volume import tsdf as tv
    from dynfu_tpu.warp import field as wfield

    rng = np.random.RandomState(SEED)
    dp = _params(dims)
    engine = dyn.DynFusion(dp)
    cfg, intr = engine.tsdf_config, dp.kinfu.intr

    # integrate: separable one-hot formulation vs the per-voxel gather one
    depth0 = jnp.asarray(_sphere(0), jnp.int32)
    dists = imgproc.compute_dists(depth0, intr)
    cam = core_se3.identity()
    v_sep = tv.integrate_separable(engine.vol, dists, cam, intr, cfg)
    v_gat = tv.integrate(engine.vol, dists, cam, intr, cfg)
    w_sep, w_gat = np.asarray(v_sep.weight), np.asarray(v_gat.weight)
    same_w = w_sep == w_gat
    agree = float(same_w.mean())
    dt = np.abs(np.asarray(v_sep.tsdf, np.float32)
                - np.asarray(v_gat.tsdf, np.float32))[same_w]
    c.check("integrate_separable vs integrate",
            agree >= 0.9999 and float(dt.max()) <= 2e-3,
            f"weights equal on {agree:.6%} of {w_sep.size} voxels (>= "
            f"99.99%), max |dtsdf| {dt.max():.3e} where equal (<= 2e-3; "
            "f16 storage, f32 math)")
    del v_sep, v_gat

    engine(_sphere(0))
    engine(_sphere(1))
    can = engine.canonical
    cm = np.asarray(can.mask)
    cv = np.asarray(can.vertices)[cm]
    wf = _perturbed_field(engine.warpfield, rng)
    n_nodes = int(wf.count)

    # warp = k-NN selection + blend. The selection is checked against
    # float64 distances (ties within the float32 error of |q|^2 - 2 q.p +
    # |p|^2 at 3 m coordinates may reorder neighbours, and two compiled
    # programs may break them differently), the blend against the float64
    # DQB (parity) and DLB (SE(3) path) over the same program's selection
    nrm = rng.randn(*cv.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype("float32")
    for blend in ("dqb", "dlb"):
        gp, gn_, idx = _warp_parts(wf, jnp.asarray(cv), jnp.asarray(nrm),
                                   blend)
        idx = np.asarray(idx)
        if blend == "dqb":
            _, true_sqd = reference.knn(cv, wf.pos, wfield.KNN, wf.mask)
            got_sqd = ((cv[:, None, :].astype(np.float64)
                        - np.asarray(wf.pos, np.float64)[np.maximum(idx, 0)])
                       ** 2).sum(-1)
            got_sqd = np.where(idx >= 0, got_sqd, np.inf)
            fin = np.isfinite(true_sqd)
            # float32 |q|^2 - 2 q.p + |p|^2 is within E = 5u (|q| + |p|)^2
            # of the truth (three 3-term sums, two roundings; u = 2^-24),
            # so the j-th neighbour the program picks is within 2E of the
            # true j-th: the bound per query, with |p| its largest node
            p_max = np.linalg.norm(np.asarray(wf.pos)[np.asarray(wf.mask)],
                                   axis=1).max()
            bound = 10 * 2.0 ** -24 * (np.linalg.norm(cv, axis=1) + p_max) ** 2
            diff = np.abs(np.where(fin, got_sqd, 0.0)
                          - np.where(fin, true_sqd, 0.0))
            same_fin = bool((np.isfinite(got_sqd) == fin).all())
            ratio = float((diff / bound[:, None]).max()) if same_fin \
                else float("inf")
            c.check("warp k-NN selection", ratio <= 1.0,
                    f"{len(cv)} vertices, {n_nodes} nodes (capacity "
                    f"{wf.capacity}), k={wfield.KNN}: chosen vs true "
                    f"squared distances differ by <= {diff.max():.2e} m^2, "
                    f"{ratio:.3f} of the per-query float32 bound 2E "
                    f"({bound.min():.2e}..{bound.max():.2e} m^2)")
        wp, wn = reference.warp(cv, nrm, wf.pos, wf.dqs, wf.w, wf.mask,
                                k=wfield.KNN, blend=blend, idx=idx)
        ep = float(np.abs(np.asarray(gp, np.float64) - wp).max())
        en = float(np.abs(np.asarray(gn_, np.float64) - wn).max())
        c.check(f"warp {blend}", ep <= 2e-5 and en <= 2e-5,
                f"{len(cv)} vertices: max |dp| {ep:.2e} m, max |dn| "
                f"{en:.2e} (<= 2e-5, f32 vs float64)")

    # correspondence: the engine's tiered x-window 1-NN vs exact 1-NN
    live_v = engine.live.vertices
    live_m = engine.live.mask
    wv = engine.canonical_warped.vertices
    got, _, ok, _ = dyn._correspondence(
        wv, wv, can.mask, live_v, live_m, True, rescue=dp.corr_rescue,
        escalate=dp.corr_escalate, block=dp.corr_block,
        window_blocks=dp.corr_window_blocks)
    lm, ex = np.asarray(live_m), np.asarray(ok)
    q = np.asarray(live_v, np.float64)[lm & ex]
    pts = np.asarray(wv, np.float64)[cm]
    true_d, _ = cKDTree(pts).query(q)
    got_d = np.linalg.norm(np.asarray(got, np.float64)[lm & ex] - q, axis=1)
    excess = float((got_d - true_d).max()) if len(q) else 0.0
    c.check("correspondence 1-NN vs cKDTree", len(q) > 0 and excess <= 1e-6,
            f"{int(lm.sum())} live queries vs {len(pts)} points, "
            f"{int((lm & ex).sum())} certified exact; worst excess over the "
            f"true NN distance {excess:.2e} m (<= 1e-6, ties)")

    # GN data normal equations and the SE(3) monomial Grams at the frame's
    # shapes: data graph of the live vertex buffer against the node field
    idx, _, n_pos, _, n_w, n_valid = wfield.neighbor_features(
        wf, live_v, dp.knn)
    w = wfield.transformation_weights(n_pos, n_w, live_v[:, None, :])
    w = jnp.where(n_valid & live_m[:, None], w, 0.0)
    N, D = live_v.shape[0], wf.capacity
    s2 = jnp.asarray(rng.rand(N).astype("float32"))
    delta = jnp.asarray((rng.randn(N, 3) * 0.005).astype("float32"))
    A, b = jax.jit(gn._dense_data_normal, static_argnums=(5,))(
        None, idx, w, s2, delta, D)
    A_r, b_r = reference.data_normal(idx, w, s2, delta, D)
    ea, eb = _rel_fro(A, A_r), _rel_fro(b, b_r)
    c.check("GN data normal equations", ea <= 1e-5 and eb <= 1e-5,
            f"N={N}, K={dp.knn}, D={D}: rel Frobenius A {ea:.2e}, b "
            f"{eb:.2e} (<= 1e-5 vs float64)")
    wn_ = w / jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-12)
    y = live_v - jnp.mean(live_v[:1024], axis=0)
    B, Bu, Bw = jax.jit(se3._monomial_grams, static_argnums=(5,))(
        idx, wn_, s2, y, delta, D)
    B_r, Bu_r, Bw_r = reference.monomial_grams(idx, wn_, s2, y, delta, D)
    e3 = max(_rel_fro(B, B_r), _rel_fro(Bu, Bu_r), _rel_fro(Bw, Bw_r))
    c.check("SE(3) monomial Grams", e3 <= 1e-5,
            f"N={N}, D={D}, 10 Grams + 2 rhs: worst rel Frobenius {e3:.2e} "
            "(<= 1e-5 vs float64)")

    # marching-cubes triangle emission at the 512-cube capacities
    M, max_tris = dp.max_mc_voxels, dp.max_vertices // 3
    for name, cap in (("fits", max_tris), ("spill", max_tris // 4)):
        n_tris = rng.choice(6, M, p=[0.2, 0.3, 0.3, 0.1, 0.06, 0.04])
        n_tris = n_tris.astype("int32")
        offs = (np.cumsum(n_tris) - n_tris).astype("int32")
        tris = rng.rand(M, 5, 9).astype("float32")
        out = jax.jit(mc.emit_triangles, static_argnums=(3,))(
            jnp.asarray(tris), jnp.asarray(offs), jnp.asarray(n_tris), cap)
        want = reference.emit_triangles(tris, offs, n_tris, cap)
        same = bool(np.array_equal(np.asarray(out), want))
        c.check(f"MC emission ({name})", same,
                f"{M} voxels, {int(n_tris.sum())} triangles into {cap} "
                "rows: identical to the numpy stream (exact)")
    return {}


def phase_parity(c: Checks, dims: int = DIMS, frames: int = 4) -> dict:
    from dynfu_tpu.utils.benchmarks import run_benchmark

    r = run_benchmark(volume_dims=dims, frames=frames)
    c.check("parity DynFusion",
            r["mc_dropped_cells"] == 0 and r["corr_dropped"] == 0
            and r["median_vertex_err_mm"] <= 3.0,
            f"mc_dropped {r['mc_dropped_cells']}, corr_dropped "
            f"{r['corr_dropped']} (== 0), median vertex error "
            f"{r['median_vertex_err_mm']} mm (<= 3 vs the analytic sphere)")
    return {"warmup_s": r["warmup_s"],
            "frame_ms_median_of_windows": round(
                statistics.median(r["window_frame_ms"]), 2)}


def phase_fusion(c: Checks, dims: int = DIMS, frames: int = 12) -> dict:
    from dynfu_tpu.utils.benchmarks import run_fusion_benchmark

    r = run_fusion_benchmark(volume_dims=dims, frames=frames, rotations=True)
    c.check("SE(3) fusion",
            r["warped_err_mm"] <= 1.0 and r["n_captured"] == r["n_band"],
            f"warped error {r['warped_err_mm']} mm (<= 1), n_captured "
            f"{r['n_captured']} == n_band {r['n_band']}")
    return {"warmup_s": r["warmup_s"], "frame_ms_mean": r["frame_ms"]}


def phase_rigid(c: Checks, dims: int = DIMS, frames: int = 10) -> dict:
    import math

    from dynfu_tpu.utils.benchmarks import run_rigid_benchmark

    r = run_rigid_benchmark(volume_dims=dims, frames=frames)
    c.check("rigid KinFu",
            r["pose_finite"] and math.isfinite(r["ate_mm"])
            and r["ate_mm"] <= 10.0,
            f"pose finite {r['pose_finite']}, ATE {r['ate_mm']} mm "
            "(<= 10, gross-failure guard)")
    return {"warmup_s": r["warmup_s"], "frame_ms_mean": r["frame_ms"]}


def phase_cli(c: Checks, dims: int = DIMS, frames: int = 6) -> dict:
    from dynfu_tpu.io import cli, native_loader

    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=HERE) as tmp:
        data = os.path.join(tmp, "seq")
        rc1 = cli.main(["synth", data, "--frames", str(frames)])
        t0 = time.perf_counter()
        rc2 = cli.main(["run", data, "--volume-dims", str(dims),
                        "--frames", str(frames)])
        run_s = time.perf_counter() - t0
        out = Path(data) / "out"
        outs = sorted(out.glob("*.pcd")) + sorted(out.glob("*.ply"))
        nonempty = [p for p in outs if p.stat().st_size > 200]
        c.check("CLI synth + run", rc1 == 0 and rc2 == 0
                and len(nonempty) == len(outs) == 2 * frames,
                f"rc {rc1}/{rc2}, {len(nonempty)} of {len(outs)} .pcd/.ply "
                f"outputs non-empty (want {2 * frames})")
    # the run's frames come through the native threaded decoder, not the
    # synchronous numpy fallback
    native = native_loader.available()
    c.check("CLI native depth loader", native,
            f"native loader {'loaded' if native else 'did not load'} from "
            "native/build/")
    return {"run_s": round(run_s, 2)}


def _state_arrays(drv):
    import jax

    return [x for x in jax.tree_util.tree_leaves(drv._state)
            if isinstance(x, jax.Array)]


def phase_multi(c: Checks, dims: int = DIMS, frames: int = 6,
                n: int = 4) -> dict:
    """ShardedDynFusion over n devices vs DynFusion on device 0."""
    import numpy as np

    from dynfu_tpu.dist.driver import ShardedDynFusion
    from dynfu_tpu.engine.dynfusion import DynFusion

    out = {}
    for mode in ("parity", "fusion"):
        fusion = mode == "fusion"
        dp = (_params(dims, fusion=True, solver_rotations=True) if fusion
              else _params(dims))
        drv = ShardedDynFusion(dp, mode=mode, n_devices=n)
        ref = DynFusion(dp, mode=mode)
        t0 = time.perf_counter()
        for i in range(frames):
            drv(_sphere(i))
            ref(_sphere(i))
        wv_d, wm_d = (np.asarray(a) for a in drv.warped_cloud())
        wv_r, wm_r = (np.asarray(a) for a in ref.warped_cloud())
        out[f"{mode}_s"] = round(time.perf_counter() - t0, 2)
        arrays = _state_arrays(drv)
        spread = all(len(x.addressable_shards) == n
                     and len({s.device for s in x.addressable_shards}) == n
                     for x in arrays)
        c.check(f"{mode}: state on {n} devices", spread,
                f"{len(arrays)} engine-state arrays, each with {n} "
                f"addressable shards on {n} distinct devices")
        if not fusion:
            same_m = bool(np.array_equal(wm_d, wm_r))
            err = float(np.abs(wv_d[wm_r] - wv_r[wm_r]).max()) if same_m \
                else float("inf")
            c.check("parity: sharded vs one device",
                    same_m and err <= 1e-4,
                    f"{frames} frames: masks identical {same_m}, max "
                    f"|dwarped| {err:.2e} m (<= 1e-4)")
        else:
            centre = np.asarray((0.004 * (frames - 1), 0.0, 1.5)) \
                - np.asarray(dp.kinfu.volume_pose_t)

            def err_mm(v, m):
                d = np.linalg.norm(v[m] - centre, axis=1)
                return float(np.median(np.abs(d - 0.5))) * 1e3

            e_d, e_r = err_mm(wv_d, wm_d), err_mm(wv_r, wm_r)
            c.check("SE(3) fusion: sharded vs one device",
                    abs(e_d - e_r) <= 0.05,
                    f"{frames} frames: warped error {e_d:.4f} mm sharded vs "
                    f"{e_r:.4f} mm one device (agree within 0.05 mm)")
    return out


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-GPU sharded-engine "
                             "comparison")
    args = parser.parse_args(argv)

    if not (HERE / "dynfu_tpu" / "__init__.py").is_file():
        print(f"no dynfu_tpu package beside {Path(__file__).name}; run it "
              "from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import jax

    from dynfu_tpu.utils.device import require_gpu
    from dynfu_tpu.utils.jaxcache import enable_compilation_cache

    require_gpu()

    n_want = 4 if args.multi else 1
    devices = jax.devices()
    if len(devices) < n_want:
        print(f"need {n_want} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2
    print(f"card: {_card_line()}")
    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
          f"compile cache {enable_compilation_cache() or 'off'}", flush=True)

    phases = ([("multi", phase_multi)] if args.multi else
              [("numerics", phase_numerics), ("parity", phase_parity),
               ("fusion", phase_fusion), ("rigid", phase_rigid),
               ("cli", phase_cli)])
    c = Checks()
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            info = fn(c)
        except Exception:
            traceback.print_exc()
            c.failed.append(name)
            info = {}
        info["wall_s"] = round(time.perf_counter() - t0, 2)
        print(f"  timing {name}: {json.dumps(info)}", flush=True)
    if c.failed:
        print(f"FAILED: {', '.join(c.failed)}", file=sys.stderr)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
