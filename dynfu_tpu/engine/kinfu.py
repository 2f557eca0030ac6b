"""Rigid KinectFusion pipeline orchestrator.

Python host class mirroring kfusion::KinFu (include/kfusion/kinfu.hpp:64-113,
src/kfusion/kinfu.cpp:46-316). The host side orchestrates; every per-frame
computation is a jitted device program with static shapes, so frame k>0
replays cached executables only.

Per-frame flow (KinFu::operator(), kinfu.cpp:140-234, points/USE_DEPTH-off
path — the variant the reference builds by default):
  dists -> bilateral -> [truncate] -> point/normal pyramid (via depth
  pyramid)  ->  frame 0: integrate, stash pyramid  ->  frame k: ICP against
  previous raycast pyramid -> pose push -> clear + re-integrate (the
  reference always clears, kinfu.cpp:201-207) -> raycast into the new
  reference pyramid.

Differences from the reference, by design:
* failure flow: degenerate ICP resets the reconstruction (same), but the
  whole pipeline is functional — `reset()` just reinstalls the initial state
  pytree.
* pose history is a Python list of (R, t) HOST numpy pairs (reference keeps
  std::vector<Affine3f>, kinfu.cpp:121-127) — see reset() for why: pose math
  stays in host f32 and per-frame dispatch checks avoid device readbacks.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dynfu_tpu.core import se3
from dynfu_tpu.engine.params import KinFuParams
from dynfu_tpu.utils.jaxcache import enable_compilation_cache
from dynfu_tpu.ops import imgproc
from dynfu_tpu.rigid import icp
from dynfu_tpu.volume import tsdf as tv


@functools.partial(jax.jit, static_argnames=("p", "config", "margin"))
def _rigid_frame(vol, prev_pyr, pose_R, pose_t, depth_mm, *,
                 p: KinFuParams, config: tv.TsdfConfig, margin: float):
    """The ENTIRE rigid frame k>=1 as ONE XLA program: preprocess ->
    multi-scale stencil ICP -> device-side pose composition -> fused
    clear+integrate -> raycast -> next reference pyramid.

    The reference's loop round-trips to the host 27 floats per ICP
    iteration (projective_icp.cpp:25-57) and dispatches each stage
    separately; a per-stage engine pays ~16 dispatches and a BLOCKING pose
    readback per frame. Here the pose lives on device; the packed
    (R, t, ok) readback is issued per frame but resolved one frame LATE by
    the engine, so its transfer overlaps the next frame's compute.

    Dispatch inside the program: the separable integrate/raycast fast paths
    require an axis-aligned pose, which is only known AFTER the in-program
    ICP — so the choice is a lax.cond on the composed pose's rotation
    (mirrors the host `_aligned` atol=1e-6), and the homography branch
    carries the statically-chosen virtual-image `margin` bucket (selected
    by the host from the one-frame-stale pose; a pose escaping its bucket
    NaNs border correspondences, which drop out gracefully like
    out-of-image projections).

    Failure semantics (degenerate ICP): the pose freezes, integrate/raycast
    run at the frozen pose, and ok=False rides the packed readback; the
    engine resets when it resolves — one frame later than the reference's
    immediate reset (kinfu.cpp:189-191), with the interim state discarded
    by that reset."""
    depth_mm = depth_mm.astype(jnp.int32)
    intr = p.intr
    dists = imgproc.compute_dists(depth_mm, intr)
    filtered = imgproc.bilateral_filter(
        depth_mm, p.bilateral_kernel_size, p.bilateral_sigma_spatial,
        p.bilateral_sigma_depth)
    if p.icp_truncate_depth_dist > 0:
        filtered = imgproc.truncate_depth(filtered, p.icp_truncate_depth_dist)
    levels = len(p.icp_iter_num)
    depth_pyr = [filtered]
    for _ in range(1, levels):
        depth_pyr.append(imgproc.depth_pyramid_down(
            depth_pyr[-1], p.bilateral_sigma_depth))
    curr_pyr = tuple(
        imgproc.compute_points_normals(d, intr.level(i))
        for i, d in enumerate(depth_pyr))

    (Rinc, tinc), ok = icp.estimate_transform_stencil(
        curr_pyr, prev_pyr, intr, iters=p.icp_iter_num,
        dist_thres=p.icp_dist_thres, angle_thres=p.icp_angle_thres,
        radii=p.icp_stencil_radii)

    # pose = pose * affine (kinfu.cpp:194), frozen on failure
    Rc, tc = se3.compose((pose_R, pose_t), (Rinc, tinc))
    Rn = jnp.where(ok, Rc, pose_R)
    tn = jnp.where(ok, tc, pose_t)

    aligned = jnp.all(jnp.abs(Rn - jnp.eye(3, dtype=Rn.dtype)) < 1e-6)

    vol2 = jax.lax.cond(
        aligned,
        lambda op: tv.integrate_separable(op[0], op[1], (op[2], op[3]),
                                          intr, config, fresh=True),
        lambda op: tv.integrate_rotated(op[0], op[1], (op[2], op[3]),
                                        intr, config, fresh=True),
        (vol, dists, Rn, tn))

    shape = (p.rows, p.cols)
    pts, nrm = jax.lax.cond(
        aligned,
        lambda op: tv.raycast_separable(op[0], (op[1], op[2]), intr, shape,
                                        config),
        lambda op: tv.raycast_rotated(op[0], (op[1], op[2]), intr, shape,
                                      config, fov_margin=margin),
        (vol2, Rn, tn))

    prev = [(pts, nrm)]
    for _ in range(1, levels):
        prev.append(imgproc.resize_points_normals(*prev[-1]))

    packed = jnp.concatenate(
        [Rn.reshape(-1), tn, ok.astype(jnp.float32)[None]])
    return vol2, tuple(prev), Rn, tn, packed


class KinFu:
    """Rigid fusion engine. Call with a (H, W) int32 mm depth image."""

    def __init__(self, params: Optional[KinFuParams] = None):
        enable_compilation_cache()
        self.params = params or KinFuParams.default_params()
        p = self.params
        assert p.volume_dims[0] % 32 == 0  # kinfu.cpp:47
        self.tsdf_config = tv.TsdfConfig(
            dims=p.volume_dims,
            size=p.volume_size,
            trunc_dist=p.tsdf_trunc_dist,
            max_weight=p.tsdf_max_weight,
            raycast_step_factor=p.raycast_step_factor,
            gradient_delta_factor=p.gradient_delta_factor,
        )
        self.levels = len(p.icp_iter_num)
        self.volume_pose = (
            jnp.eye(3, dtype=jnp.float32),
            jnp.asarray(p.volume_pose_t, jnp.float32),
        )
        self.reset()

    # -- accessors (reference kinfu.hpp:74-90) ------------------------------
    def tsdf(self) -> tv.TsdfVolume:
        self._resolve_pending()
        return self.vol

    def get_camera_pose(self, time: int = -1):
        """poses_[time] with the reference's clamp semantics (kinfu.cpp:133-139)."""
        self._resolve_pending()
        if time > len(self.poses) or time < 0:
            time = len(self.poses) - 1
        return self.poses[time]

    def reset(self):
        """Pose -> identity, volume cleared (kinfu.cpp:121-130).

        Poses live as HOST numpy pairs: dispatch decisions (_aligned,
        _rotation_angle, margin buckets) read them, and each device
        readback is a blocking round trip. On the fused
        frame path the AUTHORITATIVE pose lives on device (_pose_dev); the
        host copy is refreshed by ONE packed (R, t, ok) readback per frame,
        resolved one frame late so the transfer overlaps compute
        (_resolve_pending)."""
        if getattr(self, "frame_counter", 0):
            print("Reset")
        self.frame_counter = 0
        self.poses: List[Tuple[np.ndarray, np.ndarray]] = [
            (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
        self.vol = tv.create(self.tsdf_config, self.volume_pose)
        self.prev_pyr = None
        self._pose_dev = (jnp.eye(3, dtype=jnp.float32),
                          jnp.zeros(3, jnp.float32))
        self._pending = None  # packed (13,) device array from _rigid_frame

    def _resolve_pending(self) -> bool:
        """Pull the previous fused frame's packed (R, t, ok) to the host:
        append the pose to the history, or reset on a degenerate ICP
        (detected one frame late — the interim frozen-pose state is
        discarded by the reset; see _rigid_frame). Returns False when a
        reset happened."""
        if self._pending is None:
            return True
        packed = np.asarray(self._pending)
        self._pending = None
        if packed[12] == 0.0:
            self.reset()
            return False
        self.poses.append(
            (packed[:9].reshape(3, 3).astype(np.float32),
             packed[9:12].astype(np.float32)))
        return True

    # -- per-frame ----------------------------------------------------------
    def _preprocess(self, depth_mm: jnp.ndarray):
        """dists + filtered depth + point/normal pyramid (kinfu.cpp:144-161)."""
        p = self.params
        dists = imgproc.compute_dists(depth_mm, p.intr)
        filtered = imgproc.bilateral_filter(
            depth_mm, p.bilateral_kernel_size, p.bilateral_sigma_spatial,
            p.bilateral_sigma_depth,
        )
        if p.icp_truncate_depth_dist > 0:
            filtered = imgproc.truncate_depth(filtered, p.icp_truncate_depth_dist)

        depth_pyr = [filtered]
        for _ in range(1, self.levels):
            depth_pyr.append(
                imgproc.depth_pyramid_down(depth_pyr[-1], p.bilateral_sigma_depth)
            )
        pyr = [
            imgproc.compute_points_normals(d, p.intr.level(i))
            for i, d in enumerate(depth_pyr)
        ]
        return dists, pyr

    # camera tilt (radians) up to which the homography fast paths cover the
    # real frustum with the default virtual-image margin
    MAX_HOMOGRAPHY_TILT = 0.6

    # virtual-image margins the rotated-raycast path may compile (coarse
    # buckets so each compiles once); beyond the largest, dispatch falls
    # through to the sweep/march formulations
    RAYCAST_MARGIN_BUCKETS = (1.15, 1.35, 1.6, 2.0, 2.5)

    def _rotation_angle(self, pose) -> float:
        R = np.asarray(pose[0])
        return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))

    def _raycast_margin(self, pose) -> Optional[float]:
        """Smallest margin bucket whose virtual frustum covers the real one
        under this pose's rotation, or None if none does.

        raycast_rotated marches an axis-aligned virtual camera (same focal
        length, margin x the pixel extent) and maps each real pixel into it
        by the homography u' = Kv R_rel^T K^-1 u with R_rel = R_cam^T (the
        volume pose rotation is identity by construction). A real corner
        that lands outside the virtual image is NaN-invalidated — a silent
        ICP-correspondence loss — so the margin is derived from the actual
        corner images, not from fixed tilt thresholds (which under-covered:
        at 480 rows/fy=525 a 1.35 margin covers only ~0.124 rad of pitch)."""
        p = self.params
        W, H = p.cols, p.rows
        R_cam = np.asarray(pose[0], np.float64)
        corners = np.array([[0.0, 0.0], [W - 1.0, 0.0],
                            [0.0, H - 1.0], [W - 1.0, H - 1.0]])
        d = np.stack([(corners[:, 0] - p.intr.cx) / p.intr.fx,
                      (corners[:, 1] - p.intr.cy) / p.intr.fy,
                      np.ones(4)], axis=1)
        dv = d @ R_cam.T  # R_rel^T d per corner
        if np.any(dv[:, 2] < 0.05):  # corner ray ~parallel to virtual plane
            return None
        # homography maps the image rectangle to a convex quad, so corner
        # extrema bound every interior pixel
        need_x = np.max(np.abs(p.intr.fx * dv[:, 0] / dv[:, 2]))
        need_y = np.max(np.abs(p.intr.fy * dv[:, 1] / dv[:, 2]))
        required = max(need_x / (W / 2.0), need_y / (H / 2.0)) * 1.02 + 0.01
        for m in self.RAYCAST_MARGIN_BUCKETS:
            if m >= required:
                return m
        return None

    def _aligned(self, pose) -> bool:
        """True when the camera rotation (and the volume pose rotation) is
        identity, enabling the separable integrate/raycast fast paths.
        Poses are tiny concrete arrays, so this host check is free."""
        return bool(np.allclose(np.asarray(pose[0]), np.eye(3), atol=1e-6))

    def _integrate(self, dists, pose, fresh: bool = False):
        """Fast-path dispatch: separable (identity rotation) ->
        homography-warped separable (moderate tilt) -> generic gather.

        fresh=True fuses the clear into the integrate on the separable
        paths (bit-identical; the rigid loop clears every frame,
        kinfu.cpp:201-207)."""
        if self._aligned(pose):
            return tv.integrate_separable(self.vol, dists, pose,
                                          self.params.intr, self.tsdf_config,
                                          fresh=fresh)
        if (self.params.raycast_mode == "auto"
                and self._rotation_angle(pose) < self.MAX_HOMOGRAPHY_TILT):
            return tv.integrate_rotated(self.vol, dists, pose,
                                        self.params.intr, self.tsdf_config,
                                        fresh=fresh)
        vol = tv.clear(self.vol) if fresh else self.vol
        return tv.integrate(vol, dists, pose, self.params.intr,
                            self.tsdf_config)

    # beyond this tilt, per-pixel rays can leave the +z half-space and the
    # slab-sweep formulations cannot march them
    MAX_SWEEP_TILT = 1.1

    def _raycast(self, pose):
        p = self.params
        angle = self._rotation_angle(pose)
        margin = None if p.raycast_mode != "auto" else self._raycast_margin(pose)
        if self._aligned(pose):
            fn = tv.raycast_separable
        elif margin is not None:
            # virtual-image margin sized to the pose's actual corner
            # coverage, in coarse buckets so each bucket compiles once: a
            # slowly-rotating camera (the common case) only needs a few
            # percent of margin — the blanket 1.6x pays 2.6x the raycast
            # pixels.
            return tv.raycast_rotated(self.vol, pose, p.intr,
                                      (p.rows, p.cols), self.tsdf_config,
                                      fov_margin=margin)
        elif angle < self.MAX_SWEEP_TILT:
            fn = tv.raycast
        else:
            fn = tv.raycast_march  # any-direction correctness fallback
        return fn(self.vol, pose, p.intr, (p.rows, p.cols), self.tsdf_config)

    def __call__(self, depth_mm, image=None) -> bool:
        """Frame ingestion. `image` mirrors the reference's
        operator()(Depth, Image) surface (kinfu.hpp:80; the demo loads a
        color/ directory, demo.cpp:46-55) — the color frame is ACCEPTED
        AND UNUSED, exactly as in the reference, whose math never reads
        it."""
        del image  # reference parity: color is part of the API, not the math
        p = self.params

        # fused single-program path: stencil ICP + auto raycast dispatch,
        # stale-pose tilt within the homography fast-path envelope.
        # Dispatch FIRST, resolve the previous packed readback SECOND: the
        # D2H round trip then overlaps
        # the just-dispatched program instead of serializing the loop. The
        # margin/tilt dispatch decisions therefore read a pose up to two
        # frames stale — covered by the bucket slack.
        if (p.fused_frame and p.icp_assoc == "stencil"
                and p.raycast_mode == "auto" and self.frame_counter > 0):
            margin = self._raycast_margin(self.poses[-1])
            if (margin is not None and self._rotation_angle(self.poses[-1])
                    < self.MAX_HOMOGRAPHY_TILT - 0.05):
                # pass the wire-format depth through: the program widens it
                # (uint16 streams upload half the bytes, kinfu.cpp:16-18)
                out = _rigid_frame(
                    self.vol, tuple(self.prev_pyr), *self._pose_dev,
                    jnp.asarray(depth_mm), p=p, config=self.tsdf_config,
                    margin=margin)
                if not self._resolve_pending():
                    # previous frame's ICP was degenerate: reset() already
                    # reinstalled clean state; discard this frame's outputs
                    # (the reference also loses the failure frame,
                    # kinfu.cpp:189-191)
                    return False
                self.vol, self.prev_pyr, R_dev, t_dev, packed = out
                self._pose_dev = (R_dev, t_dev)
                self._pending = packed
                was = self.frame_counter
                self.frame_counter += 1
                return was >= 2

        self._resolve_pending()
        depth_mm = jnp.asarray(depth_mm, jnp.int32)
        dists, curr_pyr = self._preprocess(depth_mm)

        if self.frame_counter == 0:
            self.vol = self._integrate(dists, self.poses[-1])
            self.prev_pyr = curr_pyr
            self.frame_counter += 1
            return False

        def _pull(res):
            # ONE packed host readback for (R, t, ok) — see reset()
            (R, t), ok = res
            return np.asarray(jnp.concatenate(
                [R.reshape(-1), t, ok.astype(jnp.float32)[None]]))

        packed = None
        if p.icp_assoc == "stencil":
            packed = _pull(icp.estimate_transform_stencil(
                curr_pyr, self.prev_pyr, p.intr, iters=p.icp_iter_num,
                dist_thres=p.icp_dist_thres, angle_thres=p.icp_angle_thres,
                radii=p.icp_stencil_radii,
            ))
        if packed is None or packed[12] == 0.0:
            # gather path: either configured, or the rescue tier when the
            # stencil windows dropped enough correspondences to trip the
            # degeneracy guard (tiny images / large motions) — pay the
            # exact reference semantics only on the rare failure frame
            packed = _pull(icp.estimate_transform(
                curr_pyr, self.prev_pyr, p.intr, iters=p.icp_iter_num,
                dist_thres=p.icp_dist_thres, angle_thres=p.icp_angle_thres,
            ))
        if packed[12] == 0.0:
            self.reset()
            return False

        # pose = pose * affine (curr -> global), kinfu.cpp:194 — host numpy
        R, t = packed[:9].reshape(3, 3), packed[9:12]
        Rp, tp = self.poses[-1]
        self.poses.append((Rp @ R, Rp @ t + tp))
        self._pose_dev = (jnp.asarray(self.poses[-1][0], jnp.float32),
                          jnp.asarray(self.poses[-1][1], jnp.float32))

        # always clear + reintegrate (reference kinfu.cpp:201-207) — fused
        self.vol = self._integrate(dists, self.poses[-1], fresh=True)

        # raycast the fused model into the new reference pyramid
        pts, nrm = self._raycast(self.poses[-1])
        prev = [(pts, nrm)]
        for _ in range(1, self.levels):
            prev.append(imgproc.resize_points_normals(*prev[-1]))
        self.prev_pyr = prev

        # frames 0 and 1 return False, later frames True (kinfu.cpp:229-233)
        was = self.frame_counter
        self.frame_counter += 1
        return was >= 2

    def get_mesh(self, max_voxels: int = 1 << 17, max_verts: int = 3 * 600_000):
        """Marching-cubes mesh of the current volume as an indexed
        (vertices, faces) pair with the reference winding — the analog of
        KinFu::getMesh / convertToMesh (kinfu.cpp:237-259). Vertices are in
        the WORLD frame."""
        import numpy as np

        from dynfu_tpu.io.meshio import _soup_to_indexed
        from dynfu_tpu.mesh import marching_cubes
        from dynfu_tpu.mesh.mc import mesh_to_world

        self._resolve_pending()
        verts, n, _ = marching_cubes(self.vol, self.tsdf_config,
                                     max_voxels=max_voxels, max_verts=max_verts)
        soup = mesh_to_world(verts, self.vol)
        return _soup_to_indexed(np.asarray(soup)[: int(n)])

    # -- rendering (kinfu.cpp:261-316) --------------------------------------
    def render(self, flag: int = 0):
        """Phong render of the current reference model view.

        flag 0: shaded surface; 1: tangent-color normals; 3: side-by-side
        (KinFu::renderImage, kinfu.cpp:261-292).
        """
        self._resolve_pending()
        if self.prev_pyr is None:
            raise RuntimeError("no frames processed")
        pts, nrm = self.prev_pyr[0]
        p = self.params
        if flag < 1 or flag > 3:
            return imgproc.render_image_points(pts, nrm, p.light_pose)
        if flag == 2:
            return imgproc.render_tangent_colors(nrm)
        a = imgproc.render_image_points(pts, nrm, p.light_pose)
        b = imgproc.render_tangent_colors(nrm)
        return jnp.concatenate([a, b], axis=1)
