"""Projective point-to-plane ICP, fully on device.

Re-design of the reference's multi-scale rigid ICP:
* host loop    kfusion::cuda::ProjectiveICP::estimateTransform (points
               variant, src/kfusion/projective_icp.cpp:158-201)
* device side  ComputeIcpHelper::find_coresp + the 27-term two-stage
               shared-memory reduction (src/kfusion/cuda/proj_icp.cu:70-375)

The reference's architecture is a GPU/CPU ping-pong: every iteration it
launches a correspondence+reduce kernel, async-copies 27 floats into
page-locked memory, synchronizes a stream, unpacks a symmetric 6x6 on the
CPU, and solves with cv::solve(DECOMP_SVD) (projective_icp.cpp:25-57,
177-197). Here the whole schedule — all levels, all iterations,
correspondence, normal-equation reduction AND the 6x6 solve — is one jitted
program: the reduction is a plain masked sum (XLA's cross-lane reduce
replaces the hand-written warp scans) and the solve stays on device, so
there is zero host round-trip per iteration.

Semantics preserved (find_coresp, proj_icp.cu:70-99 non-USE_DEPTH path):
* s = aff * vcurr(y, x); reject NaN, s.z <= 0, out-of-image projections;
* d, nd point-fetched at the PROJECTED (floor) pixel of the previous frame;
* gates: |s - d|^2 <= dist_thres^2 and |dot(aff.R * ncurr, nd)| >= cos(angle);
* row = [cross(s, nd), nd | dot(nd, d - s)] (icp_helper_kernel, cu:343-353);
* increment from a 6-vector [rvec | t] via Rodrigues, composed on the left
  (projective_icp.cpp:195-197);
* degenerate guard: |det(A)| < 1e-15 or NaN -> estimation fails and the
  caller resets the reconstruction (projective_icp.cpp:181-191,
  kinfu.cpp:189-191). Here failure freezes the pose and raises a flag.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from dynfu_tpu.core import se3
from dynfu_tpu.core.camera import Intr
from dynfu_tpu.ops import imgproc

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _rot3(p, R):
    """(..., 3) x (3, 3)^T as broadcast sums: p @ R.T in exact f32 without
    a K=3 matmul — the same replacement volume/fusion.py and
    engine/dynfusion.py use."""
    return (p[..., 0:1] * R[:, 0] + p[..., 1:2] * R[:, 1]
            + p[..., 2:3] * R[:, 2])


def _normal_equations_reduce(Jf, r):
    """A = J^T J, b = J^T r as a fused broadcast-multiply + tree reduce.

    The reduction is the reference's own 27-term partial_reduce
    (proj_icp.cu:101-333) in XLA form: f32 tree adds, exact whatever
    precision the matmul units default to."""
    A = jnp.sum(Jf[:, :, None] * Jf[:, None, :], axis=0)
    b = jnp.sum(Jf * r[:, None], axis=0)
    return A, b


def build_pyramids(points, normals, levels: int):
    """Point/normal pyramid via the reference's 2x2 resize
    (resizePointsNormals, kinfu.cpp:219-227)."""
    pyr = [(points, normals)]
    for _ in range(levels - 1):
        p, n = imgproc.resize_points_normals(*pyr[-1])
        pyr.append((p, n))
    return pyr


def _icp_normal_equations(
    aff_R, aff_t, vcurr, ncurr, vprev, nprev, intr: Intr,
    dist2_thres: float, min_cosine: float,
):
    """Masked whole-image point-to-plane normal equations: A (6,6), b (6,)."""
    H, W = vcurr.shape[:2]
    s = _mm(vcurr.reshape(-1, 3), aff_R.T).reshape(H, W, 3) + aff_t

    u = intr.fx * s[..., 0] / s[..., 2] + intr.cx
    v = intr.fy * s[..., 1] / s[..., 2] + intr.cy
    ui = jnp.floor(u).astype(jnp.int32)
    vi = jnp.floor(v).astype(jnp.int32)
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (s[..., 2] > 0)
    ui = jnp.clip(ui, 0, W - 1)
    vi = jnp.clip(vi, 0, H - 1)

    d = vprev[vi, ui]  # (H, W, 3) gather
    nd = nprev[vi, ui]

    ns = _mm(ncurr.reshape(-1, 3), aff_R.T).reshape(H, W, 3)
    diff = s - d
    dist2 = jnp.sum(diff * diff, axis=-1)
    cosine = jnp.abs(jnp.sum(ns * nd, axis=-1))

    valid = (
        ~jnp.isnan(vcurr[..., 0])
        & in_img
        & ~jnp.isnan(d[..., 0])
        & (dist2 <= dist2_thres)
        & (cosine >= min_cosine)
    )

    # row = [cross(s, nd), nd], rhs = dot(nd, d - s)
    c = jnp.cross(s, nd)
    J = jnp.concatenate([c, nd], axis=-1)  # (H, W, 6)
    r = jnp.sum(nd * (d - s), axis=-1)  # (H, W)
    J = jnp.where(valid[..., None], J, 0.0)
    r = jnp.where(valid, r, 0.0)
    J = jnp.nan_to_num(J)
    r = jnp.nan_to_num(r)

    Jf = J.reshape(-1, 6)
    A = _mm(Jf.T, Jf)  # (6, 6)
    b = Jf.T @ r.reshape(-1)
    return A, b


def _solve_svd(A, b):
    """cv::solve(..., DECOMP_SVD) analog: pseudo-inverse least squares."""
    return jnp.linalg.pinv(A, rcond=1e-10) @ b


def _fetch_stencil(img, vi, ui, radius: int):
    """img[vi, ui] computed as a bounded-window STENCIL SELECT instead of
    an element gather: for every offset in [-radius, radius]^2 the shifted
    image is a cheap vectorized roll, and each pixel selects the shift that
    matches its (vi - y, ui - x) flow. Pixels whose flow exceeds the window
    return NaN (treated like an out-of-image projection).

    Rationale: the projective association's flow is small once the coarse
    pyramid levels have converged the pose, so the (2R+1)^2 shifted selects
    are pure elementwise traffic. Replaces the texture fetch of find_coresp
    (proj_icp.cu:70-99) for the fast (non-parity) ICP mode."""
    H, W = vi.shape
    ys = jnp.arange(H, dtype=jnp.int32)[:, None]
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    dy = vi - ys
    dx = ui - xs
    out = jnp.full(img.shape, jnp.nan, img.dtype)
    for oy in range(-radius, radius + 1):
        rolled_y = jnp.roll(img, -oy, axis=0)
        for ox in range(-radius, radius + 1):
            sh = jnp.roll(rolled_y, -ox, axis=1)
            sel = (dy == oy) & (dx == ox)
            out = jnp.where(sel[..., None], sh, out)
    return out


def _icp_normal_equations_stencil(
    aff_R, aff_t, vcurr, ncurr, vprev, nprev, intr: Intr,
    dist2_thres: float, min_cosine: float, radius: int,
):
    """`_icp_normal_equations` with the previous-frame fetch as a stencil
    select (see `_fetch_stencil`). Identical math for every correspondence
    whose flow fits the window; larger flows drop out of the system the
    same way out-of-image projections do."""
    H, W = vcurr.shape[:2]
    s = _rot3(vcurr, aff_R) + aff_t

    u = intr.fx * s[..., 0] / s[..., 2] + intr.cx
    v = intr.fy * s[..., 1] / s[..., 2] + intr.cy
    ui = jnp.floor(u).astype(jnp.int32)
    vi = jnp.floor(v).astype(jnp.int32)
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (s[..., 2] > 0)
    ui = jnp.clip(ui, 0, W - 1)
    vi = jnp.clip(vi, 0, H - 1)

    both = _fetch_stencil(jnp.concatenate([vprev, nprev], -1), vi, ui,
                          radius)
    d, nd = both[..., :3], both[..., 3:]

    ns = _rot3(ncurr, aff_R)
    diff = s - d
    dist2 = jnp.sum(diff * diff, axis=-1)
    cosine = jnp.abs(jnp.sum(ns * nd, axis=-1))

    valid = (
        ~jnp.isnan(vcurr[..., 0])
        & in_img
        & ~jnp.isnan(d[..., 0])
        & (dist2 <= dist2_thres)
        & (cosine >= min_cosine)
    )

    c = jnp.cross(s, nd)
    J = jnp.concatenate([c, nd], axis=-1)
    r = jnp.sum(nd * (d - s), axis=-1)
    J = jnp.where(valid[..., None], J, 0.0)
    r = jnp.where(valid, r, 0.0)
    J = jnp.nan_to_num(J)
    r = jnp.nan_to_num(r)

    return _normal_equations_reduce(J.reshape(-1, 6), r.reshape(-1))


@functools.partial(
    jax.jit, static_argnames=("intr", "iters", "dist_thres", "angle_thres",
                              "radii"))
def estimate_transform_stencil(
    curr_pyr: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    prev_pyr: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    intr: Intr,
    iters: Tuple[int, ...] = (10, 5, 4, 0),
    dist_thres: float = 0.1,
    angle_thres: float = 0.5235988,
    radii: Tuple[int, ...] = (2, 3, 4, 6),
):
    """`estimate_transform` with stencil-select association (per-level
    window radii, coarse levels wider — they absorb the raw inter-frame
    motion, the fine levels only the residual). The fast path for the
    rigid pipeline; the gather variant remains the exact reference
    semantics."""
    dist2 = dist_thres * dist_thres
    min_cos = jnp.cos(jnp.float32(angle_thres))

    R = jnp.eye(3, dtype=jnp.float32)
    t = jnp.zeros((3,), jnp.float32)
    ok = jnp.asarray(True)

    levels = len(iters)
    for level in range(levels - 1, -1, -1):
        n_iter = iters[level]
        if n_iter == 0:
            continue
        vcurr, ncurr = curr_pyr[level]
        vprev, nprev = prev_pyr[level]
        lintr = intr.level(level)
        radius = radii[level] if level < len(radii) else radii[-1]

        def body(_, carry, vcurr=vcurr, ncurr=ncurr, vprev=vprev,
                 nprev=nprev, lintr=lintr, radius=radius):
            R, t, ok = carry
            A, b = _icp_normal_equations_stencil(
                R, t, vcurr, ncurr, vprev, nprev, lintr, dist2, min_cos,
                radius
            )
            det = jnp.linalg.det(A)
            good = ok & (jnp.abs(det) >= 1e-15) & ~jnp.isnan(det)
            x = _solve_svd(A, b)
            Rinc, tinc = se3.from_rodrigues(x[:3], x[3:])
            Rn, tn = se3.compose((Rinc, tinc), (R, t))
            return (jnp.where(good, Rn, R), jnp.where(good, tn, t), good)

        R, t, ok = jax.lax.fori_loop(0, n_iter, body, (R, t, ok))

    return (R, t), ok


def _icp_normal_equations_depth(
    aff_R, aff_t, dcurr, ncurr, dprev, nprev, intr: Intr,
    dist2_thres: float, min_cosine: float,
):
    """USE_DEPTH variant of the correspondence (proj_icp.cu:41-68): the
    current vertex comes from the depth map (reproject at own pixel), the
    previous vertex from the depth fetched at the PROJECTED pixel."""
    H, W = dcurr.shape
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    z = dcurr.astype(jnp.float32) * 0.001
    px = z * (xs - intr.cx) / intr.fx
    py = z * (ys - intr.cy) / intr.fy
    pcur = jnp.stack([px, py, z], axis=-1)
    s = _mm(pcur.reshape(-1, 3), aff_R.T).reshape(H, W, 3) + aff_t

    u = intr.fx * s[..., 0] / s[..., 2] + intr.cx
    v = intr.fy * s[..., 1] / s[..., 2] + intr.cy
    ui = jnp.floor(u).astype(jnp.int32)
    vi = jnp.floor(v).astype(jnp.int32)
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (s[..., 2] > 0)
    ui = jnp.clip(ui, 0, W - 1)
    vi = jnp.clip(vi, 0, H - 1)

    dz = dprev[vi, ui].astype(jnp.float32) * 0.001
    d = jnp.stack(
        [dz * (u - intr.cx) / intr.fx, dz * (v - intr.cy) / intr.fy, dz], -1
    )
    nd = nprev[vi, ui]

    ns = _mm(ncurr.reshape(-1, 3), aff_R.T).reshape(H, W, 3)
    diff = s - d
    dist2 = jnp.sum(diff * diff, axis=-1)
    cosine = jnp.abs(jnp.sum(ns * nd, axis=-1))
    valid = (
        (dcurr > 0) & in_img & (dz > 0) & (dist2 <= dist2_thres)
        & (cosine >= min_cosine) & ~jnp.isnan(nd[..., 0]) & ~jnp.isnan(ncurr[..., 0])
    )

    c = jnp.cross(s, nd)
    J = jnp.where(valid[..., None], jnp.concatenate([c, nd], -1), 0.0)
    r = jnp.where(valid, jnp.sum(nd * (d - s), -1), 0.0)
    J = jnp.nan_to_num(J).reshape(-1, 6)
    r = jnp.nan_to_num(r).reshape(-1)
    return _mm(J.T, J), J.T @ r


@functools.partial(
    jax.jit, static_argnames=("intr", "iters", "dist_thres", "angle_thres")
)
def estimate_transform_depth(
    curr_pyr,  # [(depth_mm, normals)] per level
    prev_pyr,
    intr: Intr,
    iters: Tuple[int, ...] = (10, 5, 4, 0),
    dist_thres: float = 0.1,
    angle_thres: float = 0.5235988,
):
    """Coarse-to-fine rigid pose estimate on DEPTH pyramids (the reference's
    USE_DEPTH build path, projective_icp.cpp:116-155). Same return contract
    as estimate_transform."""
    dist2 = dist_thres * dist_thres
    min_cos = jnp.cos(jnp.float32(angle_thres))
    R = jnp.eye(3, dtype=jnp.float32)
    t = jnp.zeros((3,), jnp.float32)
    ok = jnp.asarray(True)

    for level in range(len(iters) - 1, -1, -1):
        n_iter = iters[level]
        if n_iter == 0:
            continue
        dcurr, ncurr = curr_pyr[level]
        dprev, nprev = prev_pyr[level]
        lintr = intr.level(level)

        def body(_, carry, dcurr=dcurr, ncurr=ncurr, dprev=dprev, nprev=nprev,
                 lintr=lintr):
            R, t, ok = carry
            A, b = _icp_normal_equations_depth(
                R, t, dcurr, ncurr, dprev, nprev, lintr, dist2, min_cos
            )
            det = jnp.linalg.det(A)
            good = ok & (jnp.abs(det) >= 1e-15) & ~jnp.isnan(det)
            x = _solve_svd(A, b)
            Rinc, tinc = se3.from_rodrigues(x[:3], x[3:])
            Rn, tn = se3.compose((Rinc, tinc), (R, t))
            return (jnp.where(good, Rn, R), jnp.where(good, tn, t), good)

        R, t, ok = jax.lax.fori_loop(0, n_iter, body, (R, t, ok))
    return (R, t), ok


@functools.partial(
    jax.jit, static_argnames=("intr", "iters", "dist_thres", "angle_thres")
)
def estimate_transform(
    curr_pyr: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    prev_pyr: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    intr: Intr,
    iters: Tuple[int, ...] = (10, 5, 4, 0),
    dist_thres: float = 0.1,
    angle_thres: float = 0.5235988,  # 30 deg (KinFuParams)
):
    """Coarse-to-fine rigid pose estimate.

    Returns ((R, t), ok): the transform mapping the CURRENT camera frame into
    the PREVIOUS one, and a success flag (False = degenerate system; the
    reference aborts + resets in that case).
    """
    dist2 = dist_thres * dist_thres
    min_cos = jnp.cos(jnp.float32(angle_thres))

    R = jnp.eye(3, dtype=jnp.float32)
    t = jnp.zeros((3,), jnp.float32)
    ok = jnp.asarray(True)

    levels = len(iters)
    for level in range(levels - 1, -1, -1):
        n_iter = iters[level]
        if n_iter == 0:
            continue
        vcurr, ncurr = curr_pyr[level]
        vprev, nprev = prev_pyr[level]
        lintr = intr.level(level)

        def body(_, carry, vcurr=vcurr, ncurr=ncurr, vprev=vprev, nprev=nprev,
                 lintr=lintr):
            R, t, ok = carry
            A, b = _icp_normal_equations(
                R, t, vcurr, ncurr, vprev, nprev, lintr, dist2, min_cos
            )
            det = jnp.linalg.det(A)
            good = ok & (jnp.abs(det) >= 1e-15) & ~jnp.isnan(det)

            x = _solve_svd(A, b)
            Rinc, tinc = se3.from_rodrigues(x[:3], x[3:])
            Rn, tn = se3.compose((Rinc, tinc), (R, t))
            R_out = jnp.where(good, Rn, R)
            t_out = jnp.where(good, tn, t)
            return R_out, t_out, good

        R, t, ok = jax.lax.fori_loop(0, n_iter, body, (R, t, ok))

    return (R, t), ok
