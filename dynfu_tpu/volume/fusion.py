"""Non-rigid (warped) TSDF integration into a PERSISTENT canonical volume.

This is the DynamicFusion fusion model (Newcombe et al. 2015, §3.3) the
reference scaffolded but never built — its per-frame loop clears and
re-integrates the live depth rigidly instead, with the apology at
src/dynfu/dyn_fusion.cpp:107-116 ("FIXME... we should be warping the
canonical frame"). That workaround pins reconstruction error to the voxel
discretization floor; warped integration is the only path below it.

Per active canonical voxel x_c:
  warp x_c through the warp field (the same sequential-product DQB the rest
  of the engine uses, warp/field.py), project the warped point into the
  live depth camera, read the depth along the ray, and fold the projective
  SDF into the canonical voxel with the running weighted average + weight
  clamp of the rigid integrator (src/kfusion/cuda/tsdf_volume.cu:50-94).
  Voxels outside the warp field's support (min_k dist/dg_w >= 1, the
  unsupported rule of warp_field.cpp:34-61) are left untouched.

Formulation: the update only has effect inside the truncation band of
the canonical surface (plus a dilation margin that lets the surface GROW
into newly observed space), so the voxel set is compacted FIRST with the
bit-packed column machinery (ops/compaction.py) and all per-voxel work —
k-NN node search, DQB, projection, update — runs over the
compacted (max_active,) set, never the dense grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.core import se3
from dynfu_tpu.core.camera import Intr
from dynfu_tpu.ops import compaction
from dynfu_tpu.volume.tsdf import TsdfConfig, TsdfVolume
from dynfu_tpu.warp import field as wfield


class FusionStats(NamedTuple):
    """Observability scalars from the fused program (no host callbacks)."""

    n_band: jnp.ndarray  # () int32: voxels in the dilated active band
    n_captured: jnp.ndarray  # () int32: band voxels processed (<= capacity)
    n_updated: jnp.ndarray  # () int32: voxels whose TSDF was updated


def band_budget(config: TsdfConfig, dilate: int) -> int:
    """Per-column bit budget for the active band: the truncation band is
    ~2*trunc/voxel deep per surface crossing; allow two crossings plus the
    dilation margin."""
    import numpy as np

    depth = int(np.ceil(config.trunc_dist / config.voxel_size[2]))
    return min(config.dims[2], 8 + 4 * depth + 4 * dilate)


@functools.partial(
    jax.jit,
    static_argnames=("intr", "config", "max_active", "dilate", "knn_k", "blend",
                     "min_cos", "col_budget"),
)
def integrate_warped(
    vol: TsdfVolume,
    wf: wfield.WarpField,
    dists: jnp.ndarray,  # (H, W) float16 meters (compute_dists output)
    camera_pose: tuple,  # (R, t) world <- camera
    intr: Intr,
    config: TsdfConfig,
    *,
    normals: jnp.ndarray | None = None,  # (H, W, 3) camera-frame live normals
    min_cos: float = 0.0,
    max_active: int = 1 << 19,
    dilate: int = 2,
    knn_k: int = 4,
    col_budget: int = 0,
    blend: str = "dqb",
) -> Tuple[TsdfVolume, FusionStats]:
    """Fuse one live depth frame into the canonical volume through the warp.

    Returns (updated volume, FusionStats). n_captured < n_band signals a
    compaction-capacity overflow (un-updated band voxels); callers should
    size ``max_active`` so it stays equal to n_band.

    With ``normals`` (the live normal map) and ``min_cos`` > 0, observations
    whose view ray grazes the live surface (cos of the ray/normal angle
    below ``min_cos``) are REJECTED: projective SDF is unreliable at grazing
    incidence (the measured distance along the ray vastly overestimates the
    true surface distance), and in a persistent volume that junk
    accumulates at silhouette rims instead of being cleared next frame.
    """
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size
    H, W = dists.shape
    trunc_inv = 1.0 / config.trunc_dist

    F16, Wu8 = vol.tsdf, vol.weight

    # --- active band: observed near-surface voxels + growth margin --------
    # (W > 0) & (tsdf < 1) is the truncation band (far free space saturates
    # at exactly +1); dilation lets newly observed geometry extend it.
    band = (Wu8 > 0) & (F16 < jnp.float16(1.0))
    bw = compaction.pack_columns(band)  # (X, Y, nw)
    if dilate > 0:
        bw = compaction.dilate_z(bw, dilate, Z)
        bw = compaction.dilate_xy(bw, dilate)
    nwords = bw.shape[-1]
    # budget-free two-level rank select (ops/compaction.py extract_bits):
    # no per-column budget to overflow, so floor/wall scenes (z-parallel
    # surfaces filling whole columns) need no `col_budget` override —
    # that knob is retained in the signature and ignored. Word capacity:
    # the band's z-runs average ~11 bits/word at 512-cube, so
    # max_active // 4 words covers down to 4 bits/word before the
    # n_captured < n_band signal fires.
    flat_idx, n_band, n_captured = compaction.extract_bits(
        bw.reshape(X * Y, nwords),
        max_out=max_active,
        row_stride=Z,
        fill=X * Y * Z,
        max_words=min(X * Y * nwords, max(max_active // 4, 1 << 15)),
    )
    ok = flat_idx < X * Y * Z
    safe = jnp.where(ok, flat_idx, 0)
    vx = safe // (Y * Z)
    rem = safe - vx * (Y * Z)
    vy = rem // Z
    vz = rem - vy * Z

    # voxel CORNER coordinates in the volume frame — the rigid integrator's
    # convention (tsdf_volume.cu:60), so rigid and warped integration of an
    # identity warp agree bit-for-bit.
    p_vol = jnp.stack([vx.astype(jnp.float32) * vsx,
                       vy.astype(jnp.float32) * vsy,
                       vz.astype(jnp.float32) * vsz], axis=-1)

    # --- warp through the field ("dqb" = the engine's reference-quirk
    # sequential-product blend; "dlb" = the proper Kavan blend the SE(3)
    # solver path pairs with). ----------------------------------------------
    _, sqd, n_pos, n_dq, n_w, n_valid = wfield.neighbor_features(
        wf, p_vol, knn_k)
    blend_fn = {"dqb": wfield._dqb_from_features,
                "dlb": wfield._dlb_from_features}[blend]
    blend_dq = blend_fn(p_vol, n_pos, n_dq, n_w, n_valid)
    p_warp = dq.dq_transform_point(blend_dq, p_vol)
    # support gate: voxels outside every node's influence radius keep
    # their canonical value (warp extrapolation there is meaningless)
    ratio2 = jnp.where(n_valid, sqd / jnp.maximum(n_w * n_w, 1e-30),
                       jnp.inf)
    supported = jnp.min(ratio2, axis=-1) < 1.0

    # --- project into the live camera + projective SDF -------------------
    cam_from_vol = se3.compose(se3.inverse(camera_pose),
                               (vol.pose_r, vol.pose_t))
    R, t = cam_from_vol
    # broadcast-sum transform (an (N,3)x(3,3) HIGHEST matmul risks the
    # pathological XLA tiling documented in volume/tsdf.py)
    vc = (p_warp[:, 0:1] * R[None, :, 0] + p_warp[:, 1:2] * R[None, :, 1]
          + p_warp[:, 2:3] * R[None, :, 2] + t)
    vcx, vcy, vcz = vc[:, 0], vc[:, 1], vc[:, 2]
    u = intr.fx * vcx / vcz + intr.cx
    v = intr.fy * vcy / vcz + intr.cy
    ui = jnp.floor(u).astype(jnp.int32)  # point sampling, as the rigid path
    vi = jnp.floor(v).astype(jnp.int32)
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (vcz > 0)
    ui = jnp.clip(ui, 0, W - 1)
    vi = jnp.clip(vi, 0, H - 1)
    if normals is not None and min_cos > 0.0:
        # ray/normal obliquity as a PER-PIXEL map: the voxel's view ray
        # -vc/|vc| is the (u, v) pixel ray, so using the floor'd pixel's
        # central ray instead changes the cosine by <= 1px/f ~ 0.002 —
        # far below the gate scale. The f16 cos map rides the HIGH 16
        # bits of a packed u32 image with the f16 dists in the low bits,
        # so depth + obliquity arrive in ONE per-voxel element gather
        # (was: a 3-channel normals gather + a separate dists gather —
        # element gathers are this chip's slowest op and the band is
        # ~0.5M voxels).
        xs_r = (jnp.arange(W, dtype=jnp.float32) - intr.cx) / intr.fx
        ys_r = (jnp.arange(H, dtype=jnp.float32) - intr.cy) / intr.fy
        rn = jnp.sqrt(xs_r[None, :] ** 2 + ys_r[:, None] ** 2 + 1.0)
        cos_img = -(xs_r[None, :] * normals[..., 0]
                    + ys_r[:, None] * normals[..., 1]
                    + normals[..., 2]) / rn  # (H, W), NaN at invalid pixels
        d_bits = jax.lax.bitcast_convert_type(
            dists.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)
        c_bits = jax.lax.bitcast_convert_type(
            cos_img.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)
        packed = d_bits | jnp.left_shift(c_bits, jnp.uint32(16))
        pg = packed[vi, ui]
        Dp = jax.lax.bitcast_convert_type(
            (pg & jnp.uint32(0xFFFF)).astype(jnp.uint16),
            jnp.float16).astype(jnp.float32)
        cos_view = jax.lax.bitcast_convert_type(
            jnp.right_shift(pg, jnp.uint32(16)).astype(jnp.uint16),
            jnp.float16).astype(jnp.float32)
    else:
        Dp = dists.astype(jnp.float32)[vi, ui]
        cos_view = None
    rnorm = jnp.sqrt(vcx * vcx + vcy * vcy + vcz * vcz)
    sdf = Dp - rnorm

    update = (ok & supported & in_img & (Dp != 0)
              & (sdf >= -config.trunc_dist))
    if cos_view is not None:
        update = update & jnp.isfinite(cos_view) & (cos_view > min_cos)
        # (a projective-SDF cosine debias — sdf *= cos(ray, normal) — was
        # measured here: no improvement on the accuracy benchmarks, and it
        # breaks the identity-warp == rigid-integrator anchor invariant;
        # the obliquity gate above already rejects the biased tail)

    # --- running-average update at the compacted voxels -------------------
    tsdf_prev = F16[vx, vy, vz].astype(jnp.float32)
    w_prev = Wu8[vx, vy, vz].astype(jnp.float32)
    tsdf_in = jnp.minimum(1.0, sdf * trunc_inv)
    if cos_view is not None:
        # confidence-weighted pull: grazing observations (small ray-normal
        # cosine — motion edges, silhouette rims) contribute their value
        # at reduced strength. Weights stay the reference's uint8 counter,
        # so the confidence scales the blended VALUE, not the bookkeeping.
        conf = jnp.clip(jnp.nan_to_num(cos_view, nan=0.0), 0.0, 1.0)
        tsdf_in = tsdf_prev * (1.0 - conf) + tsdf_in * conf
    tsdf_new = (tsdf_prev * w_prev + tsdf_in) / (w_prev + 1.0)
    w_new = jnp.minimum(w_prev + 1.0, float(config.max_weight))

    tsdf_out = jnp.where(update, tsdf_new, tsdf_prev).astype(jnp.float16)
    w_out = jnp.where(update, w_new, w_prev).astype(jnp.uint8)

    # invalid slots are routed out of range so mode="drop" discards them
    vx_s = jnp.where(ok, vx, X)
    tsdf_a = F16.at[vx_s, vy, vz].set(tsdf_out, mode="drop")
    w_a = Wu8.at[vx_s, vy, vz].set(w_out, mode="drop")

    stats = FusionStats(
        n_band=n_band,
        n_captured=n_captured,
        n_updated=jnp.sum(update.astype(jnp.int32)),
    )
    return vol._replace(tsdf=tsdf_a, weight=w_a), stats
