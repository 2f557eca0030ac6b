"""TSDF volume: creation, integration, raycast, cloud/normal extraction.

Array re-design of the reference's TSDF stack:
* host class   kfusion::cuda::TsdfVolume      (src/kfusion/tsdf_volume.cpp)
* device side  TsdfIntegrator / TsdfRaycaster / FullScan6 / ExtractNormals
               (src/kfusion/cuda/tsdf_volume.cu), pack/unpack
               (include/kfusion/cuda/device.hpp:59-67)

Design (idiomatic JAX, not a port):
* The volume is a functional pytree: ``tsdf`` stored float16 — the same
  half-precision the reference packs into its ushort2 — and ``weight`` uint8
  (max_weight is 64). Arithmetic happens in float32; storage stays half to
  halve device-memory traffic, which is what bounds integrate/raycast.
* Layout is (X, Y, Z) x-major like the reference, with Z innermost — the
  z-column walk of TsdfIntegrator becomes the fastest-varying axis (Z is a
  multiple of 128 for all standard dims).
* ``integrate`` processes the volume in z-chunks under ``lax.fori_loop`` so
  peak memory stays at a few (X, Y, chunk) f32 temporaries instead of
  materializing whole-volume coordinate grids.
* ``raycast`` marches ALL rays in lock-step under one ``lax.while_loop``
  (fixed step, masked early-exit) — the batched formulation of the reference's
  divergent per-thread loop — then refines hits with trilinear interpolation
  exactly like the reference (zero-crossing secant + central-difference
  normals).
* ``extract_cloud`` replaces the warp-ballot/atomic compaction of FullScan6
  with a dense crossing mask + prefix-sum scatter into a fixed-capacity
  buffer (static shapes; same masked-capacity discipline as the reference's
  preallocated 10M-point buffer, tsdf_volume.cpp:132).

The reference hardcodes NOTHING here to 128³ — that bug class (marching
cubes' grid, internal.hpp:74) is fixed by carrying dims in TsdfConfig.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dynfu_tpu.core.camera import Intr
from dynfu_tpu.core import se3

def _chunk_size(Z: int, z_chunk: int) -> int:
    """Largest chunk <= z_chunk that DIVIDES Z. A non-divisor chunk would
    make the final dynamic_slice start clamp (XLA semantics) and silently
    misalign the read/write z-window against the computed coordinates."""
    c = min(z_chunk, Z)
    while Z % c:
        c -= 1
    return c


# geometry matmuls must be exact f32 (the default matmul precision may round
# f32 operands: TF32 on a GPU)
_hi = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_hi)

# ONE-HOT selection matmuls (0/1 matrix x payload) are BIT-exact at HIGH
# whenever the payload is float16-sourced: each output row selects exactly
# one payload element (no accumulation), and an 11-bit f16 mantissa survives
# both a TF32 operand (10 explicit mantissa bits + the implicit one) and a
# 3-pass bf16 split. chip_smoke.py checks the separable integrate bitwise
# against the gather one at 512-cube. Payloads that are NOT f16-mantissa
# (full f32 geometry) must stay on _hi.
_onehot = jax.lax.Precision.HIGH

_QNAN = jnp.float32(jnp.nan)


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """Static volume geometry + fusion params (KinFuParams subset)."""

    dims: Tuple[int, int, int] = (512, 512, 512)
    size: Tuple[float, float, float] = (3.0, 3.0, 3.0)  # meters
    trunc_dist: float = 0.04
    max_weight: int = 64
    raycast_step_factor: float = 0.75
    gradient_delta_factor: float = 0.5
    z_chunk: int = 64  # integrate loop granularity (memory/perf knob)

    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        return (
            self.size[0] / self.dims[0],
            self.size[1] / self.dims[1],
            self.size[2] / self.dims[2],
        )


class TsdfVolume(NamedTuple):
    """Functional volume state. Pose maps volume coords -> world coords
    (reference pose_, set from KinFuParams volume_pose)."""

    tsdf: jnp.ndarray  # (X, Y, Z) float16, in [-1, 1]
    weight: jnp.ndarray  # (X, Y, Z) uint8
    pose_r: jnp.ndarray  # (3, 3) float32
    pose_t: jnp.ndarray  # (3,) float32


def create(config: TsdfConfig, pose=None) -> TsdfVolume:
    X, Y, Z = config.dims
    if pose is None:
        pose = se3.identity()
    R, t = pose
    return TsdfVolume(
        tsdf=jnp.zeros((X, Y, Z), jnp.float16),
        weight=jnp.zeros((X, Y, Z), jnp.uint8),
        pose_r=jnp.asarray(R, jnp.float32),
        pose_t=jnp.asarray(t, jnp.float32),
    )


def set_pose(vol: TsdfVolume, pose) -> TsdfVolume:
    """TsdfVolume::setPose analog (tsdf_volume.hpp:30)."""
    R, t = pose
    return vol._replace(pose_r=jnp.asarray(R, jnp.float32),
                        pose_t=jnp.asarray(t, jnp.float32))


def apply_affine(vol: TsdfVolume, affine) -> TsdfVolume:
    """TsdfVolume::applyAffine analog (tsdf_volume.hpp:42): compose the
    given transform onto the volume pose."""
    R, t = se3.compose(affine, (vol.pose_r, vol.pose_t))
    return vol._replace(pose_r=R, pose_t=t)


def clear(vol: TsdfVolume) -> TsdfVolume:
    """pack_tsdf(0, 0) everywhere (clear_volume_kernel, tsdf_volume.cu:11-22)."""
    return vol._replace(
        tsdf=jnp.zeros_like(vol.tsdf), weight=jnp.zeros_like(vol.weight)
    )


# ---------------------------------------------------------------------------
# integrate — TsdfIntegrator (tsdf_volume.cu:43-121)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("config", "intr"))
def integrate(
    vol: TsdfVolume,
    dists: jnp.ndarray,  # (H, W) float16 meters (compute_dists output)
    camera_pose: tuple,  # (R, t) world <- camera
    intr: Intr,
    config: TsdfConfig,
) -> TsdfVolume:
    """Projective TSDF update with running-average weights.

    Per voxel: vc = vol2cam * voxel_corner; project; point-sample dists;
    sdf = Dp - |vc|; if sdf >= -trunc: tsdf_avg update, weight+1 clamped
    (tsdf_volume.cu:50-94). Voxel coordinate is the CORNER (x*vs, y*vs, z*vs),
    not the center — reference quirk at tsdf_volume.cu:60.
    """
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size
    H, W = dists.shape
    trunc_inv = 1.0 / config.trunc_dist

    vol2cam = se3.compose(se3.inverse(camera_pose), (vol.pose_r, vol.pose_t))
    R, t = vol2cam

    # camera-space coords built by broadcast: vc = x*Rcol0*vsx + y*Rcol1*vsy
    # + z*Rcol2*vsz + t, one (X, Y, C) plane per axis component.
    xs = jnp.arange(X, dtype=jnp.float32) * vsx  # (X,)
    ys = jnp.arange(Y, dtype=jnp.float32) * vsy  # (Y,)

    # base over (X, Y): contribution of x, y and t (z added per-chunk)
    base = (
        xs[:, None, None] * R[:, 0][None, None, :]
        + ys[None, :, None] * R[:, 1][None, None, :]
        + t[None, None, :]
    )  # (X, Y, 3)

    dists_f = dists.astype(jnp.float32)
    C = _chunk_size(Z, config.z_chunk)
    n_chunks = Z // C
    zcol = R[:, 2] * vsz  # camera-space step per +z voxel

    def body(ci, carry):
        tsdf_a, weight_a = carry
        z0 = ci * C
        zs = z0 + jnp.arange(C, dtype=jnp.int32)
        zf = zs.astype(jnp.float32)  # (C,)

        # (X, Y, C) camera coords
        vc = base[:, :, None, :] + zf[None, None, :, None] * zcol  # (X,Y,C,3)
        vcx, vcy, vcz = vc[..., 0], vc[..., 1], vc[..., 2]

        u = intr.fx * vcx / vcz + intr.cx
        v = intr.fy * vcy / vcz + intr.cy
        # point sampling = floor (CUDA point-mode tex fetch)
        ui = jnp.floor(u).astype(jnp.int32)
        vi = jnp.floor(v).astype(jnp.int32)
        in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H)
        ui = jnp.clip(ui, 0, W - 1)
        vi = jnp.clip(vi, 0, H - 1)

        Dp = dists_f[vi, ui]  # (X, Y, C) gather
        norm_vc = jnp.sqrt(vcx * vcx + vcy * vcy + vcz * vcz)
        sdf = Dp - norm_vc

        update = in_img & (Dp != 0) & (vcz > 0) & (sdf >= -config.trunc_dist)

        tsdf_prev = jax.lax.dynamic_slice_in_dim(tsdf_a, z0, C, 2).astype(jnp.float32)
        w_prev = jax.lax.dynamic_slice_in_dim(weight_a, z0, C, 2).astype(jnp.float32)

        tsdf_in = jnp.minimum(1.0, sdf * trunc_inv)
        tsdf_new = (tsdf_prev * w_prev + tsdf_in) / (w_prev + 1.0)
        w_new = jnp.minimum(w_prev + 1.0, float(config.max_weight))

        tsdf_out = jnp.where(update, tsdf_new, tsdf_prev).astype(jnp.float16)
        w_out = jnp.where(update, w_new, w_prev).astype(jnp.uint8)

        tsdf_a = jax.lax.dynamic_update_slice_in_dim(tsdf_a, tsdf_out, z0, 2)
        weight_a = jax.lax.dynamic_update_slice_in_dim(weight_a, w_out, z0, 2)
        return tsdf_a, weight_a

    tsdf_a, weight_a = jax.lax.fori_loop(0, n_chunks, body, (vol.tsdf, vol.weight))
    return vol._replace(tsdf=tsdf_a, weight=weight_a)


@functools.partial(jax.jit, static_argnames=("config", "intr", "fresh",
                                             "emit_bitplanes"))
def integrate_separable(
    vol: TsdfVolume,
    dists: jnp.ndarray,  # (H, W) float16 meters
    camera_pose: tuple,  # (R, t) — ROTATION MUST BE AXIS-ALIGNED IDENTITY
    intr: Intr,
    config: TsdfConfig,
    fresh: bool = False,
    emit_bitplanes: bool = False,
):
    """Separable fast path of `integrate` for axis-aligned poses.

    Requires rotation(inv(camera_pose) ∘ volume_pose) == I — true for the
    entire non-rigid pipeline (pose is pinned to identity, dyn_fusion.cpp:
    102-105) and for any static-camera rigid run. Callers must check; the
    engines do.

    Why this exists: the projective lookup Dp = dists[v(y,z), u(x,z)] is an
    element gather per voxel. With identity rotation the per-slab pixel map is
    SEPARABLE — u depends only on (x, z) and v only on (y, z) — so the
    point-sampled image warp factorizes into two small matmuls per z-slab
    with one-hot interpolation matrices built from iota comparisons:
        Dp[x, y; z] = sum_h sum_w Pu[x, w; z] * dists[h, w] * Pv[y, h; z].
    The update rule is bit-identical to the gather path (same floor
    sampling, same guards — out-of-image rows are all-zero, which yields
    Dp = 0, the same 'skip' the reference takes for Dp == 0).

    emit_bitplanes=True additionally returns the bit-packed z-column planes
    (ins_w, val_w) = (pack_columns(tsdf < 0), pack_columns(weight != 0)) of
    the POST-update volume, packed from the z-chunk while it is live in
    registers — the unique-edge extraction (mesh/edges.py) otherwise
    re-reads the whole stored volume (~400 MB at 512-cube) just to rebuild
    these planes. Requires the effective z-chunk to be 32-bit-word aligned;
    falls back to a post-loop pack when it is not (non-multiple-of-32 Z).
    Return becomes (vol, (ins_w, val_w)).
    """
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size
    H, W = dists.shape
    trunc_inv = 1.0 / config.trunc_dist

    vol2cam = se3.compose(se3.inverse(camera_pose), (vol.pose_r, vol.pose_t))
    _, t = vol2cam  # rotation is identity by contract

    vcx = jnp.arange(X, dtype=jnp.float32) * vsx + t[0]  # (X,)
    vcy = jnp.arange(Y, dtype=jnp.float32) * vsy + t[1]  # (Y,)
    dists_f = dists.astype(jnp.float32)

    C = _chunk_size(Z, config.z_chunk)
    n_chunks = Z // C
    iw = jnp.arange(W, dtype=jnp.int32)
    ih = jnp.arange(H, dtype=jnp.int32)

    norm_xy2 = vcx[:, None] ** 2 + vcy[None, :] ** 2  # (X, Y)

    fused_planes = emit_bitplanes and C % 32 == 0
    nw = (Z + 31) // 32

    def body(ci, carry):
        tsdf_a, weight_a, ins_a, val_a = carry
        z0 = ci * C
        zf = (z0 + jnp.arange(C)).astype(jnp.float32)
        vcz = zf * vsz + t[2]  # (C,)
        safe_z = jnp.where(vcz == 0, 1.0, vcz)

        u = intr.fx * vcx[None, :] / safe_z[:, None] + intr.cx  # (C, X)
        v = intr.fy * vcy[None, :] / safe_z[:, None] + intr.cy  # (C, Y)
        valid_u = (u >= 0) & (u < W) & (vcz[:, None] > 0)
        valid_v = (v >= 0) & (v < H)
        ui = jnp.floor(u).astype(jnp.int32)
        vi = jnp.floor(v).astype(jnp.int32)

        Pu = ((ui[..., None] == iw) & valid_u[..., None]).astype(jnp.float32)
        Pv = ((vi[..., None] == ih) & valid_v[..., None]).astype(jnp.float32)
        # (C,X,W) x (H,W) -> (C,X,H) ; x (C,Y,H) -> (X,Y,C)
        # one-hot x f16-mantissa payload: HIGH is bit-exact (see _onehot)
        T1 = jnp.einsum("cxw,hw->cxh", Pu, dists_f, precision=_onehot)
        Dp = jnp.einsum("cxh,cyh->xyc", T1, Pv, precision=_onehot)

        vcz_b = vcz[None, None, :]
        norm_vc = jnp.sqrt(norm_xy2[:, :, None] + vcz_b * vcz_b)
        sdf = Dp - norm_vc
        update = (Dp != 0) & (vcz_b > 0) & (sdf >= -config.trunc_dist)

        if fresh:
            # clear-then-integrate fused: with w_prev == 0 the running
            # average is exactly tsdf_in and w_new == 1, so skipping the
            # previous-state reads (and the separate clear's full-volume
            # write) is BIT-identical to tv.clear + integrate — the parity
            # pipeline and the rigid loop clear every frame
            # (dyn_fusion.cpp:107-116, kinfu.cpp:201-207)
            tsdf_prev = jnp.zeros((X, Y, C), jnp.float32)
            w_prev = jnp.zeros((X, Y, C), jnp.float32)
        else:
            tsdf_prev = jax.lax.dynamic_slice_in_dim(tsdf_a, z0, C, 2).astype(jnp.float32)
            w_prev = jax.lax.dynamic_slice_in_dim(weight_a, z0, C, 2).astype(jnp.float32)
        tsdf_in = jnp.minimum(1.0, sdf * trunc_inv)
        tsdf_new = (tsdf_prev * w_prev + tsdf_in) / (w_prev + 1.0)
        w_new = jnp.minimum(w_prev + 1.0, float(config.max_weight))
        tsdf_out = jnp.where(update, tsdf_new, tsdf_prev).astype(jnp.float16)
        w_out = jnp.where(update, w_new, w_prev).astype(jnp.uint8)
        tsdf_a = jax.lax.dynamic_update_slice_in_dim(tsdf_a, tsdf_out, z0, 2)
        weight_a = jax.lax.dynamic_update_slice_in_dim(weight_a, w_out, z0, 2)
        if fused_planes:
            from dynfu_tpu.ops import compaction
            ins_a = jax.lax.dynamic_update_slice_in_dim(
                ins_a, compaction.pack_columns(tsdf_out < 0), z0 // 32, 2)
            val_a = jax.lax.dynamic_update_slice_in_dim(
                val_a, compaction.pack_columns(w_out != 0), z0 // 32, 2)
        return tsdf_a, weight_a, ins_a, val_a

    plane0 = (jnp.zeros((X, Y, nw), jnp.uint32) if fused_planes
              else jnp.zeros((0,), jnp.uint32))
    tsdf_a, weight_a, ins_w, val_w = jax.lax.fori_loop(
        0, n_chunks, body, (vol.tsdf, vol.weight, plane0, plane0))
    out = vol._replace(tsdf=tsdf_a, weight=weight_a)
    if not emit_bitplanes:
        return out
    if not fused_planes:  # unaligned chunk: pack from the stored volume
        from dynfu_tpu.ops import compaction
        ins_w = compaction.pack_columns(tsdf_a < 0)
        val_w = compaction.pack_columns(weight_a != 0)
    return out, (ins_w, val_w)


# ---------------------------------------------------------------------------
# rotation support for the separable paths: homography re-mapping
#
# Rotating the camera about its center only permutes RAY DIRECTIONS; the
# `dists` image stores the radial ray length, which is rotation-invariant.
# So integrating with a rotated camera equals integrating axis-aligned with
# the dists image warped by the pure-rotation homography H = K R K^-1 —
# a (H, W) image resample (trivial traffic) instead of a (X, Y, Z) volume
# gather. Same factorization applies to raycast: march on a virtual
# axis-aligned grid that covers the rotated frustum, then re-map the
# point/normal images to the real pixel grid and rotate the vectors.
# Valid while the rotation keeps the real frustum inside the (padded)
# virtual one — ~45 degrees of camera tilt; beyond that the engines fall
# back to the generic gather paths.
# ---------------------------------------------------------------------------


def _kmat(intr: Intr):
    return jnp.asarray(
        [[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]],
        jnp.float32,
    )


def _kmat_inv(intr: Intr):
    return jnp.asarray(
        [[1.0 / intr.fx, 0.0, -intr.cx / intr.fx],
         [0.0, 1.0 / intr.fy, -intr.cy / intr.fy],
         [0.0, 0.0, 1.0]],
        jnp.float32,
    )


def _rotation_homography(R_rel: jnp.ndarray, intr_dst: Intr,
                         intr_src: Intr | None = None):
    """Pixel map u_dst = K_dst R K_src^-1 u_src (same-K rotation warp when
    intr_src is omitted)."""
    return _mm(_kmat(intr_dst), _mm(R_rel, _kmat_inv(intr_src or intr_dst)))


def _homography_pixels(Hmat: jnp.ndarray, out_shape, in_extent):
    """Apply the pixel homography over an (Ho, Wo) grid: (px, py, ok) with
    ok false behind the plane-at-infinity or outside [0, Wi) x [0, Hi)."""
    Ho, Wo = out_shape
    Hi_ext, Wi_ext = in_extent  # EXCLUSIVE upper bounds (float)
    u = jnp.arange(Wo, dtype=jnp.float32)[None, :]
    v = jnp.arange(Ho, dtype=jnp.float32)[:, None]
    x = Hmat[0, 0] * u + Hmat[0, 1] * v + Hmat[0, 2]
    y = Hmat[1, 0] * u + Hmat[1, 1] * v + Hmat[1, 2]
    w = Hmat[2, 0] * u + Hmat[2, 1] * v + Hmat[2, 2]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1.0, w)
    px = x / safe_w
    py = y / safe_w
    ok = (w > 1e-12) & (px >= 0) & (py >= 0) & (px < Wi_ext) & (py < Hi_ext)
    return px, py, ok


def _warp_image_nearest(img: jnp.ndarray, Hmat: jnp.ndarray, out_shape):
    """out[v', u'] = img[H(u', v')] with nearest (floor) sampling; 0 outside.

    One small-image gather (~3e5 elements), exactly mirroring the
    reference's point-mode fetches.
    """
    Hi, Wi = img.shape
    px, py, ok = _homography_pixels(Hmat, out_shape, (float(Hi), float(Wi)))
    xi = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, Wi - 1)
    yi = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, Hi - 1)
    out = img[yi, xi]
    return jnp.where(ok, out, jnp.zeros((), img.dtype))


def _vol2cam_rotation_split(vol: TsdfVolume, camera_pose):
    """Factor vol2cam = (R', t') as R' ∘ (I, R'^T t'): the virtual
    axis-aligned camera shares the real camera CENTER (-R'^T t' in volume
    coords), and the rotation moves into the image-plane homography.
    Returns (R', virtual camera pose)."""
    vol2cam = se3.compose(se3.inverse(camera_pose), (vol.pose_r, vol.pose_t))
    R_rel, t_rel = vol2cam
    t_virt = _mm(R_rel.T, t_rel)
    # virtual camera pose cam' with inv(cam') ∘ vol_pose == (I, t_virt)
    virt = se3.compose((vol.pose_r, vol.pose_t), (jnp.eye(3), -t_virt))
    return R_rel, virt


@functools.partial(jax.jit, static_argnames=("config", "intr", "fresh",
                                             "emit_bitplanes"))
def integrate_rotated(
    vol: TsdfVolume,
    dists: jnp.ndarray,
    camera_pose: tuple,
    intr: Intr,
    config: TsdfConfig,
    fresh: bool = False,
    emit_bitplanes: bool = False,
):
    """Rotated-camera integrate on the separable path: warp the dists
    image by the rotation homography, then run integrate_separable from the
    equivalent axis-aligned camera. sdf uses |vc|, which is rotation
    invariant, so the update is mathematically identical up to the pixel
    quantization of one image resample."""
    R_rel, virt_pose = _vol2cam_rotation_split(vol, camera_pose)
    Hmat = _rotation_homography(R_rel, intr)
    warped = _warp_image_nearest(dists, Hmat, dists.shape)
    return integrate_separable(vol, warped, virt_pose, intr, config,
                               fresh=fresh, emit_bitplanes=emit_bitplanes)


@functools.partial(jax.jit, static_argnames=("config", "intr", "shape", "fov_margin"))
def raycast_rotated(
    vol: TsdfVolume,
    camera_pose: tuple,
    intr: Intr,
    shape: Tuple[int, int],
    config: TsdfConfig,
    fov_margin: float = 1.6,
):
    """Rotated-camera raycast via a virtual axis-aligned march.

    Runs raycast_separable on an enlarged virtual image (same focal length,
    fov_margin x the pixel extent, recentred) whose frustum covers the
    rotated real frustum for tilts up to ~atan(margin) - fov/2; then maps
    each real pixel into the virtual image (homography, nearest sample) and
    rotates points/normals into the real camera frame.
    """
    H, W = shape
    Hv = int(H * fov_margin) // 8 * 8 + 8
    Wv = int(W * fov_margin) // 8 * 8 + 8
    vintr = Intr(intr.fx, intr.fy, Wv / 2 - 0.5, Hv / 2 - 0.5)

    R_rel, virt_pose = _vol2cam_rotation_split(vol, camera_pose)
    pts_v, nrm_v = raycast_separable(vol, virt_pose, vintr, (Hv, Wv), config)

    # real pixel -> virtual pixel: u' = Kv R_rel^T K^-1 u
    M = _rotation_homography(R_rel.T, vintr, intr)
    px, py, ok = _homography_pixels(
        M, (H, W), (float(Hv - 1) + 1e-6, float(Wv - 1) + 1e-6))
    x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, Wv - 2)
    y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, Hv - 2)
    a = jnp.clip(px - x0, 0.0, 1.0)[..., None]
    b = jnp.clip(py - y0, 0.0, 1.0)[..., None]

    # validity-weighted bilinear over the 4 neighbors (nearest re-mapping
    # would quantize ray directions by half a pixel — millimeters at range),
    # with the max-weight valid tap tracked in the SAME pass (each tap is a
    # (H, W) gather — fetching them once, not twice, matters here)
    wts = [(1 - a) * (1 - b), a * (1 - b), (1 - a) * b, a * b]
    taps = [(0, 0), (0, 1), (1, 0), (1, 1)]
    psum = jnp.zeros((H, W, 3), jnp.float32)
    nsum = jnp.zeros((H, W, 3), jnp.float32)
    wsum = jnp.zeros((H, W, 1), jnp.float32)
    zmin = jnp.full((H, W), jnp.inf)
    zmax = jnp.full((H, W), -jnp.inf)
    best_p = jnp.full((H, W, 3), jnp.nan)
    best_n = jnp.full((H, W, 3), jnp.nan)
    best_w = jnp.full((H, W, 1), -1.0)
    for wt, (dy, dx) in zip(wts, taps):
        pv = pts_v[y0 + dy, x0 + dx]
        nv = nrm_v[y0 + dy, x0 + dx]
        valid = ~jnp.isnan(pv[..., :1])
        wv = jnp.where(valid, wt, 0.0)
        psum = psum + jnp.nan_to_num(pv) * wv
        nsum = nsum + jnp.nan_to_num(nv) * wv
        wsum = wsum + wv
        zv = jnp.where(valid[..., 0], pv[..., 2], jnp.nan)
        zmin = jnp.minimum(zmin, jnp.nan_to_num(zv, nan=jnp.inf))
        zmax = jnp.maximum(zmax, jnp.nan_to_num(zv, nan=-jnp.inf))
        wb = jnp.where(valid, wt, -2.0)
        takebest = wb > best_w
        best_p = jnp.where(takebest, pv, best_p)
        best_n = jnp.where(takebest, nv, best_n)
        best_w = jnp.where(takebest, wb, best_w)
    good = ok & (wsum[..., 0] > 0.5)  # majority of bilinear mass valid
    p = psum / jnp.maximum(wsum, 1e-12)
    n = nsum / jnp.maximum(
        jnp.linalg.norm(nsum, axis=-1, keepdims=True), 1e-12
    )
    # silhouette guard: where the 4 taps straddle a depth discontinuity the
    # blend is a phantom mid-air point — use the max-weight valid tap instead
    edge = (zmax - zmin) > 4.0 * max(config.voxel_size)
    p = jnp.where(edge[..., None], best_p, p)
    n = jnp.where(edge[..., None], best_n, n)
    good = good & ~jnp.isnan(p[..., 0])
    # virtual camera frame -> real camera frame: p_real = R_rel @ p_virtual
    p = _mm(p.reshape(-1, 3), R_rel.T).reshape(H, W, 3)
    n = _mm(n.reshape(-1, 3), R_rel.T).reshape(H, W, 3)
    return (
        jnp.where(good[..., None], p, _QNAN),
        jnp.where(good[..., None], n, _QNAN),
    )


# ---------------------------------------------------------------------------
# trilinear interpolation — device interpolate (tsdf_volume.cu:146-171)
# ---------------------------------------------------------------------------


def interpolate(tsdf: jnp.ndarray, p_voxels: jnp.ndarray) -> jnp.ndarray:
    """Trilinear TSDF lookup at fractional voxel coords (..., 3).

    NaN outside [0, dims-1) on any axis, like the reference.
    """
    X, Y, Z = tsdf.shape
    g = jnp.floor(p_voxels).astype(jnp.int32)
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    inside = (
        (gx >= 0) & (gx < X - 1) & (gy >= 0) & (gy < Y - 1) & (gz >= 0) & (gz < Z - 1)
    )
    gx = jnp.clip(gx, 0, X - 2)
    gy = jnp.clip(gy, 0, Y - 2)
    gz = jnp.clip(gz, 0, Z - 2)
    a = p_voxels[..., 0] - gx
    b = p_voxels[..., 1] - gy
    c = p_voxels[..., 2] - gz

    def f(dx, dy, dz):
        return tsdf[gx + dx, gy + dy, gz + dz].astype(jnp.float32)

    out = (
        f(0, 0, 0) * (1 - a) * (1 - b) * (1 - c)
        + f(0, 0, 1) * (1 - a) * (1 - b) * c
        + f(0, 1, 0) * (1 - a) * b * (1 - c)
        + f(0, 1, 1) * (1 - a) * b * c
        + f(1, 0, 0) * a * (1 - b) * (1 - c)
        + f(1, 0, 1) * a * (1 - b) * c
        + f(1, 1, 0) * a * b * (1 - c)
        + f(1, 1, 1) * a * b * c
    )
    return jnp.where(inside, out, _QNAN)


def _fetch_nearest(tsdf: jnp.ndarray, p_voxels: jnp.ndarray) -> jnp.ndarray:
    """Round-to-nearest point fetch (TsdfRaycaster::fetch_tsdf)."""
    X, Y, Z = tsdf.shape
    g = jnp.rint(p_voxels).astype(jnp.int32)
    gx = jnp.clip(g[..., 0], 0, X - 1)
    gy = jnp.clip(g[..., 1], 0, Y - 1)
    gz = jnp.clip(g[..., 2], 0, Z - 1)
    return tsdf[gx, gy, gz].astype(jnp.float32)


# ---------------------------------------------------------------------------
# raycast — TsdfRaycaster (tsdf_volume.cu:173-386)
# ---------------------------------------------------------------------------


def _ray_box(ray_org, ray_dir, box_max):
    """Slab intersection against [0, box_max] (intersect, tsdf_volume.cu:127-144)."""
    inv = 1.0 / ray_dir
    tbot = inv * (0.0 - ray_org)
    ttop = inv * (box_max - ray_org)
    tmin3 = jnp.minimum(ttop, tbot)
    tmax3 = jnp.maximum(ttop, tbot)
    # NB the reference computes max(max(x,y), max(x,z)) — keep exact form
    tnear = jnp.maximum(
        jnp.maximum(tmin3[..., 0], tmin3[..., 1]),
        jnp.maximum(tmin3[..., 0], tmin3[..., 2]),
    )
    tfar = jnp.minimum(
        jnp.minimum(tmax3[..., 0], tmax3[..., 1]),
        jnp.minimum(tmax3[..., 0], tmax3[..., 2]),
    )
    return tnear, tfar


def _compute_normal(tsdf, vertex, voxel_size_inv, gradient_delta):
    """Central-difference TSDF gradient, normalized (tsdf_volume.cu:330-346)."""
    comps = []
    for axis in range(3):
        off = jnp.zeros((3,), jnp.float32).at[axis].set(gradient_delta[axis])
        f1 = interpolate(tsdf, (vertex + off) * voxel_size_inv)
        f2 = interpolate(tsdf, (vertex - off) * voxel_size_inv)
        comps.append((f1 - f2) / gradient_delta[axis])
    n = jnp.stack(comps, axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def _slab_sweep(slabs, n_chunks: int, chunk: int, sample_fn, H: int, W: int):
    """The zero-crossing state machine shared by `raycast` and
    `raycast_separable`: walk the sampled slabs in chunks, `sample_fn(g,
    slab) -> (f, gx, gy, valid)` evaluates one slab for every ray, and the
    carry records for each ray the FIRST +/- crossing (slab index, linear
    fraction, the flanking samples and in-plane gradients) while a later
    backface crossing only stops the ray."""
    zero = jnp.zeros((H, W), jnp.float32)
    # SLIM carry (round 5): the flanking samples/gradients (f_a, f_b,
    # gx_a/b, gy_a/b — 6 fields) are only ever consumed as their
    # take-time lerp, so the lerp happens AT the take and the carry holds
    # the 3 resolved normal components instead. Every carry field costs a
    # full-image where per SLAB (103 slabs at 512-cube) — the sweep's
    # dominant HBM traffic — so 14 -> 11 fields is a direct ~20% cut.
    carry0 = dict(
        f_prev=jnp.full((H, W), 1.0, jnp.float32),
        gx_prev=zero, gy_prev=zero,
        valid_prev=jnp.zeros((H, W), bool),
        found=jnp.zeros((H, W), bool),
        hit=jnp.zeros((H, W), bool),
        k_hit=jnp.zeros((H, W), jnp.int32),
        frac=zero, gx_h=zero, gy_h=zero, gz_h=zero,
    )

    def chunk_body(c, carry):
        block = jax.lax.dynamic_slice_in_dim(slabs, c * chunk, chunk, 0)
        for j in range(chunk):
            g = c * chunk + j
            f, gx, gy, valid = sample_fn(g, block[j])
            both = carry["valid_prev"] & valid
            crossing = both & (carry["f_prev"] > 0.0) & (f < 0.0)
            backface = both & (carry["f_prev"] < 0.0) & (f > 0.0)
            take = ~carry["found"] & crossing
            stop = crossing | backface
            fr = carry["f_prev"] / (carry["f_prev"] - f + 1e-30)
            carry = dict(
                f_prev=f, gx_prev=gx, gy_prev=gy, valid_prev=valid,
                found=carry["found"] | stop,
                hit=jnp.where(take, True, carry["hit"]),
                k_hit=jnp.where(take, g - 1, carry["k_hit"]),
                frac=jnp.where(take, fr, carry["frac"]),
                gx_h=jnp.where(
                    take, carry["gx_prev"] * (1 - fr) + gx * fr,
                    carry["gx_h"]),
                gy_h=jnp.where(
                    take, carry["gy_prev"] * (1 - fr) + gy * fr,
                    carry["gy_h"]),
                gz_h=jnp.where(take, f - carry["f_prev"], carry["gz_h"]),
            )
        return carry

    return jax.lax.fori_loop(0, n_chunks, chunk_body, carry0)


def _sweep_outputs(s, slab_dz: float):
    """(hit, z_star, normal, ok) from a `_slab_sweep` carry: the crossing
    depth by linear interpolation between the flanking slabs, and the TSDF
    gradient (in-plane gradients lerped in z + inter-slab difference) as
    the surface normal."""
    hit = s["hit"]
    z_star = (s["k_hit"].astype(jnp.float32) + s["frac"]) * slab_dz
    gz = s["gz_h"] / slab_dz
    normal = jnp.stack([s["gx_h"], s["gy_h"], gz], axis=-1)
    nn = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / jnp.where(nn > 0, nn, 1.0)
    ok = hit & (nn[..., 0] > 0) & ~jnp.isnan(jnp.sum(normal, axis=-1))
    return hit, z_star, normal, ok


@functools.partial(jax.jit, static_argnames=("config", "intr", "shape"))
def raycast(
    vol: TsdfVolume,
    camera_pose: tuple,  # (R, t) world <- camera
    intr: Intr,
    shape: Tuple[int, int],
    config: TsdfConfig,
):
    """Per-pixel surface raycast; returns (points (H,W,3), normals (H,W,3))
    in the CAMERA frame, NaN where no surface (reference points variant,
    tsdf_volume.cu:262-327).

    Z-slab sweep, not a per-ray march. The reference marches each ray
    independently with nearest-voxel fetches (divergent CUDA loop); a
    literal translation bottoms out in scattered element gathers across the
    whole volume. So the sweep reorders the computation around the memory
    system:

    1. slab extraction: one strided slice + transpose materializes the
       sampled z-slabs as (S, Y, X) — sequential traffic at full
       bandwidth. The slab stride m approximates the reference's step
       (trunc_dist * raycast_step_factor, in voxels).
    2. sweep: a short fori_loop walks slab chunks; every sample is a
       bilinear fetch of 4 corners from ONE (Y, X) slab (0.5 MB, small
       enough to stay cached). All rays advance in lock-step
       through the same slab, so the working set per step is exactly one
       slab instead of the whole volume.
    3. crossing + refinement: consecutive slab samples give the zero
       crossing by linear interpolation in z — together with the in-plane
       bilinear this IS the trilinear interpolation the reference applies in
       its secant refinement (tsdf_volume.cu:240-247). The TSDF gradient
       (surface normal) falls out of the same 4 corners per slab (in-plane
       differences) plus the inter-slab difference — no extra volume reads,
       where the reference pays 6 more trilinear interpolations
       (compute_normal, tsdf_volume.cu:330-346).

    Requires rays with positive z-direction in the volume frame (camera
    facing the volume, the geometry of every reference config); rays with
    dir_z <= 0 report no surface.
    """
    H, W = shape
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size

    cam2vol = se3.compose(se3.inverse((vol.pose_r, vol.pose_t)), camera_pose)
    R, t = cam2vol
    Rinv = R.T  # rotations: inverse == transpose (reference uses SVD inverse)

    # ray directions: R * reproject(x, y, 1), normalized
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    dx = (xs - intr.cx) / intr.fx
    dy = (ys - intr.cy) / intr.fy
    d = jnp.stack([jnp.broadcast_to(dx, (H, W)), jnp.broadcast_to(dy, (H, W)),
                   jnp.ones((H, W), jnp.float32)], axis=-1)
    ray_dir = _mm(d, R.T)
    ray_dir = ray_dir / jnp.linalg.norm(ray_dir, axis=-1, keepdims=True)
    ray_org = t  # (3,)

    # slab stride ~ reference step length, in voxels (>= 1)
    time_step = config.trunc_dist * config.raycast_step_factor
    m = max(1, int(round(time_step / vsz)))
    S = (Z - 1) // m + 1  # sampled slabs at z = (k*m)*vsz
    CH = 16
    n_chunks = (S + CH - 1) // CH
    S_pad = n_chunks * CH

    # (S, Y, X) sampled-slab stack: strided slice + transpose, plain
    # sequential HBM traffic. Padded with +1 (empty space) slabs.
    slabs = jnp.transpose(vol.tsdf[:, :, ::m], (2, 1, 0)).astype(jnp.float16)
    pad = S_pad + 1 - slabs.shape[0]
    slabs = jnp.pad(slabs, ((0, pad), (0, 0), (0, 0)), constant_values=1.0)

    dz = ray_dir[..., 2]
    fwd = dz > 1e-6
    safe_dz = jnp.where(fwd, dz, 1.0)

    def slab_sample(g, slab):
        """Bilinear sample of one (Y, X) slab for all rays at slab index g.
        Returns f (H, W), in-plane gradient (gx, gy), validity mask."""
        z = (g * m) * vsz
        srel = (z - ray_org[2]) / safe_dz  # meters along ray
        px = (ray_org[0] + ray_dir[..., 0] * srel) / vsx  # voxel coords
        py = (ray_org[1] + ray_dir[..., 1] * srel) / vsy
        valid = fwd & (srel > 0.0) & (px >= 0) & (px <= X - 1 - 1e-4) & \
            (py >= 0) & (py <= Y - 1 - 1e-4)
        x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, X - 2)
        y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, Y - 2)
        a = jnp.clip(px - x0, 0.0, 1.0)
        b = jnp.clip(py - y0, 0.0, 1.0)
        f00 = slab[y0, x0].astype(jnp.float32)
        f01 = slab[y0, x0 + 1].astype(jnp.float32)
        f10 = slab[y0 + 1, x0].astype(jnp.float32)
        f11 = slab[y0 + 1, x0 + 1].astype(jnp.float32)
        f = (f00 * (1 - a) + f01 * a) * (1 - b) + (f10 * (1 - a) + f11 * a) * b
        gx = ((f01 - f00) * (1 - b) + (f11 - f10) * b) / vsx
        gy = ((f10 - f00) * (1 - a) + (f11 - f01) * a) / vsy
        return jnp.where(valid, f, 1.0), gx, gy, valid

    s = _slab_sweep(slabs, n_chunks, CH, slab_sample, H, W)
    _, z_star, normal, ok = _sweep_outputs(s, m * vsz)

    # hit position: z* between slabs k and k+1 by linear interpolation
    s_star = (z_star - ray_org[2]) / safe_dz
    vertex = ray_org + ray_dir * s_star[..., None]

    # back to camera frame: v = Rinv (vertex - t), n = Rinv n
    v_cam = _mm(vertex - ray_org, Rinv.T)
    n_cam = _mm(normal, Rinv.T)
    points = jnp.where(ok[..., None], v_cam, _QNAN)
    normals = jnp.where(ok[..., None], n_cam, _QNAN)
    return points, normals


@functools.partial(jax.jit, static_argnames=("config", "intr", "shape"))
def raycast_separable(
    vol: TsdfVolume,
    camera_pose: tuple,  # (R, t) — ROTATION MUST BE AXIS-ALIGNED IDENTITY
    intr: Intr,
    shape: Tuple[int, int],
    config: TsdfConfig,
):
    """Separable fast path of `raycast` for axis-aligned poses.

    Requires rotation(inv(volume_pose) ∘ camera_pose) == I (the non-rigid
    pipeline's permanent state; callers must check — the engines do).

    Parameterizing rays by volume z (pos = o + q * (z - o_z) with
    q = ((u-cx)/fx, (v-cy)/fy, 1)) makes the per-slab sample positions
    SEPARABLE: x depends only on (u, z), y only on (v, z). Each z-slab is
    then resampled into the image by two bilinear-matrix matmuls, and the
    in-plane TSDF gradient reuses the same factor matrices with derivative
    weights — the whole raycast is matmul + elementwise, no gathers.
    Crossing detection and z-linear refinement match the sweep path.
    """
    H, W = shape
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size

    cam2vol = se3.compose(se3.inverse((vol.pose_r, vol.pose_t)), camera_pose)
    _, t = cam2vol  # rotation is identity by contract
    qx = (jnp.arange(W, dtype=jnp.float32) - intr.cx) / intr.fx  # (W,)
    qy = (jnp.arange(H, dtype=jnp.float32) - intr.cy) / intr.fy  # (H,)

    time_step = config.trunc_dist * config.raycast_step_factor
    m = max(1, int(round(time_step / vsz)))
    S = (Z - 1) // m + 1
    CH = 8
    n_chunks = (S + CH - 1) // CH
    S_pad = n_chunks * CH

    slabs = jnp.transpose(vol.tsdf[:, :, ::m], (2, 1, 0)).astype(jnp.float32)
    pad = S_pad + 1 - slabs.shape[0]
    slabs = jnp.pad(slabs, ((0, pad), (0, 0), (0, 0)), constant_values=1.0)

    ix = jnp.arange(X, dtype=jnp.int32)
    iy = jnp.arange(Y, dtype=jnp.int32)

    def factor_matrices(g):
        """Bilinear + derivative matrices for slab g: Bu (W, X), Bv (H, Y)."""
        z = (g * m) * vsz
        dzo = z - t[2]
        px = (t[0] + qx * dzo) / vsx  # (W,)
        py = (t[1] + qy * dzo) / vsy  # (H,)
        valid_u = (dzo > 0) & (px >= 0) & (px <= X - 1)
        valid_v = (py >= 0) & (py <= Y - 1)
        x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, X - 2)
        y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, Y - 2)
        a = jnp.clip(px - x0, 0.0, 1.0)
        b = jnp.clip(py - y0, 0.0, 1.0)
        e0u = (x0[:, None] == ix).astype(jnp.float32)
        e1u = (x0[:, None] + 1 == ix).astype(jnp.float32)
        e0v = (y0[:, None] == iy).astype(jnp.float32)
        e1v = (y0[:, None] + 1 == iy).astype(jnp.float32)
        Bu = e0u * (1 - a)[:, None] + e1u * a[:, None]
        Bv = e0v * (1 - b)[:, None] + e1v * b[:, None]
        Gu = (e1u - e0u) / vsx  # d/dx weights
        Gv = (e1v - e0v) / vsy
        return Bu, Bv, Gu, Gv, valid_u, valid_v

    # DEFAULT (single-pass bf16 or TF32) for the slab resampling: TSDF
    # values are in [-1, 1] and bilinear weights in [0, 1], so the <= 2^-8
    # relative contraction error moves the detected crossing by < 0.5% of a cell
    # (~0.03 mm) — far below the slab-interpolation model error and the
    # 5.9 mm voxel. On the depth-diverse rigid scene the ATE moved 4.73 mm
    # vs 4.95 at HIGH, i.e. inside scene noise.
    _mmr = functools.partial(jnp.matmul, precision=jax.lax.Precision.DEFAULT)

    def slab_sample(g, slab):
        """f, gx, gy, valid for slab g over the full image — 4 matmuls."""
        Bu, Bv, Gu, Gv, valid_u, valid_v = factor_matrices(g)
        T1 = _mmr(slab, Bu.T)  # (Y, X)@(X, W) -> (Y, W)
        T1g = _mmr(slab, Gu.T)  # (Y, W)
        f = _mmr(Bv, T1)  # (H, Y)@(Y, W) -> (H, W)
        gx = _mmr(Bv, T1g)
        gy = _mmr(Gv, T1)
        valid = valid_v[:, None] & valid_u[None, :]
        return jnp.where(valid, f, 1.0), gx, gy, valid

    s = _slab_sweep(slabs, n_chunks, CH, slab_sample, H, W)
    _, z_star, normal, ok = _sweep_outputs(s, m * vsz)

    dzo = z_star - t[2]
    vx = t[0] + qx[None, :] * dzo
    vy = t[1] + qy[:, None] * dzo
    vertex = jnp.stack([vx, vy, jnp.broadcast_to(z_star, (H, W))], axis=-1)

    v_cam = vertex - t  # cam2vol = (I, t)
    points = jnp.where(ok[..., None], v_cam, _QNAN)
    normals = jnp.where(ok[..., None], normal, _QNAN)
    return points, normals


@functools.partial(jax.jit, static_argnames=("config", "intr", "shape"))
def raycast_march(
    vol: TsdfVolume,
    camera_pose: tuple,
    intr: Intr,
    shape: Tuple[int, int],
    config: TsdfConfig,
):
    """Arbitrary-direction per-ray march — the correctness fallback.

    Lock-step translation of the reference's TsdfRaycaster loop
    (tsdf_volume.cu:262-327): fixed-step nearest-voxel march from the ray/box
    entry, first +/- crossing wins, secant refinement, central-difference
    normals. Handles ANY pose (including rays with non-positive volume-z,
    which the slab-sweep paths cannot march) at the cost of big-table
    element gathers — use only when the sweep/homography paths don't apply.
    """
    H, W = shape
    vs = jnp.asarray(config.voxel_size, jnp.float32)
    vs_inv = 1.0 / vs
    dims = jnp.asarray(config.dims, jnp.float32)
    time_step = config.trunc_dist * config.raycast_step_factor
    gradient_delta = vs * config.gradient_delta_factor
    box_max = vs * dims - vs

    cam2vol = se3.compose(se3.inverse((vol.pose_r, vol.pose_t)), camera_pose)
    R, t = cam2vol
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    d = jnp.stack([
        jnp.broadcast_to((xs - intr.cx) / intr.fx, (H, W)),
        jnp.broadcast_to((ys - intr.cy) / intr.fy, (H, W)),
        jnp.ones((H, W), jnp.float32),
    ], axis=-1)
    ray_dir = _mm(d.reshape(-1, 3), R.T).reshape(H, W, 3)
    ray_dir = ray_dir / jnp.linalg.norm(ray_dir, axis=-1, keepdims=True)
    ray_org = t

    tmin, tmax = _ray_box(ray_org, ray_dir, box_max)
    tmin = jnp.maximum(0.0, tmin)
    tmax = tmax - time_step

    diag = (config.size[0] ** 2 + config.size[1] ** 2 + config.size[2] ** 2) ** 0.5
    n_steps = int(diag / time_step) + 2

    def fetch(p):
        return _fetch_nearest(vol.tsdf, p * vs_inv)

    pos0 = ray_org + ray_dir * tmin[..., None]
    state0 = dict(
        tcurr=tmin, f_prev=fetch(pos0),
        active=tmin < tmax,
        hit=jnp.zeros((H, W), bool), t_hit=jnp.zeros((H, W), jnp.float32),
    )

    def cond(s):
        return jnp.any(s["active"])

    def body(s):
        tnext = s["tcurr"] + time_step
        f = fetch(ray_org + ray_dir * tnext[..., None])
        crossing = s["active"] & (s["f_prev"] > 0.0) & (f < 0.0)
        backface = s["active"] & (s["f_prev"] < 0.0) & (f > 0.0)
        return dict(
            tcurr=tnext, f_prev=f,
            active=s["active"] & ~crossing & ~backface & (tnext < s_tmax),
            hit=s["hit"] | crossing,
            t_hit=jnp.where(crossing, s["tcurr"], s["t_hit"]),
        )

    s_tmax = tmax
    s = jax.lax.while_loop(cond, body, state0)

    curr = ray_org + ray_dir * s["t_hit"][..., None]
    nxt = curr + ray_dir * time_step
    Ft = interpolate(vol.tsdf, curr * vs_inv)
    Ftdt = interpolate(vol.tsdf, nxt * vs_inv)
    Ts = s["t_hit"] - time_step * Ft / (Ftdt - Ft)
    vertex = ray_org + ray_dir * Ts[..., None]
    normal = _compute_normal(vol.tsdf, vertex, vs_inv, gradient_delta)

    ok = s["hit"] & ~jnp.isnan(jnp.sum(normal, axis=-1))
    v_cam = _mm((vertex - ray_org).reshape(-1, 3), R).reshape(H, W, 3)
    n_cam = _mm(normal.reshape(-1, 3), R).reshape(H, W, 3)
    return (
        jnp.where(ok[..., None], v_cam, _QNAN),
        jnp.where(ok[..., None], n_cam, _QNAN),
    )


@functools.partial(jax.jit, static_argnames=("config", "intr", "shape"))
def raycast_depth(vol, camera_pose, intr, shape, config):
    """Depth-map raycast variant (ushort mm, 0 = miss) — tsdf_volume.cu:196-256."""
    points, normals = raycast(vol, camera_pose, intr, shape, config)
    z = points[..., 2]
    depth = jnp.where(jnp.isnan(z), 0, (z * 1000.0).astype(jnp.int32))
    return depth, normals


# ---------------------------------------------------------------------------
# cloud / normal extraction — FullScan6 + ExtractNormals (tsdf_volume.cu:423-679)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("config", "capacity"))
def extract_cloud(vol: TsdfVolume, config: TsdfConfig, capacity: int = 1 << 18):
    """Zero-crossing points along +x/+y/+z edges, world frame.

    Emits the linear interpolation p = (V*|Fn| + Vn*|F|) / (|F|+|Fn|) between
    VOXEL CENTERS (+0.5) wherever both endpoint weights are nonzero, neither
    tsdf is exactly 1, and the signs differ (FullScan6, tsdf_volume.cu:460-530).
    Returns (points (capacity, 3), mask (capacity,)).
    """
    X, Y, Z = config.dims
    vs = jnp.asarray(config.voxel_size, jnp.float32)
    F = vol.tsdf.astype(jnp.float32)
    Wt = vol.weight

    valid = (Wt != 0) & (F != 1.0)

    def axis_points(axis):
        # F at voxel and neighbor along +axis
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(0, -1)
        sl_hi[axis] = slice(1, None)
        F0, F1 = F[tuple(sl_lo)], F[tuple(sl_hi)]
        ok = (
            valid[tuple(sl_lo)]
            & valid[tuple(sl_hi)]
            & (((F0 > 0) & (F1 < 0)) | ((F0 < 0) & (F1 > 0)))
        )
        if axis != 2:
            # parity: FullScan6's z loop stops at dims.z - 2, so +x/+y
            # crossings in the LAST z layer are never emitted
            # (tsdf_volume.cu:460)
            ok = ok & (
                jax.lax.broadcasted_iota(jnp.int32, ok.shape, 2) < Z - 1
            )
        shape = ok.shape
        # voxel-center coordinates
        cx = (jnp.arange(shape[0], dtype=jnp.float32) + 0.5)[:, None, None]
        cy = (jnp.arange(shape[1], dtype=jnp.float32) + 0.5)[None, :, None]
        cz = (jnp.arange(shape[2], dtype=jnp.float32) + 0.5)[None, None, :]
        base = [
            jnp.broadcast_to(cx, shape) * vs[0],
            jnp.broadcast_to(cy, shape) * vs[1],
            jnp.broadcast_to(cz, shape) * vs[2],
        ]
        d_inv = 1.0 / (jnp.abs(F0) + jnp.abs(F1))
        interp = (base[axis] * jnp.abs(F1) + (base[axis] + vs[axis]) * jnp.abs(F0)) * d_inv
        base[axis] = interp
        pts = jnp.stack(base, axis=-1).reshape(-1, 3)
        return pts, ok.reshape(-1)

    all_pts, all_ok = [], []
    for axis in range(3):
        p, m = axis_points(axis)
        all_pts.append(p)
        all_ok.append(m)
    pts = jnp.concatenate(all_pts, axis=0)
    ok = jnp.concatenate(all_ok, axis=0)

    # compact into fixed capacity (prefix-sum scatter)
    idx = jnp.nonzero(ok, size=capacity, fill_value=pts.shape[0])[0]
    mask = idx < pts.shape[0]
    pts_pad = jnp.concatenate([pts, jnp.zeros((1, 3), pts.dtype)], axis=0)
    out = pts_pad[idx]
    out = _mm(out, vol.pose_r.T) + vol.pose_t  # aff * p
    return jnp.where(mask[:, None], out, 0.0), mask


@functools.partial(jax.jit, static_argnames=("config", "frame"))
def extract_normals(
    vol: TsdfVolume, points: jnp.ndarray, config: TsdfConfig,
    frame: str = "world",
) -> jnp.ndarray:
    """TSDF-gradient normals at `points` (ExtractNormals,
    tsdf_volume.cu:602-679): NaN unless the voxel is in [2, dims-2)³;
    n = normalize(pose_R * grad). With frame="volume" the points are
    volume-frame (marching-cubes output) and the normals are returned in
    the volume frame too (no pose transform on either side)."""
    X, Y, Z = config.dims
    vs = jnp.asarray(config.voxel_size, jnp.float32)
    vs_inv = 1.0 / vs
    gradient_delta = vs * config.gradient_delta_factor

    if frame == "volume":
        p_vol = points
    else:
        p_vol = _mm(points - vol.pose_t, vol.pose_r)  # Rinv * (p - t)
    g = jnp.rint(p_vol * vs_inv).astype(jnp.int32)
    inside = (
        (g[..., 0] > 1) & (g[..., 0] < X - 2)
        & (g[..., 1] > 1) & (g[..., 1] < Y - 2)
        & (g[..., 2] > 1) & (g[..., 2] < Z - 2)
    )
    n = _compute_normal(vol.tsdf, p_vol, vs_inv, gradient_delta)
    if frame != "volume":
        n = _mm(n, vol.pose_r.T)  # aff.R * n
    return jnp.where(inside[..., None], n, _QNAN)
