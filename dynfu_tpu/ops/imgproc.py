"""Depth-image preprocessing and rendering ops (jitted jnp).

Re-designs the reference's CUDA image kernels (src/kfusion/cuda/imgproc.cu,
host wrappers src/kfusion/imgproc.cpp) as fused, vectorized XLA programs.
Each per-pixel CUDA kernel becomes a whole-image expression: window stencils
are expressed as shift-and-mask sums that XLA fuses into a single pass over
device memory — pure elementwise/stencil work that needs no hand-written
kernel.

Conventions (identical to the reference):
* depth images are (H, W) in integer millimeters (reference: ushort);
  here int32 arithmetic, values 0..65535.
* invalid pixels in point/normal maps are NaN (reference uses CUDA qnan).
* ``dists`` is the metric ray length in meters, stored float16
  (reference packs half, imgproc.cu:248-259).

Reference kernels covered and their quirks preserved:
* bilateral_kernel (imgproc.cu:8-38): window upper bound is
  ``min(x - ksz/2 + ksz, cols - 1)`` EXCLUSIVE — the last row and column of
  the image never contribute to any window.
* pyramid_kernel (imgproc.cu:85-110): 5x5 window around (2y, 2x) with the
  same exclusive-bound quirk, |val - center| < 3*sigma gating, and INTEGER
  division sum/count.
* compute_normals_kernel + mask_depth_kernel (imgproc.cu:129-180).
* points_normals_kernel (imgproc.cu:186-221).
* compute_dists_kernel (imgproc.cu:235-248).
* resize_depth_normals_kernel / resize_points_normals_kernel
  (imgproc.cu:262-359): 2x2 averaging, integer division for depth, normals
  averaged WITHOUT renormalization.
* render_image_kernel / tangent_colors_kernel / mergePointNormalKernel
  (imgproc.cu:363-548).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dynfu_tpu.core.camera import Intr

_QNAN = jnp.float32(jnp.nan)


def _shift2d(img, dy: int, dx: int, fill):
    """img shifted so out[y, x] = img[y + dy, x + dx], padded with `fill`."""
    H, W = img.shape[:2]
    py0, py1 = max(-dy, 0), max(dy, 0)
    px0, px1 = max(-dx, 0), max(dx, 0)
    pad = [(py0, py1), (px0, px1)] + [(0, 0)] * (img.ndim - 2)
    out = jnp.pad(img, pad, constant_values=fill)
    return out[py1 : py1 + H, px1 : px1 + W]


def _neighbor_valid(H: int, W: int, dy: int, dx: int):
    """Validity of neighbor (y+dy, x+dx) under the reference's window rule:
    in-bounds AND strictly below the last row/column (exclusive upper bound
    ``min(.. , rows-1)``, imgproc.cu:18-19)."""
    ys = jnp.arange(H)[:, None] + dy
    xs = jnp.arange(W)[None, :] + dx
    return (ys >= 0) & (ys <= H - 2) & (xs >= 0) & (xs <= W - 2)


# ---------------------------------------------------------------------------
# bilateral filter — imgproc.cu:8-53
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("kernel_size",))
def bilateral_filter(
    depth_mm: jnp.ndarray,
    kernel_size: int = 7,
    sigma_spatial: float = 4.5,
    sigma_depth: float = 0.04,
) -> jnp.ndarray:
    """Depth-aware bilateral filter on millimeter depth (int32 -> int32).

    sigma_depth is in meters (host wrapper converts to mm, imgproc.cu:44).
    Output is round-to-nearest of the weighted mean (__float2int_rn).
    """
    H, W = depth_mm.shape
    d = depth_mm.astype(jnp.float32)
    inv_sp = 0.5 / (sigma_spatial * sigma_spatial)
    inv_sd = 0.5 / ((sigma_depth * 1000.0) ** 2)

    half = kernel_size // 2
    num = jnp.zeros((H, W), jnp.float32)
    den = jnp.zeros((H, W), jnp.float32)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            nb = _shift2d(d, dy, dx, 0)
            valid = _neighbor_valid(H, W, dy, dx)
            space2 = jnp.float32(dy * dy + dx * dx)
            color2 = (d - nb) ** 2
            wgt = jnp.exp(-(space2 * inv_sp + color2 * inv_sd))
            wgt = jnp.where(valid, wgt, 0.0)
            num = num + nb * wgt
            den = den + wgt
    out = num / jnp.maximum(den, 1e-30)
    return jnp.round(out).astype(depth_mm.dtype)


# ---------------------------------------------------------------------------
# depth truncation — imgproc.cu:60-79
# ---------------------------------------------------------------------------


@jax.jit
def truncate_depth(depth_mm: jnp.ndarray, max_dist_m: float) -> jnp.ndarray:
    """Zero out depth beyond max_dist meters (compared in integer mm)."""
    max_mm = jnp.int32(max_dist_m * 1000.0)
    return jnp.where(depth_mm > max_mm, 0, depth_mm)


# ---------------------------------------------------------------------------
# depth pyramid — imgproc.cu:85-125
# ---------------------------------------------------------------------------


@jax.jit
def depth_pyramid_down(depth_mm: jnp.ndarray, sigma_depth: float = 0.04) -> jnp.ndarray:
    """One 2x downsample level with depth-gated 5x5 averaging.

    Gating: |neighbor - center| < 3 * sigma_depth_mm; output = sum // count
    (integer division, imgproc.cu:109).
    """
    H, W = depth_mm.shape
    Ho, Wo = H // 2, W // 2
    thresh = jnp.float32(sigma_depth * 1000.0 * 3.0)

    center = depth_mm[: 2 * Ho : 2, : 2 * Wo : 2]  # src(2y, 2x)
    s = jnp.zeros((Ho, Wo), jnp.int32)
    c = jnp.zeros((Ho, Wo), jnp.int32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            nb = _shift2d(depth_mm, dy, dx, 0)[: 2 * Ho : 2, : 2 * Wo : 2]
            # validity at source coords (2y+dy, 2x+dx) with exclusive bound
            ys = jnp.arange(Ho)[:, None] * 2 + dy
            xs = jnp.arange(Wo)[None, :] * 2 + dx
            valid = (ys >= 0) & (ys <= H - 2) & (xs >= 0) & (xs <= W - 2)
            keep = valid & (jnp.abs(nb - center).astype(jnp.float32) < thresh)
            s = s + jnp.where(keep, nb, 0)
            c = c + keep.astype(jnp.int32)
    return jnp.where(c == 0, 0, s // jnp.maximum(c, 1)).astype(depth_mm.dtype)


# ---------------------------------------------------------------------------
# dists map — imgproc.cu:235-259
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("intr",))
def compute_dists(depth_mm: jnp.ndarray, intr: Intr) -> jnp.ndarray:
    """Radial ray length in meters, float16 (reference packs half).

    The f16 narrowing is SEMANTIC, not storage: the reference's dists map
    is half precision (compute_dists_kernel, imgproc.cu:248-262), and the
    integrate's one-hot resample matmuls are bit-exact at Precision.HIGH
    only for f16-mantissa payloads (volume/tsdf.py `_onehot`). Inside a
    fused engine frame XLA folds convert(f16->f32) chains and silently
    feeds the matmul the unrounded f32 product — the barrier pins the f16
    quantization point so fused and standalone paths compute identically.
    """
    H, W = depth_mm.shape
    x = jnp.arange(W, dtype=jnp.float32)[None, :]
    y = jnp.arange(H, dtype=jnp.float32)[:, None]
    xl = (x - intr.cx) / intr.fx
    yl = (y - intr.cy) / intr.fy
    lam = jnp.sqrt(xl * xl + yl * yl + 1.0)
    d16 = (depth_mm.astype(jnp.float32) * lam * 0.001).astype(jnp.float16)
    return jax.lax.optimization_barrier(d16)


# ---------------------------------------------------------------------------
# normals / point maps — imgproc.cu:129-221
# ---------------------------------------------------------------------------


def _reproject_grid(depth_m: jnp.ndarray, intr: Intr) -> jnp.ndarray:
    H, W = depth_m.shape
    x = jnp.arange(W, dtype=jnp.float32)[None, :]
    y = jnp.arange(H, dtype=jnp.float32)[:, None]
    px = depth_m * (x - intr.cx) / intr.fx
    py = depth_m * (y - intr.cy) / intr.fy
    return jnp.stack([px, py, depth_m], axis=-1)


def _normalized(v, axis=-1):
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    return v / n


@functools.partial(jax.jit, static_argnames=("intr",))
def compute_points_normals(depth_mm: jnp.ndarray, intr: Intr):
    """Point + normal maps from right/down finite differences.

    points(y,x) = reproject(x, y, z); normal = -normalize((v01-v00)x(v10-v00));
    valid iff x<W-1, y<H-1 and all three depths nonzero (imgproc.cu:186-215).
    Returns (points (H,W,3), normals (H,W,3)) with NaN at invalid pixels.
    """
    H, W = depth_mm.shape
    z = depth_mm.astype(jnp.float32) * 0.001
    v00 = _reproject_grid(z, intr)
    z01 = _shift2d(z, 0, 1, 0.0)
    z10 = _shift2d(z, 1, 0, 0.0)

    x = jnp.arange(W, dtype=jnp.float32)[None, :]
    y = jnp.arange(H, dtype=jnp.float32)[:, None]
    v01 = jnp.stack(
        [z01 * (x + 1 - intr.cx) / intr.fx, z01 * (y - intr.cy) / intr.fy, z01], -1
    )
    v10 = jnp.stack(
        [z10 * (x - intr.cx) / intr.fx, z10 * (y + 1 - intr.cy) / intr.fy, z10], -1
    )

    n = -_normalized(jnp.cross(v01 - v00, v10 - v00))
    interior = (jnp.arange(W)[None, :] < W - 1) & (jnp.arange(H)[:, None] < H - 1)
    valid = interior & (z * z01 * z10 != 0)
    points = jnp.where(valid[..., None], v00, _QNAN)
    normals = jnp.where(valid[..., None], n, _QNAN)
    return points, normals


@functools.partial(jax.jit, static_argnames=("intr",))
def compute_normals_and_mask_depth(depth_mm: jnp.ndarray, intr: Intr):
    """computeNormalsAndMaskDepth: normals + zero depth where normal is NaN
    (imgproc.cu:129-180). Returns (masked_depth_mm, normals)."""
    _, normals = compute_points_normals(depth_mm, intr)
    ok = ~jnp.isnan(normals[..., 0])
    return jnp.where(ok, depth_mm, 0), normals


# ---------------------------------------------------------------------------
# pyramid resize of maps — imgproc.cu:262-359
# ---------------------------------------------------------------------------


@jax.jit
def resize_depth_normals(depth_mm: jnp.ndarray, normals: jnp.ndarray):
    """Half-res depth + normals: 2x2 mean; depth uses integer division;
    valid iff d00*d01 != 0 and d10*d11 != 0; normals NOT renormalized."""
    H, W = depth_mm.shape
    Ho, Wo = H // 2, W // 2
    d = depth_mm[: 2 * Ho, : 2 * Wo].reshape(Ho, 2, Wo, 2).transpose(0, 2, 1, 3)
    d00, d01 = d[..., 0, 0], d[..., 0, 1]
    d10, d11 = d[..., 1, 0], d[..., 1, 1]
    valid = (d00 * d01 != 0) & (d10 * d11 != 0)
    dout = jnp.where(valid, (d00 + d01 + d10 + d11) // 4, 0).astype(depth_mm.dtype)

    n = normals[: 2 * Ho, : 2 * Wo].reshape(Ho, 2, Wo, 2, 3).transpose(0, 2, 1, 3, 4)
    nout = jnp.sum(n, axis=(2, 3)) * 0.25
    nout = jnp.where(valid[..., None], nout, _QNAN)
    return dout, nout


@jax.jit
def resize_points_normals(points: jnp.ndarray, normals: jnp.ndarray):
    """Half-res point/normal maps: 2x2 mean, valid iff all 4 points finite;
    normals NOT renormalized (imgproc.cu:321-344)."""
    H, W = points.shape[:2]
    Ho, Wo = H // 2, W // 2

    def pool(img):
        q = img[: 2 * Ho, : 2 * Wo].reshape(Ho, 2, Wo, 2, 3).transpose(0, 2, 1, 3, 4)
        return q, jnp.sum(q, axis=(2, 3)) * 0.25

    pq, pmean = pool(points)
    _, nmean = pool(normals)
    valid = ~jnp.isnan(jnp.sum(pq[..., 0], axis=(2, 3)))
    pout = jnp.where(valid[..., None], pmean, _QNAN)
    nout = jnp.where(valid[..., None], nmean, _QNAN)
    return pout, nout


# ---------------------------------------------------------------------------
# rendering — imgproc.cu:363-511
# ---------------------------------------------------------------------------


def _phong(P, N, light_pose, valid, height):
    """Shared Phong shading body (imgproc.cu:384-402)."""
    Ka, Kd, Ks, spow = 0.3, 0.5, 0.2, 20.0
    L = _normalized(jnp.asarray(light_pose, jnp.float32) - P)
    V = _normalized(-P)
    R = _normalized(2.0 * N * jnp.sum(N * L, -1, keepdims=True) - L)
    Ix = (
        Ka
        + Kd * jnp.maximum(0.0, jnp.sum(N * L, -1))
        + Ks * jnp.maximum(0.0, jnp.sum(R * V, -1)) ** spow
    )
    color = jnp.repeat(Ix[..., None], 3, axis=-1)

    # background: vertical bgr gradient (imgproc.cu:374-380)
    w = (jnp.arange(height, dtype=jnp.float32) / height)[:, None, None]
    bgr1 = jnp.asarray([4.0, 2.0, 2.0], jnp.float32) / 255.0
    bgr2 = jnp.asarray([236.0, 120.0, 120.0], jnp.float32) / 255.0
    bg = bgr1 * (1 - w) + bgr2 * w
    out = jnp.where(valid[..., None], color, bg)
    return (jnp.clip(out, 0.0, 1.0) * 255.0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("intr", "light_pose"))
def render_image_depth(depth_mm: jnp.ndarray, normals: jnp.ndarray, intr: Intr, light_pose):
    """Phong render from a depth map + normals (imgproc.cu:363-411)."""
    z = depth_mm.astype(jnp.float32) * 0.001
    P = _reproject_grid(z, intr)
    valid = depth_mm != 0
    return _phong(P, normals, light_pose, valid, depth_mm.shape[0])


@functools.partial(jax.jit, static_argnames=("light_pose",))
def render_image_points(points: jnp.ndarray, normals: jnp.ndarray, light_pose):
    """Phong render from a point map (imgproc.cu:414-462)."""
    valid = ~jnp.isnan(points[..., 0])
    P = jnp.where(valid[..., None], points, 0.0)
    return _phong(P, normals, light_pose, valid, points.shape[0])


@jax.jit
def render_tangent_colors(normals: jnp.ndarray) -> jnp.ndarray:
    """Tangent-color normal visualization, BGR byte image
    (tangent_colors_kernel, imgproc.cu:489-511)."""
    r = (5.0 - normals[..., 0] * 3.5) * 25.5
    g = (5.0 - normals[..., 1] * 2.5) * 25.5
    b = (5.0 - normals[..., 2] * 3.5) * 25.5
    bgr = jnp.stack([b, g, r], axis=-1)
    return jnp.nan_to_num(bgr).astype(jnp.uint8)


def merge_point_normal(cloud: jnp.ndarray, normals: jnp.ndarray) -> jnp.ndarray:
    """Interleave (N,3) points and normals into (N,6) — mergePointNormalKernel
    (imgproc.cu:515-548) minus the float12 padding, which only existed for PCL."""
    return jnp.concatenate([cloud, normals], axis=-1)
