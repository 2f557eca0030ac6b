"""Unique isosurface vertices by zero-crossing edge extraction (jitted).

Marching cubes emits a triangle SOUP: every cell re-emits the interpolated
vertex of each of its sign-changing edges once per incident triangle, so the
512-cube workload's ~225k soup vertices are ~45k UNIQUE positions repeated
~5x (each interior cell edge is shared by 4 cells and referenced by 1-3
triangles per cell). The non-rigid pipeline's correspondence + solve only
need the vertex SET — the 1-NN of a duplicated query is identical, and the
solve's data terms for duplicates are identical rows — so extracting unique
vertices directly makes the frame's two hottest stages (tiered 1-NN sweep,
Gram assembly) ~5x smaller and drops triangle emission off the per-frame
critical path entirely (the soup is still available on demand via
mesh/mc.py for meshing/export: DynFusion.mesh() extracts it lazily).

A unique vertex = a cell-grid EDGE whose endpoint TSDF samples have opposite
signs, both weighted, incident to >= 1 occupied cell (same occupancy rule as
marching cubes: all 8 corners weighted, mixed signs —
CubeIndexEstimator::computeCubeIndex, marching_cubes.cu:37-77; a
sign-changing edge's incident VALID cells are always mixed-sign, so
"incident to an occupied cell" exactly reproduces which edges the soup
contains). Interpolation matches vertex_interp (marching_cubes.cu:197-204),
so the extracted set equals unique(soup positions) bit-for-bit.

DELIBERATE deviation (documented for the parity ledger): the solve sees
each unique vertex ONCE, where the reference's soup weights each position
by its triangle-reference count (1-12x, a marching-cubes triangulation
artifact, not a modeling choice). Measured effect on the 512-cube tracking
benchmark: median vertex error unchanged; the exact-soup
path remains the default at <384-cube (`DynFuParams.corr_unique_edges`).

Entirely bit-packed (ops/compaction.py): sign-change and incidence tests
are word-parallel bit ops over ceil(Z/32)-word columns, extraction reuses
the hierarchical column compaction, and per-edge endpoint values come from
ONE bit-packed (F[z], F[z+1]) pair gather + one neighbor gather — ~2 gathers
per edge vs marching cubes' 4 per cell.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dynfu_tpu.ops import compaction
from dynfu_tpu.volume.tsdf import TsdfConfig, TsdfVolume


def _pair_xor_z(w: jnp.ndarray) -> jnp.ndarray:
    """bit z := bit z XOR bit z+1, with carry across words (z-edge sign
    change from packed inside-bits)."""
    nxt = jnp.concatenate([w[..., 1:], jnp.zeros_like(w[..., :1])], axis=-1)
    down = jnp.right_shift(w, jnp.uint32(1)) | jnp.left_shift(
        nxt, jnp.uint32(31))
    return w ^ down


def _or_z_prev(w: jnp.ndarray) -> jnp.ndarray:
    """bit z := bit z OR bit z-1 (incidence expansion: the edge at z is
    contained in cells z-1 and z)."""
    prv = jnp.concatenate([jnp.zeros_like(w[..., :1]), w[..., :-1]], axis=-1)
    up = jnp.left_shift(w, jnp.uint32(1)) | jnp.right_shift(
        prv, jnp.uint32(31))
    return w | up


def _or_axis_prev(w: jnp.ndarray, axis: int, out_len: int) -> jnp.ndarray:
    """(..., n, ...) -> (..., out_len, ...) with out[i] = w[i] | w[i-1]
    (zero beyond the ends) — expands cell occupancy to edge-grid incidence
    along a perpendicular axis (cells n = out_len - 1)."""
    z = jnp.zeros_like(jax.lax.slice_in_dim(w, 0, 1, axis=axis))
    lo = jnp.concatenate([w, z], axis=axis)  # w[i]
    hi = jnp.concatenate([z, w], axis=axis)  # w[i-1]
    return lo | hi


@functools.partial(jax.jit, static_argnames=("config", "max_edges",
                                             "convention", "col_budget",
                                             "with_normals"))
def isosurface_edge_vertices(
    vol: TsdfVolume,
    config: TsdfConfig,
    max_edges: int = 1 << 16,
    convention: str = "center",
    col_budget: int = 0,
    with_normals: bool = False,
    bitplanes: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
):
    """Extract the unique isosurface vertex set.

    Returns (verts (max_edges, 3) float32 volume-frame meters — the first
    n_edges rows valid, in x-major scan order (nearly x-sorted, like the
    marching-cubes soup, so the correspondence certificate logic applies
    unchanged); n_edges () int32; n_dropped () int32 — sign-changing edges
    NOT captured because a compaction capacity overflowed).

    with_normals=True appends TSDF-gradient normals (max_edges, 3),
    volume-frame, computed IN the extraction: the two endpoint LATTICE
    central differences (6 element gathers each) lerped by the
    interpolation fraction t, vs tsdf.extract_normals' 6 trilinear
    samples = 48 gathers per query (~4x fewer gathers). NaN outside [2, dims-2)³, matching
    extract_normals' boundary rule (tsdf_volume.cu:602-679).

    bitplanes: optional precomputed (pack_columns(tsdf < 0),
    pack_columns(weight != 0)) — the integrate emits them fused
    (tsdf.integrate_separable(emit_bitplanes=True)), skipping this
    function's full-volume re-read."""
    if convention not in ("center", "corner"):
        raise ValueError(f"unknown convention {convention!r}")
    X, Y, Z = config.dims
    vs = np.asarray(config.voxel_size, np.float32)
    Fh, W = vol.tsdf, vol.weight

    if bitplanes is None:
        ins_w = compaction.pack_columns(Fh < 0)  # (X, Y, nw)
        val_w = compaction.pack_columns(W != 0)
    else:
        ins_w, val_w = bitplanes
    nw = ins_w.shape[-1]

    # cell occupancy, as marching cubes pass 1 (mesh/mc.py)
    def cell4(w):
        return w[:-1, :-1] & w[1:, :-1] & w[:-1, 1:] & w[1:, 1:]

    pairz = compaction.pair_and_z
    occ = cell4(pairz(val_w)) & ~cell4(pairz(ins_w)) & ~cell4(pairz(~ins_w))
    # (X-1, Y-1, nw), bits k in [0, Z-2]

    # x-edges (i in [0, X-2], j, k): sign change along x, both ends weighted,
    # incident to an occupied cell at (i, j-{0,1}, k-{0,1})
    sx = (ins_w[:-1] ^ ins_w[1:]) & (val_w[:-1] & val_w[1:])
    used_x = sx & _or_z_prev(_or_axis_prev(occ, 1, Y))
    # y-edges (i, j in [0, Y-2], k)
    sy = (ins_w[:, :-1] ^ ins_w[:, 1:]) & (val_w[:, :-1] & val_w[:, 1:])
    used_y = sy & _or_z_prev(_or_axis_prev(occ, 0, X))
    # z-edges (i, j, k in [0, Z-2])
    sz = _pair_xor_z(ins_w) & pairz(val_w)
    used_z = sz & _or_axis_prev(_or_axis_prev(occ, 0, X), 1, Y)

    # combine into one (X, Y, 3, nw) column family: column id
    # c = (i * Y + j) * 3 + axis — ascending c is x-major scan order
    zrow_x = jnp.zeros((1, Y, nw), jnp.uint32)
    ux = jnp.concatenate([used_x, zrow_x], axis=0)  # pad i = X-1
    zrow_y = jnp.zeros((X, 1, nw), jnp.uint32)
    uy = jnp.concatenate([used_y, zrow_y], axis=1)  # pad j = Y-1
    allw = jnp.stack([ux, uy, used_z], axis=2).reshape(X * Y * 3, nw)

    fill = X * Y * 3 * Z
    K = min(col_budget, Z)  # 0 = no budget -> the budget-free path below
    if 0 < K <= 32:
        # SMALL per-column budgets (the sphere presets' edge_col_budget=8,
        # measured max 3 bits/column): the per-column rank-select + K
        # unrolled LSB rounds avoids extract_bits' cost, whose level-1 stamp scatter scales with the
        # 32x-packed WORD-activity mask (X*Y*3*nw/32 inputs). Column
        # capacity = max_edges (every active column holds >= 1 bit, so in
        # the no-drop regime n_cols <= n_edges); budget overflow surfaces
        # in n_dropped.
        flat_idx, n_total, n_captured = compaction.extract_columns(
            allw, per_column=K,
            max_cols=min(X * Y * 3, max(max_edges, 1 << 15)),
            max_out=max_edges, row_stride=Z, fill=fill, packed_cols=True)
    else:
        # budget-free two-level rank select (ops/compaction.py
        # extract_bits): no per-column bit budget exists, so z-parallel
        # surfaces (the umbrella's wall/floor — whole z-columns of edge
        # bits) cost nothing extra. The budget-256 formulation paid
        # budget x max_cols x nwords word-ops per frame here.
        # Capture is the ascending scan-order prefix either way, so the
        # two paths agree bit-for-bit whenever neither drops.
        flat_idx, n_total, n_captured = compaction.extract_bits(
            allw, max_out=max_edges, row_stride=Z, fill=fill,
            max_words=min(X * Y * 3 * nw, max(max_edges, 1 << 15)))
    ok = flat_idx < fill
    safe = jnp.where(ok, flat_idx, 0)
    c = safe // Z
    z = safe - c * Z
    i = c // (Y * 3)
    r = c - i * (Y * 3)
    j = r // 3
    a = r - j * 3

    # endpoint values: exactly two element gathers per edge (f0 at the
    # anchor, f1 at the +1 neighbor along the edge axis — unlike marching
    # cubes' 8 corners there is nothing to save by materializing a packed
    # (F[z], F[z+1]) volume, which costs a full 4-byte-per-voxel HBM write)
    dxa = (a == 0).astype(jnp.int32)
    dya = (a == 1).astype(jnp.int32)
    dza = (a == 2).astype(jnp.int32)
    f0 = Fh[i, j, z].astype(jnp.float32)
    f1 = Fh[jnp.minimum(i + dxa, X - 1), jnp.minimum(j + dya, Y - 1),
            jnp.minimum(z + dza, Z - 1)].astype(jnp.float32)

    shift = 0.5 if convention == "center" else 0.0
    p0 = (jnp.stack([i, j, z], axis=-1).astype(jnp.float32) + shift) \
        * vs[None, :]
    axis_dir = jnp.stack([dxa.astype(jnp.float32),
                          dya.astype(jnp.float32),
                          dza.astype(jnp.float32)], axis=-1) \
        * vs[None, :]
    t = (0.0 - f0) / (f1 - f0 + 1e-15)  # vertex_interp, mc.cu:197-204
    verts = jnp.where(ok[:, None], p0 + t[:, None] * axis_dir, 0.0)

    n_dropped = n_total - n_captured
    if not with_normals:
        return verts, n_captured.astype(jnp.int32), n_dropped

    # endpoint lattice gradients, lerped by t. Both endpoints and their
    # six ±1 neighbors are interior whenever the VERTEX passes the
    # [2, dims-2)³ gate below, so plain clipping never contaminates a
    # reported normal.
    i1 = jnp.minimum(i + dxa, X - 1)
    j1 = jnp.minimum(j + dya, Y - 1)
    z1 = jnp.minimum(z + dza, Z - 1)

    def lattice_grad(ii, jj, zz):
        gx = (Fh[jnp.minimum(ii + 1, X - 1), jj, zz]
              - Fh[jnp.maximum(ii - 1, 0), jj, zz]).astype(jnp.float32)
        gy = (Fh[ii, jnp.minimum(jj + 1, Y - 1), zz]
              - Fh[ii, jnp.maximum(jj - 1, 0), zz]).astype(jnp.float32)
        gz = (Fh[ii, jj, jnp.minimum(zz + 1, Z - 1)]
              - Fh[ii, jj, jnp.maximum(zz - 1, 0)]).astype(jnp.float32)
        return jnp.stack([gx, gy, gz], axis=-1)

    vs_inv = jnp.asarray(1.0 / vs, jnp.float32)
    g = (lattice_grad(i, j, z) * (1.0 - t)[:, None]
         + lattice_grad(i1, j1, z1) * t[:, None]) * vs_inv[None, :]
    norms = g / jnp.maximum(
        jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-30)
    # the rounded-voxel interior gate of extract_normals (the vertex lies
    # on the edge between (i,j,z) and (i1,j1,z1))
    gi = jnp.rint(verts * vs_inv[None, :]).astype(jnp.int32)
    inside = ((gi[:, 0] > 1) & (gi[:, 0] < X - 2)
              & (gi[:, 1] > 1) & (gi[:, 1] < Y - 2)
              & (gi[:, 2] > 1) & (gi[:, 2] < Z - 2))
    qnan = jnp.float32(jnp.nan)
    norms = jnp.where((ok & inside)[:, None], norms, qnan)
    return verts, n_captured.astype(jnp.int32), n_dropped, norms
