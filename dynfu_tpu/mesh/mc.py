"""Marching cubes on the TSDF volume (jitted).

Re-design of the reference's two-pass GPU marching cubes
(src/kfusion/cuda/marching_cubes.cu, host driver
src/kfusion/marching_cubes.cpp):

reference                                   this formulation
-----------------------------------------   --------------------------------
warp-ballot + atomicAdd voxel compaction    dense cube-index field + masked
(getOccupiedVoxelsKernel, cu:79-141)        jnp.nonzero(size=cap) compaction
thrust::exclusive_scan vertex offsets       jnp.cumsum over compacted counts
(computeOffsetsAndTotalVertices, cu:167)
per-voxel shared-mem vertlist + LUT          vmapped 12-edge interpolation +
texture fetch (TrianglesGenerator,           LUT gathers; scatter into the
cu:185-266)                                  fixed triangle buffer

Semantics preserved:
* a cube participates only if ALL 8 corner weights are nonzero
  (CubeIndexEstimator::computeCubeIndex, cu:37-77);
* inside = tsdf < isoValue (= 0);
* emitted vertices sit on cube edges between voxel CENTERS (+0.5 shift,
  getNodeCoo, cu:185-194), interpolated by t = (iso - f0) / (f1 - f0 + 1e-15)
  (vertex_interp, cu:197-204);
* output is a flat vertex stream, 3 consecutive vertices per triangle, in
  VOLUME-frame coordinates, with a fixed-capacity buffer + count (the
  reference preallocates 6M points, marching_cubes.cpp:23-27).

The reference hardcodes the grid to 128³ (internal.hpp:74,
marching_cubes.cu:152,283-285 — the reason dynfu overrides volume_dims);
here dims flow from TsdfConfig, so 512³ meshes work.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dynfu_tpu.mesh import tables
from dynfu_tpu.ops import compaction
from dynfu_tpu.volume.tsdf import TsdfConfig, TsdfVolume

MAX_TRIANGLES = 2_000_000  # default vertex-buffer capacity / 3


def emit_triangles(tris, t_offsets, n_tris, max_tris: int):
    """Scatter per-voxel triangles into the output stream.

    tris (M, 5, 9): up to 5 triangles (9 floats) per voxel; t_offsets (M,)
    the exclusive scan of n_tris (M,), the per-voxel triangle counts. Slot
    j of voxel v lands at row t_offsets[v] + j when j < n_tris[v]; rows at
    or past max_tris are dropped. Returns the (max_tris, 9) stream, zero
    beyond the last written row. Emitting at triangle granularity writes 5
    rows of 9 floats per voxel instead of 15 rows of 3."""
    slot = jnp.arange(tris.shape[1], dtype=jnp.int32)[None, :]
    tgt = jnp.where(slot < n_tris[:, None], t_offsets[:, None] + slot,
                    max_tris)
    out = jnp.zeros((max_tris + 1, tris.shape[2]), jnp.float32)
    out = out.at[tgt.reshape(-1)].set(tris.reshape(-1, tris.shape[2]),
                                      mode="drop")
    return out[:max_tris]


@functools.partial(jax.jit, static_argnames=("config", "max_voxels", "max_verts",
                                              "convention", "col_budget"))
def marching_cubes(
    vol: TsdfVolume,
    config: TsdfConfig,
    max_voxels: int = 1 << 17,
    max_verts: int = 3 * 600_000,
    convention: str = "center",
    col_budget: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Extract the zero isosurface as a triangle soup.

    Returns (vertices (max_verts, 3) float32 volume-frame meters,
             n_verts () int32,
             n_dropped () int32 — occupied cube cells NOT meshed because a
             compaction capacity overflowed (per-column budget, active-column
             cap, or max_voxels); 0 means the output is complete).
    Valid vertices are [0, n_verts); the stream is 3 per triangle with the
    reference's ordering.

    ``convention`` picks the voxel coordinate model for emitted vertices:

    * "center" (default): corner i sits at (i+0.5)*voxel_size — the
      reference's getNodeCoo (marching_cubes.cu:181-189). NOTE this is
      HALF A VOXEL OFF from where the reference's own integrator puts the
      TSDF samples (x*voxel_size, tsdf_volume.cu:60), i.e. the reference's
      meshes are systematically half-voxel-shifted against its volume.
      Kept as the parity behavior.
    * "corner": corner i sits at i*voxel_size — consistent with the
      integrator/raycast/extract_normals sampling. Required by the
      persistent-canonical fusion pipeline, where the solver would
      otherwise chase the half-voxel bias every frame and deform a
      perfectly static scene.
    """
    if convention not in ("center", "corner"):
        raise ValueError(f"unknown convention {convention!r}")
    X, Y, Z = config.dims
    vs = np.asarray(config.voxel_size, np.float32)

    Fh = vol.tsdf  # (X, Y, Z) float16 storage; f32 only after compaction
    W = vol.weight

    tri_tab = jnp.asarray(tables.TRI_TABLE)  # (256, 16)
    nv_tab = jnp.asarray(tables.NUM_VERTS_TABLE)  # (256,)
    offs = tables.CORNER_OFFSETS  # (8, 3) numpy

    # --- pass 1: occupancy over the (X-1, Y-1, Z-1) cell grid ---------------
    # A cell participate iff ALL 8 corner weights are nonzero
    # (CubeIndexEstimator::computeCubeIndex, cu:37-77) and its corners are
    # not all on one side of the isosurface (cube index not 0/255).
    # Occupancy needs NO table lookup, so it reduces to sign/weight tests;
    # the cube index itself is recomputed from the 8 gathered corner values
    # on the COMPACTED set only (pass 2).
    n_cells = (X - 1) * (Y - 1) * (Z - 1)

    if n_cells < (1 << 18):
        # small volumes: dense cell field + direct masked compaction.
        # nonzero's scatter cost scales with the dense cell count, so the
        # bit-packed path below wins well under this threshold; the
        # threshold keeps tiny test volumes on the
        # exact-by-construction path where compile time matters more than
        # run time.
        def corner(i):
            dx, dy, dz = (int(v) for v in offs[i])
            return (
                Fh[dx : dx + X - 1, dy : dy + Y - 1, dz : dz + Z - 1],
                W[dx : dx + X - 1, dy : dy + Y - 1, dz : dz + Z - 1],
            )

        all_weighted, all_in, all_out = None, None, None
        for i in range(8):
            fi, wi = corner(i)
            ok = wi != 0
            inside = fi < 0
            if i == 0:
                all_weighted, all_in, all_out = ok, inside, ~inside
            else:
                all_weighted &= ok
                all_in &= inside
                all_out &= ~inside
        occ = all_weighted & ~all_in & ~all_out
        n_occ_total = jnp.sum(occ.astype(jnp.int32))
        vox_idx = jnp.nonzero(occ.reshape(-1), size=max_voxels,
                              fill_value=n_cells)[0]
    else:
        # Large volumes: XLA's nonzero scatters one element per CELL, and
        # even building a dense boolean cell field costs several 0.5 GB
        # round trips to device memory. So occupancy is computed ENTIRELY
        # in bit-packed form:
        #
        #   1. one fused pass over tsdf/weight packs per-voxel-column
        #      `inside` (tsdf < 0) and `valid` (weight != 0) bits into
        #      ceil(Z/32) uint32 words — (X, Y, nw) arrays, 64x smaller
        #      than the dense f32 field;
        #   2. cell occupancy in word space: pairz(w) ANDs each bit with
        #      its z+1 neighbor (shift with cross-word carry), cell4 ANDs
        #      the four (x,y) corner columns; occupied = all-8-weighted
        #      AND NOT all-inside AND NOT all-outside — a handful of
        #      bit-ops over 16 MB;
        #   3. active z-columns (any bit set) are compacted FIRST (nonzero
        #      over XY elements), and only then the first K set bits per
        #      active column are extracted — lsb = w & -w, bit position
        #      from the f32 exponent (exact: lsb is a power of two) — so
        #      the K rounds touch (max_cols, nw) words, not (XY, Z) cells.
        #
        # Candidate order (ascending column id, ascending z) equals the
        # dense scan order, so downstream output is bit-identical whenever
        # no capacity overflows (overflow surfaces in n_dropped).
        #
        # per-column candidate budget: the occupied band is ~2*trunc/voxel
        # cells per surface crossing; budget two crossings + margin. Scenes
        # with z-PARALLEL near-planar geometry (a floor at constant y fills
        # whole z-columns) need more — pass col_budget (n_dropped > 0 is
        # the signal; the umbrella dataset's floor is the canonical case).
        K = col_budget or min(64, 4 + 4 * max(1, int(np.ceil(
            config.trunc_dist / config.voxel_size[2]))))
        K = min(K, Z - 1)
        cz = Z - 1
        nwords = (Z + 31) // 32

        def cell4(w):  # AND of the four (x,y) corner columns of each cell
            return w[:-1, :-1] & w[1:, :-1] & w[:-1, 1:] & w[1:, 1:]

        pairz = compaction.pair_and_z
        ins_w = compaction.pack_columns(Fh < 0)
        val_w = compaction.pack_columns(W != 0)
        occ_w = cell4(pairz(val_w)) & ~cell4(pairz(ins_w)) \
            & ~cell4(pairz(~ins_w))
        # pad bits (z >= Z) carry valid=0, so bits >= Z-1 are already clear
        occ_w = occ_w.reshape(-1, nwords)  # (XY, nwords), col = x*(Y-1)+y
        max_cols = min(occ_w.shape[0], max(max_voxels // 4, 1 << 15))
        vox_idx, n_occ_total, _ = compaction.extract_columns(
            occ_w, per_column=K, max_cols=max_cols, max_out=max_voxels,
            row_stride=cz, fill=n_cells,
            # rank-select (ops/compaction.py): no nested LSB rounds
            packed_cols=True)
    vox_valid = vox_idx < n_cells
    # any capacity overflow (per-column K, active-column cap, max_voxels)
    # surfaces here as occupied-but-unprocessed cells
    n_dropped = n_occ_total - jnp.sum(vox_valid.astype(jnp.int32))

    # --- pass 2: triangle generation per occupied voxel ---------------------
    # decode flat cell id -> (x, y, z); flat order is x-major C order over
    # (X-1, Y-1, Z-1) with z fastest.
    cy = (Y - 1)
    cz = (Z - 1)
    vx = vox_idx // (cy * cz)
    rem = vox_idx - vx * (cy * cz)
    vy = rem // cz
    vz = rem - vy * cz
    vx = jnp.where(vox_valid, vx, 0)
    vy = jnp.where(vox_valid, vy, 0)
    vz = jnp.where(vox_valid, vz, 0)

    # gather 8 corner tsdf values: (max_voxels, 8). The f16 pair (F[z],
    # F[z+1]) is bit-packed into one uint32 per voxel, so each cell needs 4
    # gathers instead of 8 (the pack itself is one fused streaming pass).
    # Interpolation math below is f32,
    # identical to casting the whole field first.
    nxt = jnp.concatenate([Fh[:, :, 1:], Fh[:, :, :1]], axis=2)
    zpair = jax.lax.bitcast_convert_type(
        jnp.stack([Fh, nxt], axis=-1), jnp.uint32)  # (X, Y, Z)
    xy_pairs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    pv = jnp.stack([zpair[vx + dx, vy + dy, vz] for dx, dy in xy_pairs],
                   axis=-1)  # (max_voxels, 4)
    both = jax.lax.bitcast_convert_type(pv, jnp.float16)  # (M, 4, 2)
    fvals = jnp.stack(
        [both[:, xy_pairs.index((int(offs[i, 0]), int(offs[i, 1]))),
              int(offs[i, 2])]
         for i in range(8)],
        axis=-1,
    ).astype(jnp.float32)
    # cube index from the gathered corner signs — compacted cells are
    # all-weighted by construction, so this equals the reference's
    # weight-gated computeCubeIndex on occupied cells
    cubeidx = jnp.zeros(fvals.shape[:1], jnp.int32)
    for i in range(8):
        cubeidx = cubeidx + (fvals[:, i] < 0.0).astype(jnp.int32) * (1 << i)
    cubeidx = jnp.where(vox_valid, cubeidx, 0)

    # both LUTs in ONE one-hot matmul over the compacted set: columns =
    # [num_verts | tri rows] (a (256, 17) table)
    lut = jnp.concatenate(
        [nv_tab[:, None].astype(jnp.float32), tri_tab.astype(jnp.float32)], axis=1
    )
    oh = (cubeidx[:, None] == jnp.arange(256, dtype=jnp.int32)[None, :]).astype(
        jnp.float32
    )
    lut_rows = jnp.matmul(
        oh.astype(jnp.bfloat16), lut.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )  # exact: one-hot 0/1 and LUT ints in [-1, 15] are bf16-representable
    occ_nverts = jnp.where(vox_valid, lut_rows[:, 0].astype(jnp.int32), 0)
    v_offsets = jnp.cumsum(occ_nverts) - occ_nverts  # exclusive scan
    total_verts = jnp.minimum(v_offsets[-1] + occ_nverts[-1], max_verts)

    # cube corner positions: (max_voxels, 8, 3); see `convention` docstring
    shift = 0.5 if convention == "center" else 0.0
    base = jnp.stack([vx, vy, vz], axis=-1).astype(jnp.float32)  # (M, 3)
    corner_pos = (base[:, None, :] + offs[None, :, :] + shift) * vs[None, None, :]

    # 12 edge-interpolated vertices: (max_voxels, 12, 3)
    ec = tables.EDGE_CORNERS
    p0 = corner_pos[:, ec[:, 0], :]
    p1 = corner_pos[:, ec[:, 1], :]
    f0 = fvals[:, ec[:, 0]]
    f1 = fvals[:, ec[:, 1]]
    t = (0.0 - f0) / (f1 - f0 + 1e-15)
    vertlist = p0 + t[..., None] * (p1 - p0)  # (M, 12, 3)

    # LUT rows: (max_voxels, 15) edge ids (-1 padding) from the fused lookup
    rows = lut_rows[:, 1:16].astype(jnp.int32)  # (M, 15)
    # per-slot edge select as a masked sum over the 12 edges (gather-free,
    # unrolled elementwise adds)
    verts = jnp.zeros(rows.shape + (3,), jnp.float32)
    for e in range(12):
        verts = verts + jnp.where(
            (rows == e)[..., None], vertlist[:, None, e, :], 0.0
        )

    # emit into the output stream at TRIANGLE granularity. num_verts is
    # always a multiple of 3 and LUT rows emit a prefix of their slots, so
    # the per-voxel triangle counts and offsets are exact; the 9-float
    # rows reshape back to the identical vertex stream.
    max_tris = max_verts // 3
    tris = verts.reshape(verts.shape[0], 5, 9)
    out = emit_triangles(tris, v_offsets // 3, occ_nverts // 3, max_tris)
    stream = out.reshape(max_tris * 3, 3)
    if max_tris * 3 < max_verts:  # keep the advertised (max_verts, 3) shape
        stream = jnp.pad(stream, ((0, max_verts - max_tris * 3), (0, 0)))
    total_verts = jnp.minimum(total_verts, max_tris * 3)
    return stream, total_verts.astype(jnp.int32), n_dropped


def mesh_to_world(vertices: jnp.ndarray, vol: TsdfVolume) -> jnp.ndarray:
    """Volume-frame triangle vertices -> world frame using the volume pose.

    (The reference keeps MC output in volume frame and lets the app export it
    directly; DynFusion consumes it in volume frame too. World-frame export
    is provided for the rigid pipeline's convertToMesh, kinfu.cpp:237-259.)
    """
    return jnp.matmul(
        vertices, vol.pose_r.T, precision=jax.lax.Precision.HIGHEST
    ) + vol.pose_t
