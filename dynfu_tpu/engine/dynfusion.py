"""DynamicFusion orchestrator: the non-rigid reconstruction loop.

Python host class mirroring DynFusion (include/dynfu/dyn_fusion.hpp:45-90,
src/dynfu/dyn_fusion.cpp) on top of the rigid KinFu engine, with the entire
per-frame compute as cached jitted programs.

Per-frame flow (DynFusion::operator(), dyn_fusion.cpp:48-144):
  dists -> bilateral -> [truncate]
  frame 0 (dyn_fusion.cpp:68-98):
    integrate -> marching cubes -> canonical frame (triangle-soup vertices,
    normals = PLACEHOLDER COPY OF VERTICES, the reference's FIXME'd
    workaround) -> node sampling every 128th vertex, identity DQ, dg_w = 3eps
    (dyn_fusion.cpp:151-158) -> warpfield init.
  frame k (dyn_fusion.cpp:100-144):
    pose stays IDENTITY (rigid ICP deliberately not run, dyn_fusion.cpp:102-105)
    -> volume CLEAR + re-integrate from the live depth (the reference's
    FIXME'd workaround at dyn_fusion.cpp:107-116) -> marching cubes -> live
    frame -> warp canonical to live -> 1-NN correspondence (live vertex ->
    warped-canonical vertex, dyn_fusion.cpp:212-242) -> GN solve
    (warpCanonicalToLiveOpt, dyn_fusion.cpp:182-210) -> warpfield update
    (node insertion at unsupported vertices, warp_field.cpp:63-95).

`strict_parity=True` (default) reproduces the reference quirks exactly
(identity pose, clear+reintegrate, placeholder normals). `strict_parity=
False` enables the fixed behaviors: real marching-cubes normals from the
TSDF gradient and rigid ICP for the camera pose — the capabilities the
reference scaffolded but never wired (extractNormals exists but is unused;
"icp--not being done yet").
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dynfu_tpu.core import dualquat as dq
from dynfu_tpu.core import se3
from dynfu_tpu.engine.kinfu import KinFu
from dynfu_tpu.engine.params import DynFuParams
from dynfu_tpu.mesh import edges, marching_cubes
from dynfu_tpu.ops import imgproc, knn
from dynfu_tpu.solver import gn
from dynfu_tpu.solver import se3 as se3_solver
from dynfu_tpu.volume import fusion as vfusion
from dynfu_tpu.volume import tsdf as tv
from dynfu_tpu.warp import field as wfield


class Frame(NamedTuple):
    """dynfu::Frame analog (include/dynfu/utils/frame.hpp:15-33):
    fixed-capacity masked vertex/normal buffers."""

    idx: int
    vertices: jnp.ndarray  # (N, 3)
    normals: jnp.ndarray  # (N, 3)
    mask: jnp.ndarray  # (N,)


class FrameStats(NamedTuple):
    """Per-frame observability scalars, all computed inside the fused
    program (no host callbacks: a callback stalls the device stream until
    the host answers).

    mc_dropped: occupied marching-cubes cells not meshed (capacity
    overflow); corr_dropped: live vertices whose 1-NN window-exactness
    certificate failed and were masked out of the data term. Both should be
    0 on a healthy run — the benchmarks assert it."""

    solve: gn.SolveStats
    mc_dropped: jnp.ndarray  # () int32
    corr_dropped: jnp.ndarray  # () int32


@functools.partial(jax.jit, static_argnames=("capacity", "step", "dg_w"))
def _sample_nodes(verts, vert_mask, capacity: int, step: int, dg_w: float):
    """Every `step`-th valid vertex becomes a node with identity DQ
    (DynFusion::init, dyn_fusion.cpp:151-158). The reference indexes the raw
    (dense) vertex array; here validity-compaction is implicit in the mask."""
    n = verts.shape[0]
    idx = jnp.arange(0, n, step)
    pos = verts[idx]
    mask = vert_mask[idx]
    # pad/trim to capacity
    k = idx.shape[0]
    if k >= capacity:
        pos, mask = pos[:capacity], mask[:capacity]
    else:
        pos = jnp.pad(pos, ((0, capacity - k), (0, 0)))
        mask = jnp.pad(mask, (0, capacity - k))
    count = jnp.sum(mask.astype(jnp.int32))
    # compact valid nodes to the front so count/mask stay consistent
    order = jnp.argsort(~mask, stable=True)
    pos = pos[order]
    mask = mask[order]
    dqs = jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0, 0], jnp.float32), (capacity, 1))
    w = jnp.where(mask, dg_w, 1.0)
    return wfield.WarpField(pos, dqs, w, mask, count)


def _correspondence(warped_verts, warped_normals, warped_mask, live_verts,
                    live_mask, parity: bool, rescue: int = 0,
                    escalate: int = 0, block: int = 1024,
                    window_blocks: int = 3, payload=None):
    """findCorrespondingFrame (dyn_fusion.cpp:212-242): for every live vertex
    the 1-NN WARPED canonical vertex/normal, indexed like the live frame.

    Uses the x-windowed fused 1-NN (ops.knn.nn1_gather_xwindow): live
    vertices arrive nearly x-sorted from marching cubes' x-major emission,
    so only the point set is sorted and the distance pass is windowed
    elementwise work instead of a brute-force distance matrix, in tiles of
    `block` queries against windows of `window_blocks` x `block` points. Queries whose window-exactness certificate fails split into tiers: moving-edge queries (true NN a few
    cm away — farther than the base window's x-margin) certify in a 4x
    `escalate` window; dense x-slab stragglers (e.g. sphere pole caps) get
    an exact brute-force `rescue` scan; only failures beyond both
    capacities are MASKED OUT of the returned correspondence (counted in
    FrameStats.corr_dropped) — the robust data term loses those samples
    rather than gaining possibly-wrong pairs. In parity mode normals are
    the placeholder vertex copy, so only positions are fetched."""
    # NB: the points MUST be re-sorted each frame (presorted=False): the
    # warp's differential displacement (shear across the surface) reorders
    # x beyond the window margins at 512-cube scale — measured 102k/225k
    # certificate failures when the frame-0 MC order was trusted.
    #
    # `payload` — a values_fn(sorted_points, valid) -> (P, F) computing
    # per-point payload rows (the solve's data-graph columns) AFTER the
    # internal sort (payload may not ride lax.sort: its compile time
    # explodes with operand arity). Returns (corr_v, corr_n, mask,
    # fetched_payload). Parity only — fixed mode's normals are per-point
    # DATA (not a function of position), so they ride the sort instead.
    if parity:
        out, exact = knn.nn1_gather_xwindow(
            live_verts, warped_verts, None, warped_mask, live_mask,
            block=block, rescue=rescue, escalate=escalate,
            window_blocks=window_blocks, values_fn=payload,
        )
        # placeholder-normal quirk: normals ARE the vertices
        return out[:, :3], out[:, :3], live_mask & exact, out[:, 3:]
    vals = jnp.concatenate([warped_verts, warped_normals], axis=1)
    out, exact = knn.nn1_gather_xwindow(
        live_verts, warped_verts, vals, warped_mask, live_mask,
        block=block, rescue=rescue, escalate=escalate,
        window_blocks=window_blocks,
    )
    return out[:, :3], out[:, 3:6], live_mask & exact, out[:, 6:]


def _graph_payload(wf, dp):
    """values_fn for the correspondence's post-sort payload fetch: per-point
    data-graph columns for the solve, computed on the SORTED warped
    positions (a pure function of position, so it may run after the
    correspondence's internal sort — payload cannot ride lax.sort, whose
    compile time explodes with arity): [position(3) | knn idx(k) | Gaussian
    weights(k) | re-warped position(3)]. The re-warp is the reference
    quirk — CombinedSolver re-runs calcDQB on its already-warped input for
    the Tukey residuals (opt_solver.cpp:204-231)."""
    def payload(pts_sorted, valid):
        g_idx, _, g_pos, g_dq, g_w, g_valid = wfield.neighbor_features(
            wf, pts_sorted, dp.knn)
        g_dw = wfield.transformation_weights(
            g_pos, g_w, pts_sorted[:, None, :])
        g_dw = jnp.where(g_valid, g_dw, 0.0)
        g_blend = wfield._dqb_from_features(
            pts_sorted, g_pos, g_dq, g_w, g_valid)
        wv2 = dq.dq_transform_point(g_blend, pts_sorted)
        return jnp.concatenate(
            [pts_sorted, g_idx.astype(jnp.float32), g_dw, wv2], axis=1)

    return payload


@functools.partial(
    jax.jit,
    static_argnames=("dp", "intr", "config", "strict_parity",
                     "integrate_mode"),
)
def _nonrigid_frame(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
                    pose, *, dp, intr, config, strict_parity: bool,
                    integrate_mode: str = "separable",
                    canonical_mult=None):
    """The ENTIRE frame-k non-rigid pipeline as one XLA program:
    dists -> clear+integrate -> marching cubes -> warp canonical -> 1-NN
    correspondence -> GN solve -> node insertion (dyn_fusion.cpp:100-144).
    One dispatch per frame; no intermediate host round-trips. Each stage
    runs under a `jax.named_scope` (integrate, extract, warp,
    correspondence, solve, insert) so a profiler trace can attribute
    device time to it (scripts/profile_frame.py)."""
    depth_mm = depth_mm.astype(jnp.int32)  # uint16 wire format widens here
    with jax.named_scope("integrate"):
        vol, planes = _integrate_stage(
            vol, depth_mm, pose, dp, intr, config, strict_parity,
            integrate_mode)
    with jax.named_scope("extract"):
        live_v, live_m, live_n, mesh_verts, n_verts, mc_dropped, fg_dropped = \
            _extract_stage(vol, planes, dp, config, strict_parity)

    # warp canonical -> live with the PRE-solve field (dyn_fusion.cpp:203).
    # NOTE: this pass (k-NN of canonical verts vs nodes) can NOT be shared
    # with the solver's graph pass — the solver queries the WARPED frame
    # against node positions (opt_solver.cpp:56-72), a different query set.
    with jax.named_scope("warp"):
        if dp.solver_rotations and not strict_parity:
            wv, wn = wfield.warp_points_normals_dlb(wf, canonical_v,
                                                    canonical_n)
        else:
            wv, wn = wfield.warp_points_normals(wf, canonical_v, canonical_n)

    # the solve's data graph (k-NN node indices + Gaussian weights at the
    # warped canonical positions — exactly what gn.solve would recompute
    # per LIVE vertex at the fetched corr_v = wv[j] values) is computed
    # ONCE at the ~6x-smaller unique set and rides the correspondence
    # fetch to live indexing, replacing a full (N, D) k-NN inside the
    # solve. SE(3) mode keeps its own pass (its relinearization re-queries).
    use_graph_fetch = strict_parity
    payload = _graph_payload(wf, dp) if use_graph_fetch else None

    with jax.named_scope("correspondence"):
        corr_v, corr_n, corr_m, fetched = _correspondence(
            wv, wn, canonical_m, live_v, live_m, strict_parity,
            rescue=dp.corr_rescue, escalate=dp.corr_escalate,
            block=dp.corr_block, window_blocks=dp.corr_window_blocks,
            payload=payload,
        )

    # full reference schedule (dyn_fusion.cpp:183-189): numIter=24 outer /
    # nonLinearIter=16 inner / linearIter=256, earlyOut. Non-parity modes
    # can solve per-node SE(3) twists instead (the unknowns the reference
    # declared but never wired); corr_v is ALREADY warped, so the SE(3)
    # solve runs in its incremental convention.
    with jax.named_scope("solve"):
        if dp.solver_rotations and not strict_parity:
            wf, solve_stats = se3_solver.solve(
                wf, corr_v, live_v, vert_mask=corr_m & live_m,
                tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
                lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
                linear_iter=dp.solver.linear_iter, knn_k=dp.knn,
                relinearize=dp.se3_relinearize, incremental=True,
                rot_prior=dp.se3_rot_prior, trans_prior=dp.se3_trans_prior,
                similarity_reg=dp.se3_similarity_reg,
            )
        else:
            k = dp.knn
            graph_w = None
            if use_graph_fetch:
                graph_w = (fetched[:, :k], fetched[:, k:2 * k],
                           fetched[:, 2 * k:2 * k + 3])
            wf, solve_stats = gn.solve(
                wf, corr_v, live_v, vert_mask=corr_m & live_m,
                graph_w=graph_w,
                tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
                lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
                linear_iter=dp.solver.linear_iter, knn_k=dp.knn,
                nonlinear_iter=dp.solver.nonlinear_iter,
                num_iter=dp.solver.num_iter, early_out=dp.solver.early_out,
            )

    # node insertion from the warped canonical frame (dyn_fusion.cpp:142)
    with jax.named_scope("insert"):
        wf = wfield.update_warpfield(
            wf, wv, canonical_m, dp.epsilon, dp.node_voxel_leaf,
            dp.max_new_nodes,
            blend="dlb" if (dp.solver_rotations and not strict_parity)
            else "dqb",
            vert_weights=canonical_mult,
        )
    corr_dropped = (jnp.sum((live_m & ~corr_m).astype(jnp.int32))
                    + fg_dropped)
    stats = FrameStats(solve_stats, mc_dropped, corr_dropped)
    return vol, wf, wv, wn, live_v, live_n, live_m, mesh_verts, n_verts, stats


def _integrate_stage(vol, depth_mm, pose, dp, intr, config, strict_parity,
                     integrate_mode):
    """dists + clear/integrate of `_nonrigid_frame`: (vol, planes)."""
    dists = imgproc.compute_dists(depth_mm, intr)

    # clear + re-integrate (dyn_fusion.cpp:107-116) — fused on the
    # separable paths (fresh=True is bit-identical and skips the clear's
    # full-volume write plus the previous-state reads). On the unique-edge
    # path the integrate also emits the packed (tsdf<0, weight!=0) z-column
    # bitplanes while each z-chunk is live, so the edge extraction below
    # stops re-reading the ~400 MB stored volume to rebuild them.
    want_planes = dp.corr_unique_edges and strict_parity
    planes = None
    if integrate_mode == "separable":
        out = tv.integrate_separable(vol, dists, pose, intr, config,
                                     fresh=True, emit_bitplanes=want_planes)
        vol, planes = out if want_planes else (out, None)
    elif integrate_mode == "rotated":
        out = tv.integrate_rotated(vol, dists, pose, intr, config,
                                   fresh=True, emit_bitplanes=want_planes)
        vol, planes = out if want_planes else (out, None)
    else:
        vol = tv.integrate(tv.clear(vol), dists, pose, intr, config)
    return vol, planes


def _extract_stage(vol, planes, dp, config, strict_parity):
    """Live-surface extraction of `_nonrigid_frame` (plus the foreground
    compaction): (live_v, live_m, live_n, mesh_verts, n_verts, mc_dropped,
    fg_dropped)."""
    if dp.corr_unique_edges and strict_parity:
        # unique-vertex extraction (mesh/edges.py): correspondence + solve
        # consume the vertex SET; the triangle soup is extracted on demand
        # by DynFusion.mesh() from the retained volume
        live_v, n_verts, mc_dropped = edges.isosurface_edge_vertices(
            vol, config,
            max_edges=dp.max_edge_verts or dp.max_vertices // 2,
            col_budget=dp.edge_col_budget or dp.mc_col_budget,
            bitplanes=planes)
        mesh_verts = live_v
    else:
        mesh_verts, n_verts, mc_dropped = marching_cubes(
            vol, config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices, col_budget=dp.mc_col_budget,
        )
        live_v = mesh_verts
    live_m = jnp.arange(live_v.shape[0]) < n_verts
    if strict_parity:
        live_n = live_v  # placeholder-normal quirk (dyn_fusion.cpp:126-134)
    else:
        live_n = tv.extract_normals(vol, live_v, config, frame="volume")

    # foreground tracking (DynFuParams.fg_aabb): compact the tracked live
    # set to the dynamic-foreground box so correspondence + solve scale
    # with the FOREGROUND capacity, not the whole scene (the umbrella's
    # wall/floor are ~80% of its 512k unique vertices and perfectly
    # static — VolumeDeform's own masks solve the same problem). The full
    # extraction above still feeds mesh()/exports; rank_select preserves
    # x-major scan order, so the correspondence certificate logic is
    # untouched. Untracked-overflow counts into corr_dropped.
    fg_dropped = jnp.int32(0)
    if dp.fg_aabb is not None and dp.max_fg_verts > 0:
        from dynfu_tpu.ops import compaction

        (flo, fhi) = dp.fg_aabb
        inb = (live_m
               & (live_v[:, 0] >= flo[0]) & (live_v[:, 0] < fhi[0])
               & (live_v[:, 1] >= flo[1]) & (live_v[:, 1] < fhi[1])
               & (live_v[:, 2] >= flo[2]) & (live_v[:, 2] < fhi[2]))
        n_fg = jnp.sum(inb.astype(jnp.int32))
        Nfull = live_v.shape[0]
        fidx = compaction.rank_select(inb, size=dp.max_fg_verts, fill=Nfull)
        fok = fidx < Nfull
        fsafe = jnp.minimum(fidx, Nfull - 1)
        live_v = jnp.where(fok[:, None], live_v[fsafe], 0.0)
        live_n = live_v if strict_parity else jnp.where(
            fok[:, None], live_n[fsafe], 0.0)
        live_m = fok
        fg_dropped = jnp.maximum(n_fg - dp.max_fg_verts, 0)
    return live_v, live_m, live_n, mesh_verts, n_verts, mc_dropped, fg_dropped


class FusionFrameStats(NamedTuple):
    """FrameStats analog for the fusion-mode frame: same observability
    scalars plus the canonical-volume band-compaction counters."""

    solve: gn.SolveStats
    mc_dropped: jnp.ndarray  # () int32
    corr_dropped: jnp.ndarray  # () int32
    band: vfusion.FusionStats


@functools.partial(jax.jit, static_argnames=("intr", "thresh", "dilate"))
def _mask_deforming_depth(depth_mm, cv, wv, m, pose, vol_r, vol_t, *,
                          intr, thresh: float, dilate: int):
    """Zero out depth pixels covered by the KNOWN-DEFORMING canonical
    region so frame-to-frame rigid ICP tracks the camera on static
    structure only.

    A rigid fit over the full image absorbs the dominant object's
    coherent deformation as camera motion (measured at 512-cube: the ICP
    reported -3.3 mm x for a 4 mm/frame deforming sphere under a pure-y
    camera track, and the world anchor drifted with the object). The
    engine already knows the deformation per canonical vertex —
    |warped - canonical| — so vertices moving more than `thresh` project
    to an exclusion mask (dilated; the object moves a few px/frame).
    Frame 1 has an identity warp and masks nothing: its one-frame
    contamination is bounded by a single frame's deformation."""
    H, W = depth_mm.shape
    disp = jnp.sum((wv - cv) ** 2, axis=-1)
    deforming = m & (disp > thresh * thresh)
    cam_from_vol = se3.compose(se3.inverse(pose), (vol_r, vol_t))
    vc = _apply_rows(cam_from_vol, wv)
    u = intr.fx * vc[:, 0] / jnp.maximum(vc[:, 2], 1e-6) + intr.cx
    v = intr.fy * vc[:, 1] / jnp.maximum(vc[:, 2], 1e-6) + intr.cy
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (vc[:, 2] > 0)
    ui = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 1)
    hit = (deforming & in_img).astype(jnp.int32)
    img = jnp.zeros((H, W), jnp.int32).at[vi, ui].max(hit)
    win = 2 * dilate + 1
    img = jax.lax.reduce_window(img, jnp.int32(0), jax.lax.max,
                                (win, win), (1, 1), "SAME")
    return jnp.where(img > 0, 0, depth_mm)


@jax.jit
def _expand_rows(verts, normals, soup_inverse, soup_mask):
    idx = jnp.minimum(soup_inverse, jnp.int32(verts.shape[0] - 1))
    return (jnp.where(soup_mask[:, None], verts[idx], 0.0),
            jnp.where(soup_mask[:, None], normals[idx], 0.0))


def _apply_rows(pose, p):
    """(R, t) applied to (N, 3) points by broadcast sums: exact f32
    without a K=3 matmul (see volume/tsdf.py integrate)."""
    R, t = pose
    return (p[:, 0:1] * R[None, :, 0] + p[:, 1:2] * R[None, :, 1]
            + p[:, 2:3] * R[None, :, 2] + t)


@functools.partial(jax.jit, static_argnames=("dp", "intr", "config",
                                             "solve_enabled"))
def _fusion_frame(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
                  pose, *, dp, intr, config, solve_enabled: bool = True):
    """Frame k of the PERSISTENT-canonical pipeline (mode="fusion") as one
    XLA program — the DynamicFusion fusion model (Newcombe et al. §3.3)
    the reference scaffolded but never built (dyn_fusion.cpp:107-116):

      dists/points -> warp canonical -> PROJECTIVE correspondence against
      the live depth vertex map -> GN solve -> warped-back TSDF integration
      into the canonical volume -> marching cubes re-extraction of the
      canonical surface -> node insertion.

    Unlike the parity path the canonical volume is never cleared: every
    frame's observations accumulate through the warp, which averages away
    single-frame depth quantization and is the path below the parity
    pipeline's voxel-discretization error floor.
    """
    depth_mm = depth_mm.astype(jnp.int32)  # uint16 wire format widens here
    H, W = depth_mm.shape
    dists = imgproc.compute_dists(depth_mm, intr)
    live_pts, live_ns = imgproc.compute_points_normals(depth_mm, intr)

    # warp canonical -> live with the pre-solve field; reuse the neighbor
    # pass AT THE WARPED POSITIONS as the solver's data graph (incremental
    # convention: the engine always hands the solver warped positions, so
    # the solved transforms compose onto the current node DQs). With
    # solver_rotations the warp is the PROPER DLB blend (normals rotate;
    # the reference-quirk DQB cannot blend rotations at all).
    if dp.solver_rotations:
        wv, wn = wfield.warp_points_normals_dlb(wf, canonical_v, canonical_n)
    else:
        wv, wn = wfield.warp_points_normals(wf, canonical_v, canonical_n)
    data_idx, _, n_pos, n_dq, n_w, n_valid = wfield.neighbor_features(
        wf, wv, dp.knn)

    # projective association: project each warped vertex into the live
    # image and take the depth vertex + normal at that pixel
    # (proj_icp.cu:42-99's O(N) image-space association, vs the
    # reference's 1-NN mesh search)
    cam_from_vol = se3.compose(se3.inverse(pose), (vol.pose_r, vol.pose_t))
    vc = _apply_rows(cam_from_vol, wv)
    u = intr.fx * vc[:, 0] / vc[:, 2] + intr.cx
    v = intr.fy * vc[:, 1] / vc[:, 2] + intr.cy
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (vc[:, 2] > 0)
    ui = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 1)
    lp_cam = live_pts[vi, ui]  # (N, 3), NaN at invalid pixels
    ln_cam = live_ns[vi, ui]  # (N, 3), NaN at invalid pixels
    lp_vol = _apply_rows(se3.inverse(cam_from_vol), lp_cam)
    Rcv, _ = cam_from_vol  # vol->cam rotation; normals go cam->vol via R^T
    ln_vol = (ln_cam[:, 0:1] * Rcv[None, 0] + ln_cam[:, 1:2] * Rcv[None, 1]
              + ln_cam[:, 2:3] * Rcv[None, 2])
    dist2 = jnp.sum((lp_vol - wv) ** 2, axis=-1)
    # the depth vertex at the floor'd pixel is NOT the closest surface
    # point — its tangential offset (surface parallax across the pixel) is
    # a systematic bias that a point-to-point solve would chase, deforming
    # a perfectly static scene. Project the target onto the live tangent
    # plane (the point-to-plane trick of projective ICP): the footpoint
    # wv + n·(lp-wv) n keeps only the normal-distance component.
    n_dot = jnp.sum(ln_vol * (lp_vol - wv), axis=-1)
    foot = wv + n_dot[:, None] * ln_vol
    # facing gate: needs a PROPERLY rotated canonical normal. The DLB
    # branch's wn is one; the quirk-DQB branch's wn carries the blended
    # TRANSLATION too (dq_transform_normal == transformVertex), which at
    # decimeter-scale accumulated warps swamps the cosine — but a
    # translations-only field has identity blended rotation, so the
    # properly-rotated normal IS the canonical normal unchanged.
    facing_n = wn if dp.solver_rotations else canonical_n
    facing = jnp.sum(ln_vol * facing_n, axis=-1) > 0.0
    corr_m = (canonical_m & in_img & jnp.isfinite(lp_cam[:, 0])
              & jnp.isfinite(ln_cam[:, 0]) & facing
              & (dist2 < dp.fusion_corr_dist ** 2))
    lp_vol = jnp.where(corr_m[:, None], foot, 0.0)

    if not solve_enabled:
        # warm-up frames: integrate without warping (see
        # DynFuParams.fusion_warmup_frames)
        z = jnp.float32(0.0)
        if dp.solver_rotations:
            solve_stats = se3_solver.Se3Stats(z, z, jnp.int32(0), z)
        else:
            solve_stats = gn.SolveStats(z, z, jnp.int32(0), z)
    elif dp.solver_rotations:
        wf, solve_stats = se3_solver.solve(
            wf, wv, lp_vol, vert_mask=corr_m,
            tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
            lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
            linear_iter=dp.solver.linear_iter, knn_k=dp.knn,
            relinearize=dp.se3_relinearize, incremental=True,
            rot_prior=dp.se3_rot_prior, trans_prior=dp.se3_trans_prior,
            similarity_reg=dp.se3_similarity_reg,
            min_update=dp.fusion_min_update_vox * min(config.voxel_size),
            # trust region tied to the association gate: every data target
            # is within fusion_corr_dist of its warped vertex, so a larger
            # per-frame node step cannot be data-driven (solver/se3.py)
            max_update=dp.fusion_corr_dist,
        )
    else:
        wf, solve_stats = gn.solve(
            wf, wv, lp_vol, vert_mask=corr_m,
            graph=(data_idx, n_pos, n_w, n_valid, wv),
            tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
            lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
            linear_iter=dp.solver.linear_iter, knn_k=dp.knn,
            nonlinear_iter=dp.solver.nonlinear_iter,
            num_iter=dp.solver.num_iter, early_out=dp.solver.early_out,
            min_update=dp.fusion_min_update_vox * min(config.voxel_size),
            max_update=dp.fusion_corr_dist,
        )

    # fuse the live observations back into the canonical volume through
    # the UPDATED field
    vol, band_stats = vfusion.integrate_warped(
        vol, wf, dists, pose, intr, config,
        normals=live_ns, min_cos=dp.fusion_min_cos,
        max_active=dp.fusion_max_active, dilate=dp.fusion_dilate,
        knn_k=dp.knn,
        col_budget=dp.fusion_col_budget or dp.mc_col_budget,
        blend="dlb" if dp.solver_rotations else "dqb",
    )

    # re-extract the canonical surface (it grows/refines as observations
    # accumulate) + TSDF-gradient normals, then insert nodes where the new
    # surface is unsupported (warp_field.cpp:63-95)
    if dp.corr_unique_edges:
        # unique vertex set (mesh/edges.py): the re-extracted canonical is
        # consumed by gradient normals, the mesh warp, projective
        # correspondence and insertion — all ~5x cheaper at unique
        # granularity (extract_normals on the 512-cube soup dominated the
        # fusion frame); the triangle soup stays available
        # on demand (DynFusion.mesh()). Normals ride the extraction
        # (lerped endpoint lattice gradients — 4x fewer element gathers
        # than the 6-trilinear-sample extract_normals).
        mesh_verts, n_verts, mc_dropped, new_n = \
            edges.isosurface_edge_vertices(
                vol, config,
                max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                convention="corner",  # consistent with the integrator
                col_budget=dp.edge_col_budget or dp.mc_col_budget,
                with_normals=True,
            )
    else:
        mesh_verts, n_verts, mc_dropped = marching_cubes(
            vol, config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices,
            convention="corner",  # consistent with the integrator — mc.py
            col_budget=dp.mc_col_budget,
        )
        new_n = tv.extract_normals(vol, mesh_verts, config, frame="volume")
    new_m = jnp.arange(mesh_verts.shape[0]) < n_verts
    if dp.solver_rotations:
        wv2, wn2 = wfield.warp_points_normals_dlb(wf, mesh_verts, new_n)
    else:
        wv2, wn2 = wfield.warp_points_normals(wf, mesh_verts, new_n)
    # candidates outside the volume (+ truncation margin) are verts dragged
    # away by a rogue warp, not new geometry — see update_warpfield(aabb=)
    X, Y, Z = config.dims
    vsx, vsy, vsz = config.voxel_size
    m = 2.0 * config.trunc_dist
    wf = wfield.update_warpfield(
        wf, wv2, new_m, dp.epsilon, dp.node_voxel_leaf, dp.max_new_nodes,
        blend="dlb" if dp.solver_rotations else "dqb",
        aabb=((-m, -m, -m), (X * vsx + m, Y * vsy + m, Z * vsz + m)),
    )

    corr_dropped = jnp.sum((canonical_m & ~corr_m).astype(jnp.int32))
    stats = FusionFrameStats(solve_stats, mc_dropped, corr_dropped,
                             band_stats)
    return (vol, wf, mesh_verts, new_n, new_m, n_verts, wv2, wn2, stats)


class DynFusion(KinFu):
    """Non-rigid fusion engine. Call with (H, W) int32 mm depth images."""

    def __init__(self, params: Optional[DynFuParams] = None,
                 strict_parity: bool = True, mode: Optional[str] = None):
        """mode: "parity" (reference-quirk reproduction, default),
        "fixed" (reference pipeline with the scaffolded-but-unwired fixes:
        rigid ICP pose, real MC normals), or "fusion" (persistent canonical
        volume with warped-back integration — see _fusion_frame)."""
        if mode is None:
            mode = "parity" if strict_parity else "fixed"
        if mode not in ("parity", "fixed", "fusion"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        strict_parity = mode == "parity"
        self.dynfu_params = params or DynFuParams.default_params()
        self.strict_parity = strict_parity
        super().__init__(self.dynfu_params.kinfu)
        self.warpfield: Optional[wfield.WarpField] = None
        self.canonical: Optional[Frame] = None
        self.canonical_warped: Optional[Frame] = None
        self._fg_canonical: Optional[Frame] = None
        self._fg_mult = None
        # canonical dedup state (parity/fixed modes): the canonical is a
        # triangle SOUP (3 verts/triangle, each mesh vertex appears ~6x),
        # fixed at frame 0 — deduplicating once on the host shrinks every
        # per-frame pass over it (warp, correspondence points, insertion)
        # ~6x. Outputs expand back to the soup (warped_cloud), so export
        # and metric semantics are unchanged.
        self.soup_inverse = None  # (max_vertices,) int32 -> unique slot
        self.soup_mask = None  # (max_vertices,) bool original soup mask
        self.canonical_mult = None  # (Ucap,) f32 soup multiplicity
        self.prev_live_pyr = None  # fusion_camera_tracking reference pyramid
        self.live: Optional[Frame] = None
        self.mesh_vertices = None  # last MC triangle soup (buffer, count)
        self.last_frame_stats: Optional[FrameStats] = None
        self.last_solve_stats: Optional[gn.SolveStats] = None

    # -- helpers ------------------------------------------------------------
    def _mc_frame(self, idx: int) -> Frame:
        """Marching cubes -> triangle-soup Frame. Normals are a placeholder
        copy of the vertices in parity mode (pcl::copyPointCloud workaround,
        dyn_fusion.cpp:80-88,126-134); real TSDF-gradient normals otherwise."""
        dp = self.dynfu_params
        verts, n_verts, _ = marching_cubes(
            self.vol, self.tsdf_config,
            max_voxels=dp.max_mc_voxels, max_verts=dp.max_vertices,
            # fusion mode needs MC verts consistent with the TSDF sample
            # positions (see mc.py convention docstring); parity/fixed keep
            # the reference's half-voxel-shifted meshes
            convention="corner" if self.mode == "fusion" else "center",
            col_budget=dp.mc_col_budget,
        )
        mask = jnp.arange(verts.shape[0]) < n_verts
        self.mesh_vertices = (verts, n_verts)
        if self.strict_parity:
            normals = verts
        else:
            # MC verts are volume-frame; ask for volume-frame normals too
            normals = tv.extract_normals(self.vol, verts, self.tsdf_config,
                                         frame="volume")
        return Frame(idx, verts, normals, mask)

    def _fg_enabled(self) -> bool:
        dp = self.dynfu_params
        return (dp.fg_aabb is not None and dp.max_fg_verts > 0
                and self.mode != "fusion")

    def _fg_box_mask(self, v):
        lo, hi = self.dynfu_params.fg_aabb
        return ((v[:, 0] >= lo[0]) & (v[:, 0] < hi[0])
                & (v[:, 1] >= lo[1]) & (v[:, 1] < hi[1])
                & (v[:, 2] >= lo[2]) & (v[:, 2] < hi[2]))

    def _fg_compact(self, frame: Frame):
        """One-time host compaction of the deduped canonical to the
        foreground box (see DynFuParams.fg_aabb): the tracked canonical
        the per-frame program consumes. The FULL canonical stays in
        self.canonical for meshes/exports; background vertices warp to
        ~identity on demand (their node weights vanish)."""
        import numpy as np

        v = np.asarray(frame.vertices)
        m = np.asarray(frame.mask)
        lo, hi = self.dynfu_params.fg_aabb
        inb = (m & (v[:, 0] >= lo[0]) & (v[:, 0] < hi[0])
               & (v[:, 1] >= lo[1]) & (v[:, 1] < hi[1])
               & (v[:, 2] >= lo[2]) & (v[:, 2] < hi[2]))
        idx = np.nonzero(inb)[0]
        cap = self.dynfu_params.max_fg_verts
        if len(idx) > cap:
            print(f"fg canonical overflow: {len(idx)} > {cap} "
                  f"(tracking the first {cap})")
            idx = idx[:cap]
        fv = np.zeros((cap, 3), np.float32)
        fv[: len(idx)] = v[idx]
        fn = np.zeros((cap, 3), np.float32)
        fn[: len(idx)] = np.asarray(frame.normals)[idx]
        fm = np.zeros(cap, bool)
        fm[: len(idx)] = True
        fmult = None
        if self.canonical_mult is not None:
            fmu = np.zeros(cap, np.float32)
            fmu[: len(idx)] = np.asarray(self.canonical_mult)[idx]
            fmult = jnp.asarray(fmu)
        return (Frame(frame.idx, jnp.asarray(fv), jnp.asarray(fn),
                      jnp.asarray(fm)), fmult)

    def _dedup_canonical(self, frame: Frame) -> Frame:
        """ONE-time host dedup of the frame-0 canonical soup.

        Marching cubes emits 3 vertices per triangle, so each mesh vertex
        appears ~6x in the soup (V ~ T/2 for closed surfaces): the unique
        set is ~6x smaller, and every per-frame pass over the canonical
        (warp, correspondence point set, insertion) scales with it. The
        inverse map expands warped outputs back to the soup at the engine
        boundary (warped_cloud), and the multiplicity vector keeps node
        insertion's voxel-downsample centroids EXACTLY soup-weighted —
        external behavior is unchanged.

        Host-side numpy (one ~3 MB readback at frame 0); the unique
        capacity is bucketed to a power of two so jaxpr caches survive
        scene-to-scene vertex-count jitter."""
        import numpy as np

        v = np.asarray(frame.vertices)
        n = np.asarray(frame.normals)
        m = np.asarray(frame.mask)
        valid_idx = np.nonzero(m)[0]
        uniq, first_idx, inv = np.unique(
            v[valid_idx], axis=0, return_index=True, return_inverse=True)
        U = max(int(uniq.shape[0]), 1)
        ucap = 1 << max(10, (U - 1).bit_length())
        mult = np.bincount(inv, minlength=U).astype(np.float32)

        uv = np.zeros((ucap, 3), np.float32)
        uv[:U] = uniq
        un = np.zeros((ucap, 3), np.float32)
        un[:U] = n[valid_idx][first_idx]
        um = np.zeros(ucap, bool)
        um[:U] = True
        umult = np.zeros(ucap, np.float32)
        umult[:U] = mult

        inv_full = np.full(v.shape[0], ucap, np.int32)
        inv_full[valid_idx] = inv.astype(np.int32)
        self.soup_inverse = jnp.asarray(inv_full)
        self.soup_mask = frame.mask
        self.canonical_mult = jnp.asarray(umult)
        return Frame(frame.idx, jnp.asarray(uv), jnp.asarray(un),
                     jnp.asarray(um))

    def _expand_to_soup(self, frame: Frame) -> Frame:
        """Unique-granularity frame -> original soup order (one gather at
        the engine boundary; not on the per-frame hot path). Jitted: the
        eager formulation paid ~7 dispatches with unfused 262k-row
        gathers (it sat inside every benchmark window's error readback)."""
        if self.soup_inverse is None:
            return frame
        v, n = _expand_rows(frame.vertices, frame.normals,
                            self.soup_inverse, self.soup_mask)
        return Frame(frame.idx, v, n, self.soup_mask)

    def _fusion_track_pose(self, depth_mm) -> None:
        """Frame-to-frame rigid camera tracking for fusion mode
        (fusion_camera_tracking): projective point-to-plane ICP of the
        current depth pyramid against the PREVIOUS frame's — the moving
        camera's motion is recovered rigidly so the warp solve only sees
        true deformation. Uses the same stencil-association fast path +
        gather rescue as the rigid engine (kinfu.py __call__); a
        degenerate solve keeps the previous pose (one frame of identity
        increment, not a reconstruction reset — the canonical volume is
        persistent and too valuable to drop)."""
        import numpy as np

        depth_mm = jnp.asarray(depth_mm, jnp.int32)  # widen uint16 input

        from dynfu_tpu.rigid import icp as _icp

        p = self.params
        depth_icp = depth_mm
        if (self.canonical is not None and self.canonical_warped is not None
                and self.canonical.vertices.shape
                == self.canonical_warped.vertices.shape):
            depth_icp = _mask_deforming_depth(
                depth_mm, self.canonical.vertices,
                self.canonical_warped.vertices, self.canonical_warped.mask,
                self.poses[-1], self.vol.pose_r, self.vol.pose_t,
                intr=p.intr,
                thresh=float(min(self.tsdf_config.voxel_size)), dilate=8)
        _, curr_pyr = self._preprocess(depth_icp)
        if self.prev_live_pyr is None:
            self.prev_live_pyr = curr_pyr
            self.poses.append(self.poses[-1])
            return

        def _pull(res):
            (R, t), ok = res
            return np.asarray(jnp.concatenate(
                [R.reshape(-1), t, ok.astype(jnp.float32)[None]]))

        packed = None
        if p.icp_assoc == "stencil":
            packed = _pull(_icp.estimate_transform_stencil(
                curr_pyr, self.prev_live_pyr, p.intr, iters=p.icp_iter_num,
                dist_thres=p.icp_dist_thres, angle_thres=p.icp_angle_thres,
                radii=p.icp_stencil_radii))
        if packed is None or packed[12] == 0.0:
            packed = _pull(_icp.estimate_transform(
                curr_pyr, self.prev_live_pyr, p.intr, iters=p.icp_iter_num,
                dist_thres=p.icp_dist_thres, angle_thres=p.icp_angle_thres))
        if packed[12] != 0.0:
            R, t = packed[:9].reshape(3, 3), packed[9:12]
            Rp, tp = self.poses[-1]
            self.poses.append((Rp @ R, Rp @ t + tp))
        else:
            self.poses.append(self.poses[-1])
        self.prev_live_pyr = curr_pyr

    def _preprocess_nonrigid(self, depth_mm: jnp.ndarray):
        """dists/bilateral/truncate only (dyn_fusion.cpp:53-65; no pyramid —
        the non-rigid path never runs multi-scale ICP in parity mode)."""
        p = self.params
        dists = imgproc.compute_dists(depth_mm, p.intr)
        filtered = imgproc.bilateral_filter(
            depth_mm, p.bilateral_kernel_size, p.bilateral_sigma_spatial,
            p.bilateral_sigma_depth,
        )
        if p.icp_truncate_depth_dist > 0:
            filtered = imgproc.truncate_depth(filtered, p.icp_truncate_depth_dist)
        return dists, filtered

    # -- the loop -----------------------------------------------------------
    def __call__(self, depth_mm, image=None) -> bool:
        """Frame ingestion; `image` mirrors DynFusion::operator()(Depth,
        Image) (dyn_fusion.hpp:50) — accepted and unused, as in the
        reference."""
        del image  # reference parity: color is part of the API, not the math
        dp = self.dynfu_params
        p = self.params
        # uint16 input (the Kinect wire format — the reference's depth is
        # ushort, kinfu.cpp:16-18) is passed through to the jitted frame
        # and widened there: casting eagerly would cost an extra dispatch,
        # and uploading int32 doubles the per-frame host->device transfer
        depth_mm = jnp.asarray(depth_mm)
        if depth_mm.dtype not in (jnp.int32, jnp.uint16, jnp.int16):
            depth_mm = depth_mm.astype(jnp.int32)

        if self.frame_counter == 0:
            depth_mm = depth_mm.astype(jnp.int32)  # once, off the hot loop
            dists, filtered = self._preprocess_nonrigid(depth_mm)
            # pose is identity for the whole parity pipeline -> separable path
            self.vol = tv.integrate_separable(self.vol, dists, self.poses[-1],
                                              p.intr, self.tsdf_config)
            frame = self._mc_frame(0)
            # node sampling strides the SOUP (dyn_fusion.cpp:151 indexes the
            # raw vertex array) — sample before any dedup
            node_mask = frame.mask
            if self._fg_enabled():
                # foreground tracking: sample nodes from the dynamic box
                # only — the reference strides the whole soup, which on a
                # full-scene capture spends ~80% of the node budget on
                # static background the solve never moves
                node_mask = frame.mask & self._fg_box_mask(frame.vertices)
            self.warpfield = _sample_nodes(
                frame.vertices, node_mask, dp.max_nodes, dp.node_sample_step,
                dp.init_node_dg_w_factor * dp.epsilon,
            )
            if self.mode != "fusion":
                frame = self._dedup_canonical(frame)
                if self._fg_enabled():
                    self._fg_canonical, self._fg_mult = \
                        self._fg_compact(frame)
            else:
                if dp.fusion_camera_tracking:
                    _, self.prev_live_pyr = self._preprocess(depth_mm)
                if dp.corr_unique_edges:
                    # fusion canonical at unique-vertex granularity from
                    # frame 0 so every _fusion_frame shares ONE shape
                    # (node sampling above strides the SOUP, the parity
                    # quirk, before this replacement)
                    ev, ne, _, en = edges.isosurface_edge_vertices(
                        self.vol, self.tsdf_config,
                        max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                        convention="corner",
                        col_budget=dp.edge_col_budget or dp.mc_col_budget,
                        with_normals=True)
                    frame = Frame(0, ev, en,
                                  jnp.arange(ev.shape[0]) < ne)
            self.canonical = frame
            self.canonical_warped = frame
            self.frame_counter += 1
            return False

        if self.mode == "fusion":
            # camera pose: identity increment by default (the reference
            # never wires ICP either, dyn_fusion.cpp:102-105); with
            # fusion_camera_tracking, frame-to-frame projective ICP on the
            # depth pyramids recovers the rigid camera motion BEFORE the
            # non-rigid solve sees the residual (deforming regions fall to
            # the ICP distance/angle gates like any outlier)
            if dp.fusion_camera_tracking:
                self._fusion_track_pose(depth_mm)
            else:
                self.poses.append(self.poses[-1])
            c = self.canonical
            (self.vol, self.warpfield, new_v, new_n, new_m, n_verts, wv2,
             wn2, self.last_frame_stats) = _fusion_frame(
                self.vol, self.warpfield, c.vertices, c.normals, c.mask,
                depth_mm, self.poses[-1],
                dp=dp, intr=p.intr, config=self.tsdf_config,
                solve_enabled=self.frame_counter > dp.fusion_warmup_frames,
            )
            self.canonical = Frame(self.frame_counter, new_v, new_n, new_m)
            self.canonical_warped = Frame(self.frame_counter, wv2, wn2, new_m)
            self.live = self.canonical_warped
            if dp.corr_unique_edges:
                self.mesh_vertices = None  # soup on demand (mesh())
            else:
                self.mesh_vertices = (new_v, n_verts)
            self.last_solve_stats = self.last_frame_stats.solve
            self.frame_counter += 1
            return True

        if self.strict_parity:
            # pose: identity increment in parity mode (dyn_fusion.cpp:102-105)
            self.poses.append(self.poses[-1])
        else:
            # fixed mode: the rigid ICP the reference stubbed out
            # ("icp--not being done yet", dyn_fusion.cpp:100-105) — estimate
            # the camera pose against the previous raycast pyramid
            _, curr_pyr = self._preprocess(depth_mm)
            if self.prev_pyr is not None:
                from dynfu_tpu.rigid import icp as _icp

                import numpy as np

                (R, t), ok = _icp.estimate_transform(
                    curr_pyr, self.prev_pyr, p.intr, iters=p.icp_iter_num,
                    dist_thres=p.icp_dist_thres, angle_thres=p.icp_angle_thres,
                )
                # one packed readback (R, t, ok) — poses are host numpy
                packed = np.asarray(jnp.concatenate(
                    [R.reshape(-1), t, ok.astype(jnp.float32)[None]]))
                if packed[12] != 0.0:
                    Rp, tp = self.poses[-1]
                    Rn, tn = packed[:9].reshape(3, 3), packed[9:12]
                    self.poses.append((Rp @ Rn, Rp @ tn + tp))
                else:
                    self.poses.append(self.poses[-1])
            else:
                self.poses.append(self.poses[-1])

        if self._fg_enabled():
            c, cmult = self._fg_canonical, self._fg_mult
        else:
            c, cmult = self.canonical, self.canonical_mult
        pose = self.poses[-1]
        if self._aligned(pose):
            imode = "separable"
        elif self._rotation_angle(pose) < self.MAX_HOMOGRAPHY_TILT:
            imode = "rotated"
        else:
            imode = "gather"
        (self.vol, self.warpfield, wv, wn, live_v, live_n, live_m,
         mesh_verts, n_verts, self.last_frame_stats) = _nonrigid_frame(
            self.vol, self.warpfield, c.vertices, c.normals, c.mask,
            depth_mm, pose,
            dp=dp, intr=p.intr, config=self.tsdf_config,
            strict_parity=self.strict_parity, integrate_mode=imode,
            canonical_mult=cmult,
        )
        self.canonical_warped = Frame(c.idx, wv, wn, c.mask)
        self.live = Frame(self.frame_counter, live_v, live_n, live_m)
        if dp.corr_unique_edges and self.strict_parity:
            # the frame program extracted unique vertices only; the
            # triangle soup is available on demand from the retained
            # volume (mesh())
            self.mesh_vertices = None
        else:
            self.mesh_vertices = (mesh_verts, n_verts)
        self.last_solve_stats = self.last_frame_stats.solve

        if not self.strict_parity:
            # fixed mode: refresh the rigid-ICP reference pyramid from the
            # fused model (KinFu::operator() raycast stage)
            pts, nrm = self._raycast(self.poses[-1])
            prev = [(pts, nrm)]
            for _ in range(1, self.levels):
                prev.append(imgproc.resize_points_normals(*prev[-1]))
            self.prev_pyr = prev

        self.frame_counter += 1
        return True

    # -- outputs ------------------------------------------------------------
    def render(self, flag: int = 0):
        """Offline render of the current live volume (replaces the
        reference's OpenCV Viz window). Raycasts the fused TSDF from the
        current camera pose and Phong-shades it."""
        p = self.params
        pts, nrm = self._raycast(self.poses[-1])
        saved = self.prev_pyr  # fixed mode keeps its ICP reference pyramid
        self.prev_pyr = [(pts, nrm)]
        try:
            return super().render(flag)
        finally:
            self.prev_pyr = saved

    def _full_canonical_warped(self) -> Frame:
        """canonical_warped at FULL-canonical granularity. With foreground
        tracking the per-frame program warps only the tracked box, so this
        warps the full canonical on demand (background vertices see ~zero
        node weights and stay put) — an export-boundary cost, not a
        per-frame one."""
        if not self._fg_enabled():
            return self.canonical_warped
        c = self.canonical
        wv, wn = wfield.warp_points_normals(
            self.warpfield, c.vertices, c.normals)
        return Frame(c.idx, wv, wn, c.mask)

    def get_canonical_warped_to_live(self) -> Frame:
        return self._expand_to_soup(self._full_canonical_warped())

    def warped_cloud(self, unique: bool = False):
        """Current warped canonical vertices (the .pcd export of the demo app,
        demo.cpp:21-31). Returns (verts (N,3), mask) in the original SOUP
        order (internally the canonical is deduplicated; see
        _dedup_canonical).

        unique=True returns the deduplicated set directly — the same
        surface, each vertex once, ZERO cost (the soup expansion is a
        262k-row gather — fine for an export, wrong inside a per-frame
        consumer or a benchmark window)."""
        f = self._full_canonical_warped()
        if unique:
            return f.vertices, f.mask
        f = self._expand_to_soup(f)
        return f.vertices, f.mask

    def mesh(self):
        """Last extracted triangle soup (verts buffer, count).

        With `corr_unique_edges` the per-frame program extracts unique
        vertices only; the soup is produced here on demand by running
        marching cubes on the retained live volume — same output as the
        always-emitting path, off the per-frame critical path."""
        if self.mesh_vertices is None:
            dp = self.dynfu_params
            v, n, _ = marching_cubes(
                self.vol, self.tsdf_config, max_voxels=dp.max_mc_voxels,
                max_verts=dp.max_vertices,
                convention="corner" if self.mode == "fusion" else "center",
                col_budget=dp.mc_col_budget)
            self.mesh_vertices = (v, n)
        return self.mesh_vertices
