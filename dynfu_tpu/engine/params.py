"""Configuration dataclasses.

Defaults mirror the reference verbatim:
* KinFuParams::default_params()  — src/kfusion/kinfu.cpp:10-44
* DynFuParams::defaultParams()   — src/dynfu/dyn_fusion.cpp:6-31
* non-rigid solver schedule      — src/dynfu/dyn_fusion.cpp:183-189
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from dynfu_tpu.core.camera import Intr


def _deg2rad(a: float) -> float:
    return a * 0.017453293


@dataclasses.dataclass(frozen=True)
class KinFuParams:
    # image
    cols: int = 640
    rows: int = 480
    intr: Intr = Intr(525.0, 525.0, 640 / 2 - 0.5, 480 / 2 - 0.5)

    # volume
    volume_dims: Tuple[int, int, int] = (512, 512, 512)
    volume_size: Tuple[float, float, float] = (3.0, 3.0, 3.0)  # meters
    # volume pose: translate so the volume is centered in x/y, 0.5 m in front
    volume_pose_t: Tuple[float, float, float] = (-1.5, -1.5, 0.5)

    # bilateral filter
    bilateral_sigma_depth: float = 0.04  # meters
    bilateral_sigma_spatial: float = 4.5  # pixels
    bilateral_kernel_size: int = 7  # pixels

    # icp
    icp_truncate_depth_dist: float = 0.0  # meters, disabled
    icp_dist_thres: float = 0.1  # meters
    icp_angle_thres: float = _deg2rad(30.0)
    icp_iter_num: Tuple[int, ...] = (10, 5, 4, 0)
    icp_assoc: str = "stencil"  # "stencil": bounded-window select
    # association (rigid/icp.py _fetch_stencil: (2R+1)^2 shifted selects
    # instead of element gathers); "gather": the reference's exact
    # texture-fetch semantics
    icp_stencil_radii: Tuple[int, ...] = (2, 3, 4, 6)  # per level,
    # coarse wider (they absorb the raw inter-frame motion; flows beyond
    # the radius drop out like out-of-image projections)

    # tsdf
    tsdf_min_camera_movement: float = 0.0  # meters, disabled
    tsdf_trunc_dist: float = 0.04  # meters
    tsdf_max_weight: int = 64  # frames

    raycast_step_factor: float = 0.75  # in voxel sizes
    gradient_delta_factor: float = 0.5  # in voxel sizes

    light_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # integrate/raycast dispatch under camera rotation: 'auto' uses the
    # homography fast paths below MAX_HOMOGRAPHY_TILT (fast, ~one-pixel
    # resampling noise); 'exact' always uses the per-voxel/per-ray gather
    # formulations (slow, quantization-free)
    raycast_mode: str = "auto"

    # run frame k>=1 as ONE fused XLA program (engine/kinfu.py
    # _rigid_frame: device-side pose composition + overlapped pose
    # readback) when the stencil/auto dispatch conditions hold; False
    # forces the per-stage dispatch path (same formulations, host pose)
    fused_frame: bool = True

    @staticmethod
    def default_params() -> "KinFuParams":
        return KinFuParams()

    def with_volume_dims(self, d: int) -> "KinFuParams":
        return dataclasses.replace(self, volume_dims=(d, d, d))


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Non-rigid GN/LM solver schedule (CombinedSolverParameters analog).

    The reference's Opt harness with earlyOut=True effectively runs ONE outer
    iteration: robust weights from the initial warp state, one full nonlinear
    solve, then composes translations into the nodes
    (Opt CombinedSolverBase::singleSolve + opt_solver.cpp:131-140,270-285).
    """

    num_iter: int = 24
    nonlinear_iter: int = 16
    linear_iter: int = 256
    early_out: bool = True
    # LM damping used by our solver; Opt's GN has none, LM adapts it.
    lm_lambda_init: float = 1e-8


@dataclasses.dataclass(frozen=True)
class DynFuParams:
    kinfu: KinFuParams = dataclasses.field(
        default_factory=lambda: KinFuParams().with_volume_dims(128)
    )

    tukey_offset: float = 4.652
    lambda_reg: float = 200.0  # regularisation weight λ
    psi_data: float = 0.01  # tukey biweight cutoff
    psi_reg: float = 1e-4  # huber weight cutoff
    L: int = 4  # regularisation hierarchy levels (declared, unused upstream)
    beta: float = 4.0  # reg-graph update parameter (declared, unused upstream)
    epsilon: float = 0.1  # decimation density ε

    knn: int = 8  # warp_field.hpp:27
    node_sample_step: int = 128  # dyn_fusion.cpp:151
    new_node_dg_w_factor: float = 2.0  # dg_w = 2ε for inserted nodes (warp_field.cpp:79)
    init_node_dg_w_factor: float = 3.0  # dg_w = 3ε at bootstrap (dyn_fusion.cpp:158)
    node_voxel_leaf: float = 0.05  # VoxelGrid leaf for node dedup (warp_field.cpp:70)

    solver: SolverParams = dataclasses.field(default_factory=SolverParams)

    # static capacities (JAX needs fixed shapes; reference used std::vector).
    # Defaults are sized for the default 128-cube volume, whose isosurface
    # emits ~10-30k soup vertices; capacities are PAID FOR in every
    # downstream op, so scale them with the volume (see utils/benchmarks.py)
    max_nodes: int = 1024
    max_vertices: int = 1 << 16
    max_triangles: int = 2 << 20  # reference preallocates 6M points (marching_cubes.cpp:23)
    max_mc_voxels: int = 1 << 14  # occupied-voxel compaction capacity
    mc_col_budget: int = 0  # per-z-column MC cell budget (0 = auto from the
    # truncation band; raise for scenes with z-parallel planes — floors —
    # whose columns are fully occupied; FrameStats.mc_dropped is the signal)
    max_new_nodes: int = 256  # node insertions per warpfield update
    corr_escalate: int = 16384  # wide-window second-pass capacity for
    # correspondence queries whose x-window exactness certificate fails:
    # up to this many failures are re-swept with a 4x window (moving-edge
    # queries whose true NN sits a few cm away — farther than the base
    # window's x-margin — certify there)
    corr_block: int = 1024  # correspondence query tile, and the granularity
    # at which its point windows are placed (points)
    corr_window_blocks: int = 4  # base-sweep window width in corr_block
    # blocks: tiles of 1024 queries place their 4096-point windows at
    # 1024-point granularity (with one 4096-point block the 512-cube sphere
    # run failed ~15k certificates and dropped correspondences,
    # scripts/knn_probe.py --part window). The sweep costs ~Q*W, so narrower
    # windows are cheaper; queries whose certificate fails in the narrow window
    # (pole-cap x-slabs) escalate, stragglers hit the exact brute tier,
    # and only failures beyond BOTH capacities drop (counted, asserted
    # zero in the benchmarks). With the ~6x-deduplicated canonical a
    # 4096-point window spans ~24 voxels of x at the 512-cube workload —
    # zero drops there.
    corr_rescue: int = 4096  # exact brute-force third-tier capacity for
    # queries still failing after escalation (dense x-slab geometries,
    # e.g. sphere pole caps, defeat any single x-window); rescued queries
    # get their exact 1-NN, the remainder counts in FrameStats.corr_dropped
    corr_unique_edges: bool = False  # parity-mode live vertices from the
    # zero-crossing edge extraction (mesh/edges.py) instead of the MC
    # triangle soup: the unique vertex SET (~5x smaller at 512-cube) feeds
    # correspondence + solve, and triangle emission moves off the per-frame
    # critical path (DynFusion.mesh() extracts the soup on demand).
    # Deviation: the solve sees each unique vertex once instead of
    # soup-multiplicity times (see mesh/edges.py docstring). Default on
    # for >=384-cube caps, off at the reference's own 128-cube config.
    # foreground tracking (VolumeDeform's own approach to full-scene
    # captures: restrict the TRACKED set to the dynamic foreground; the
    # static background — walls, floors — stays in the volume and the
    # exported mesh but is excluded from warp/correspondence/solve, whose
    # costs scale with the tracked-set CAPACITY). fg_aabb is a volume-
    # frame box ((x0,y0,z0),(x1,y1,z1)); vertices outside it are
    # background. The analog of VolumeDeform's 2D segmentation masks for
    # scenes where the dynamic region is spatially bounded. Both must be
    # set; tracked vertices beyond max_fg_verts count into corr_dropped.
    fg_aabb: tuple | None = None
    max_fg_verts: int = 0
    max_edge_verts: int = 0  # unique-vertex capacity (0 = max_vertices // 2)
    edge_col_budget: int = 0  # per-z-column budget for the edge extraction
    # (0 = fall back to mc_col_budget, then the truncation-band auto
    # estimate). Edge columns hold ~2 bits per surface CROSSING — far
    # fewer than the band-depth estimate (28 at 512-cube) the fallback
    # assumes; the bench scene measures max 3 bits/column, so the preset
    # sets 8 and saves 20 extraction rounds. Wall/floor scenes have
    # z-parallel-surface columns with up to Z set bits (the umbrella's
    # walls) — such workloads must RAISE this; n_dropped is the signal.

    # fusion mode (mode="fusion": persistent canonical volume with
    # warped-back integration — the fusion model of Newcombe et al. §3.3
    # that the reference's clear+reintegrate workaround stands in for,
    # dyn_fusion.cpp:107-116)
    fusion_corr_dist: float = 0.10  # projective-association gate (meters)
    fusion_max_active: int = 1 << 19  # active-band compaction capacity
    fusion_col_budget: int = 0  # per-z-column band capture budget for the
    # warped-back integration (0 = fall back to mc_col_budget, then to the
    # truncation-band auto estimate). The auto estimate covers two
    # perpendicular surface crossings; sphere-TANGENT z-columns run a chord
    # through the band (~60 cells at 512-cube) and the ACCUMULATED warp
    # thickens it further, so long fusion sequences silently truncate the
    # capture (n_captured < n_band) and the canonical decays where it is
    # updated least — measured: SE(3) 512-cube warped error drifts
    # 0.55 -> 1.23 mm over frames 8-15 exactly as the shortfall grows.
    # caps_for_volume(fusion=True) sizes this to the workload.
    fusion_dilate: int = 2  # band growth margin (voxels)
    fusion_min_cos: float = 0.25  # reject grazing observations (view-ray
    # vs live-normal cosine) — projective-SDF junk otherwise accumulates
    # at silhouette rims of the persistent volume
    solver_rotations: bool = False  # solve per-node SE(3) twists
    # (solver/se3.py) instead of translations-only, and warp through the
    # proper DLB blend — the capability the reference declared but never
    # wired (energy.t:30,78). fusion/fixed modes only; parity keeps the
    # reference's translations-only solve.
    se3_relinearize: int = 3  # Gauss-Newton relinearizations per frame
    se3_similarity_reg: bool = False  # marginalize a global uniform-scale
    # mode out of the SE(3) reg (solver/se3.py _assemble_reg): for scene
    # classes whose dominant deformation is expansion/contraction
    # (breathing objects), the ARAP-style reg otherwise prices the
    # irreducible inter-node disagreement ~ scale_rate x node_spacing of
    # any rigid-per-node approximation. Opt-in: a modeling choice like
    # psi/lambda, declared per workload
    fusion_warmup_frames: int = 0  # fusion-mode frames after bootstrap
    # whose observations integrate WITHOUT a solve (identity updates).
    # Accuracy knob for sequences that START at rest: the first frames'
    # residuals are frame-0 discretization noise, and warping the
    # canonical toward it bakes it in permanently where plain integration
    # would average it away (64-cube study: warmup=2 takes the static
    # canonical error 2.32 -> 1.98 mm; scenes moving from frame 0 lose a
    # little motion tracking during the warmup, so default off)
    se3_trans_prior: float = 0.0  # translation step damping scaled by the
    # MEAN node data strength (se3.solve trans_prior): dominates weak-data
    # rim nodes whose noise fits leak past the min_update gate, barely
    # touches well-observed nodes
    se3_rot_prior: float = 0.03  # per-step rotation damping (se3.solve
    # rot_prior): prices a step rotation theta like a translation
    # theta * dg_w scaled by the node's own data strength. Pure step
    # damping — true rotations converge through it across
    # relinearizations, noise-spin (unobservable on smooth geometry)
    # stays O(info/prior) small
    fusion_camera_tracking: bool = False  # fusion mode: estimate the
    # camera pose per frame by frame-to-frame projective ICP on the depth
    # point/normal pyramids (stencil association, gather rescue — the
    # rigid machinery of engine/kinfu.py) instead of pinning it to
    # identity. Off by default: static-camera sequences keep the exact
    # static behavior and skip the per-frame pose readback; turn on for
    # moving-camera captures. Deforming regions are rejected by the ICP
    # distance/angle gates like any outlier; the non-rigid solve absorbs
    # the residual after the rigid motion is removed.
    fusion_min_update_vox: float = 0.1  # per-node update soft-threshold in
    # voxel units (gn.solve min_update): static scenes stay EXACTLY static
    # instead of baking per-frame solve jitter into the canonical volume

    @staticmethod
    def default_params() -> "DynFuParams":
        return DynFuParams()

    @staticmethod
    def caps_for_volume(volume_dims: int, fusion: bool = False) -> dict:
        """Documented capacity preset for a given cubic volume resolution.

        JAX programs have static shapes, so every buffer capacity is a real
        workload parameter: the isosurface vertex count grows ~quadratically
        with volume resolution, and oversizing is paid for in every
        downstream op. These presets size the buffers to the 640x480
        Kinect-class workloads this engine targets.

        DELIBERATE parity deviation at >=384: ``node_sample_step=256``
        (the reference uses 128, dyn_fusion.cpp:151). At 512-cube the
        surface emits ~225k soup vertices; stride 128 wants ~1758 nodes —
        more than the 1024-node budget — and truncating the x-major vertex
        order leaves the high-x surface without nearby nodes, which the
        SE(3) solve turns into unsupported long levers and diverges.
        Stride 256 keeps the whole surface covered inside the node budget.
        Pass ``node_sample_step=128`` explicitly to reproduce the
        reference's sampling at your own capacity risk.
        """
        if volume_dims >= 384:
            # 512-cube bench scene occupies ~37k cells / ~225k soup verts;
            # the 49152 cell cap leaves 1.33x headroom (MC pass-2 cost
            # scales with the cap; mc_dropped==0 is asserted by the
            # benchmarks). FUSION mode's persistent canonical volume
            # accumulates surface across frames (never cleared) and needs
            # the larger cell budget — its 512-cube run overflowed 49152.
            #
            # FUSION node_sample_step scales with the soup size so node
            # DENSITY is resolution-independent (~eps spacing): the soup
            # vertex count grows ~quadratically with resolution, and an
            # over-dense node set (512-cube at stride 256 = 878 nodes,
            # ~60 mm spacing under dg_w = 0.3) makes the 8-NN data weights
            # near-equal — per-node cancellation modes go data-null, the
            # 1/D reg cannot hold them, and the SE(3) solve EXPLODES
            # (measured: warped error 8 m by frame 5; at stride 512 / 439
            # nodes the same run is stable at 0.5 mm).
            step = 512 if (fusion and volume_dims >= 448) else 256
            caps = dict(max_vertices=1 << 18,
                        max_mc_voxels=(1 << 16) if fusion else 49152,
                        max_nodes=1024, max_new_nodes=512,
                        node_sample_step=step)
            if not fusion:
                # parity-mode hot path consumes unique vertices (measured
                # 34,626 at the 512-cube bench scene vs 224,958 soup,
                # mesh/edges.py) — 49152 = 1.4x headroom, the same
                # convention as the MC cell cap; overflow surfaces in
                # mc_dropped (asserted zero by the benchmarks)
                caps["corr_unique_edges"] = True
                caps["max_edge_verts"] = 49152
                # correspondence failure tiers sized to the UNIQUE
                # workload (the 16384/4096 defaults were sized for the
                # 262k soup; the 39k unique query set certifies with the
                # same margins at the ≥192 preset's tier sizes)
                caps["corr_escalate"] = 8192
                caps["corr_rescue"] = 2048
            # edge extraction rounds: see edge_col_budget — measured max
            # 3 bits/column at the bench workload vs the 28-round band
            # fallback
            caps["edge_col_budget"] = 8
            if fusion:
                # every capacity below is paid in every op that touches
                # the buffer, so each is sized to its MEASURED stable
                # workload + headroom (the overflow counters are the
                # undersizing signal). Stable-run figures of a 16-frame
                # 512-cube fusion run:
                # band 384k->395k, nodes 439 + ~0 inserts/frame,
                # canonical 39k unique verts.
                #
                # node capacity: 512-stride bootstrap emits <= 512 nodes
                # (262k soup cap / 512); 640 leaves 128 insertion slots
                # and the SE(3) normal system is (6D)^2 — capacity
                # (1024 -> 640) cuts every PCG matvec 2.6x
                caps["max_nodes"] = 640
                caps["max_new_nodes"] = 256
                # active band: 395k stable through 16 frames (the old
                # 786k figure tracked a DIVERGING run's garbage sweep);
                # 1 << 19 = 1.33x headroom, integrate_warped scales with it
                caps["fusion_max_active"] = 1 << 19
                # sphere-TANGENT z-columns chord through the band (~60
                # cells) and the accumulated warp thickens it: the
                # truncation-band auto estimate silently truncated capture
                # from frame 5 (r4 diag; canonical decays where updated
                # least). 128 holds captured == n_band through 16 frames.
                caps["fusion_col_budget"] = 128
                # fusion consumes the re-extracted canonical at
                # unique-vertex granularity too (gradient normals on the
                # 248k soup dominated the frame). The
                # persistent canonical is much larger than the parity
                # scene's 35k unique verts — the accumulated band's soup
                # was SILENTLY overflowing the old 262k soup cap (measured
                # n_verts == cap-1; soup-vertex overflow was not counted
                # in mc_dropped) — the edge path's n_dropped counter now
                # surfaces it, and the capacity covers it
                caps["corr_unique_edges"] = True
                # 39k unique verts stable through 16 frames; 64k = 1.67x
                # headroom (normals/warp/correspondence/solve rows all
                # scale with this buffer)
                caps["max_edge_verts"] = 1 << 16
                # rotation-noise damping at the 512-cube node density: with
                # the default 0.03 the per-frame spin noise of weak-data rim
                # nodes accumulates (warped error drifts 0.49 -> 10 mm over
                # 15 frames; un-gated it CASCADES — nodes spin ~150°, verts
                # fly, insertion follows them, see solver/se3.py
                # max_update). At 0.3 the same
                # run holds 0.37-0.42 mm warped / 1.5 mm canonical through
                # 16 frames — the ≤1 mm BASELINE bar config.
                caps["se3_rot_prior"] = 0.3
                # relinearization count vs accuracy on the 12-frame
                # 512-cube fusion bench: 2 steps 0.441 mm warped, 1 step
                # 0.459 mm — both far inside the ≤1 mm bar, and each step
                # is a full Gram + assembly + PCG pass, so the preset
                # takes 1
                caps["se3_relinearize"] = 1
            return caps
        # correspondence failure-tier capacities also scale down with the
        # surface vertex count: the tiers run at full static capacity every
        # frame whether or not any query failed, and smaller volumes
        # have proportionally fewer certificate failures. corr_dropped==0
        # (asserted by the benchmarks) is the undersizing signal.
        if volume_dims >= 192:
            return dict(max_vertices=1 << 16, max_mc_voxels=1 << 14,
                        max_nodes=512, max_new_nodes=256,
                        corr_escalate=8192, corr_rescue=2048)
        return dict(max_vertices=1 << 15, max_mc_voxels=1 << 13,
                    max_nodes=256, max_new_nodes=128,
                    corr_escalate=4096, corr_rescue=1024)

    @property
    def w_reg(self) -> float:
        raise AttributeError("w_reg depends on the active node count; use solver.gn.w_reg(D, knn, lambda_reg)")


def w_reg(lambda_reg: float, D: int, knn: int) -> float:
    """Per-term regularisation weight sqrt(λ / (D·KNN)) — opt_solver.cpp:30."""
    return math.sqrt(lambda_reg / (D * knn))
