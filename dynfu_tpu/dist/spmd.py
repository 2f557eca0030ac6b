"""Multi-chip scaling: block-partitioned TSDF + sharded solve over a Mesh.

This layer has NO counterpart in the reference — dynfu is a single-process,
single-GPU program (SURVEY §2: no DP/TP/PP, no NCCL/MPI; the only transport
is cudaMemcpy). It is the capability this build adds: scale DynamicFusion
across several devices by

* partitioning the TSDF volume along its x axis (NamedSharding P('x')) — the
  volumetric analog of tensor parallelism: integrate touches only local
  blocks, raycast contracts across blocks (XLA inserts the psum),
* sharding the vertex set across chips (data parallelism for the dense
  solve): each chip assembles its partial Gauss-Newton normal equations
  A_p = W_p^T S_p W_p, and GSPMD reduces them with one psum — the
  Schur-style reduction called for by the design brief,
* replicating the (small) node state on every chip.

Everything is expressed with jax.sharding annotations on ONE jit — no
hand-written collectives; XLA chooses all_reduce/all_gather placement. `sharded_fusion_step` is the full per-frame step (preprocess ->
integrate -> raycast -> warp -> GN solve -> node state update), jittable
over any 1-D device mesh, exercised on a virtual CPU mesh in tests and by
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynfu_tpu.core.camera import Intr
from dynfu_tpu.ops import imgproc
from dynfu_tpu.solver import gn
from dynfu_tpu.volume import tsdf as tv
from dynfu_tpu.warp import field as wfield


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the first n devices, axis name 'x' (the volume axis)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("x",))


def shard_volume(vol: tv.TsdfVolume, mesh: Mesh) -> tv.TsdfVolume:
    """Place the volume block-partitioned along x; pose replicated."""
    blocked = NamedSharding(mesh, P("x", None, None))
    repl = NamedSharding(mesh, P())
    return tv.TsdfVolume(
        tsdf=jax.device_put(vol.tsdf, blocked),
        weight=jax.device_put(vol.weight, blocked),
        pose_r=jax.device_put(vol.pose_r, repl),
        pose_t=jax.device_put(vol.pose_t, repl),
    )


def sharded_fusion_step(
    mesh: Mesh,
    config: tv.TsdfConfig,
    intr: Intr,
    shape: Tuple[int, int],
    solver_kwargs: Optional[dict] = None,
):
    """Build the jitted multi-chip fusion step.

    Returns step(vol, depth_mm, wf, camera_pose) ->
        (vol', wf', warped_pts (H*W, 3), stats)

    The step is the non-parity ("fixed") pipeline shape: the vertex set comes
    from the raycast point map rather than marching cubes, which gives a
    naturally image-sharded vertex distribution — each chip owns the rays it
    will later contribute to the Gauss-Newton reduction for.
    """
    H, W = shape
    solver_kwargs = dict(solver_kwargs or {})
    blocked = NamedSharding(mesh, P("x", None, None))
    repl = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P("x"))  # vertex sets sharded over chips

    def step(vol, depth_mm, wf, camera_pose):
        p_intr = intr
        dists = imgproc.compute_dists(depth_mm, p_intr)
        filtered = imgproc.bilateral_filter(depth_mm)

        vol = tv.clear(vol)
        vol = tv.integrate_separable(vol, dists, camera_pose, p_intr, config)

        pts, nrm = tv.raycast_separable(vol, camera_pose, p_intr, shape, config)
        verts = pts.reshape(-1, 3)
        normals = nrm.reshape(-1, 3)
        vmask = ~jnp.isnan(verts[..., 0])
        verts = jnp.nan_to_num(verts)
        normals = jnp.nan_to_num(normals)
        # shard the vertex set across chips for the distributed GN solve
        verts = jax.lax.with_sharding_constraint(verts, rows)
        vmask = jax.lax.with_sharding_constraint(vmask, rows)

        warped, _ = wfield.warp_points_normals(wf, verts, normals)
        wf2, stats = gn.solve(wf, warped, verts, vert_mask=vmask, **solver_kwargs)
        warped2, _ = wfield.warp_points_normals(wf2, verts, normals)
        warped2 = jnp.where(vmask[:, None], warped2, jnp.nan)
        return vol, wf2, warped2, stats

    vol_sharding = tv.TsdfVolume(tsdf=blocked, weight=blocked, pose_r=repl,
                                 pose_t=repl)
    wf_sharding = jax.tree_util.tree_map(
        lambda _: repl, wfield.WarpField(pos=0, dqs=0, w=0, mask=0, count=0)
    )
    in_shardings = (vol_sharding, repl, wf_sharding, (repl, repl))
    out_shardings = (
        vol_sharding,
        wf_sharding,
        rows,
        jax.tree_util.tree_map(lambda _: repl, gn.SolveStats(0, 0, 0, 0)),
    )
    return jax.jit(step, in_shardings=in_shardings, out_shardings=out_shardings)
