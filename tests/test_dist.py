"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The fake-backend trick the reference never had (its tests required a
physical CUDA GPU): conftest forces 8 XLA host-platform devices, so the
block-partitioned TSDF + sharded-solve step compiles and runs the same SPMD
program that a real pod slice would execute.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynfu_tpu.core import se3
from dynfu_tpu.core.camera import Intr
from dynfu_tpu.dist import make_mesh, shard_volume, sharded_fusion_step
from dynfu_tpu.volume import tsdf as tv
from dynfu_tpu.warp import field as wfield

INTR = Intr(30.0, 30.0, 15.5, 11.5)
H, W = 24, 32


def plane_depth(z_m):
    return np.full((H, W), int(z_m * 1000), np.int32)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_mesh_and_volume_sharding(mesh):
    cfg = tv.TsdfConfig(dims=(32, 32, 32), size=(1.0, 1.0, 1.0), trunc_dist=0.1,
                        z_chunk=8)
    vol = shard_volume(tv.create(cfg), mesh)
    shard_shapes = {s.data.shape for s in vol.tsdf.addressable_shards}
    assert shard_shapes == {(4, 32, 32)}  # 32/8 along x


def test_sharded_integrate_matches_single_device(mesh):
    cfg = tv.TsdfConfig(dims=(32, 32, 32), size=(1.0, 1.0, 1.0), trunc_dist=0.1,
                        z_chunk=8)
    pose = (np.eye(3, dtype=np.float32), np.array([-0.5, -0.5, 0.3], np.float32))
    cam = se3.identity()
    depth = plane_depth(0.7)
    from dynfu_tpu.ops import imgproc

    dists = imgproc.compute_dists(jnp.asarray(depth), INTR)

    ref = tv.integrate_separable(tv.create(cfg, pose), dists, cam, INTR, cfg)
    sharded = shard_volume(tv.create(cfg, pose), mesh)
    got = tv.integrate_separable(sharded, dists, cam, INTR, cfg)
    np.testing.assert_allclose(
        np.asarray(got.tsdf, np.float32), np.asarray(ref.tsdf, np.float32),
        atol=1e-3,
    )
    np.testing.assert_array_equal(np.asarray(got.weight), np.asarray(ref.weight))


def test_full_sharded_fusion_step(mesh):
    """The complete multi-chip step: integrate + raycast + warp + psum'd GN
    solve executes over the 8-device mesh and converges on a translated
    surface."""
    cfg = tv.TsdfConfig(dims=(32, 32, 32), size=(1.0, 1.0, 1.0), trunc_dist=0.08,
                        z_chunk=8, raycast_step_factor=0.3)
    pose = (np.eye(3, dtype=np.float32), np.array([-0.5, -0.5, 0.3], np.float32))
    cam = se3.identity()

    nodes = np.stack(
        np.meshgrid(*[np.linspace(-0.3, 0.3, 3)] * 2, [0.6, 0.8], indexing="ij"),
        -1,
    ).reshape(-1, 3).astype(np.float32)
    wf = wfield.init_warpfield(nodes, weights=1.0)

    step = sharded_fusion_step(mesh, cfg, INTR, (H, W),
                               solver_kwargs=dict(lambda_reg=0.0, linear_iter=64))
    vol = shard_volume(tv.create(cfg, pose), mesh)
    depth = jnp.asarray(plane_depth(0.62))

    vol, wf2, warped, stats = step(vol, depth, wf, cam)
    assert np.isfinite(float(stats.final_cost))
    assert float(stats.final_cost) <= float(stats.initial_cost) + 1e-9

    # volume stays block-partitioned through the step
    shard_shapes = {s.data.shape for s in vol.tsdf.addressable_shards}
    assert shard_shapes == {(4, 32, 32)}

    # depth moved closer by 15 mm -> solve should pull warped verts toward it
    depth2 = jnp.asarray(plane_depth(0.605))
    vol, wf3, warped, stats = step(vol, depth2, wf2, cam)
    w = np.asarray(warped)
    valid = ~np.isnan(w[:, 0])
    assert valid.sum() > 100


def test_sharded_engine_frame_matches(mesh):
    """THE REAL ENGINE under the mesh: `_nonrigid_frame` — marching cubes,
    windowed 1-NN correspondence, full-schedule GN solve, node insertion —
    executes block-partitioned/row-sharded over 8 devices and reproduces
    the single-device frame (same mesh verts, same solved node state). The
    MC/raycast ±1-voxel stencils across block faces are the halo exchanges,
    inserted by the SPMD partitioner from the shifted-slice reads."""

    from dynfu_tpu.dist.engine_spmd import (place_engine_state,
                                            sharded_engine_frame)
    from dynfu_tpu.engine.dynfusion import DynFusion, _nonrigid_frame
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64,
    )
    engine = DynFusion(params)
    d0 = sphere_depth((0.0, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    d1 = sphere_depth((0.01, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    engine(d0)  # establish canonical + warpfield

    dp, cfg = engine.dynfu_params, engine.tsdf_config
    c, pose = engine.canonical, engine.poses[-1]
    args = (engine.vol, engine.warpfield, c.vertices, c.normals, c.mask,
            jnp.asarray(d1, jnp.int32), pose)

    ref = _nonrigid_frame(*args, dp=dp, intr=intr, config=cfg,
                          strict_parity=True, integrate_mode="separable")

    step = sharded_engine_frame(mesh, dp, intr, cfg, strict_parity=True)
    got = step(*place_engine_state(mesh, *args))

    # volume stays block-partitioned through the frame
    shard_shapes = {s.data.shape for s in got[0].tsdf.addressable_shards}
    assert shard_shapes == {(8, 64, 64)}, shard_shapes

    # identical frame outputs: mesh vertices, vertex count, solved nodes
    assert int(got[8]) == int(ref[8]) > 0  # n_verts
    np.testing.assert_allclose(np.asarray(got[7]), np.asarray(ref[7]),
                               atol=1e-6)  # MC triangle soup
    np.testing.assert_allclose(np.asarray(got[1].dqs),
                               np.asarray(ref[1].dqs), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got[1].mask),
                                  np.asarray(ref[1].mask))
    np.testing.assert_allclose(
        np.asarray(got[0].tsdf, np.float32),
        np.asarray(ref[0].tsdf, np.float32), atol=1e-3)
    assert int(got[9].mc_dropped) == int(ref[9].mc_dropped) == 0


def test_sharded_engine_frame_unique_edges_matches(mesh):
    """The unique-edge hot path (DynFuParams.corr_unique_edges — the
    512-cube default since r4) under the mesh: the bit-packed edge
    extraction + compaction must partition through GSPMD and reproduce the
    single-device frame."""
    import dataclasses

    from dynfu_tpu.dist.engine_spmd import (place_engine_state,
                                            sharded_engine_frame)
    from dynfu_tpu.engine.dynfusion import DynFusion, _nonrigid_frame
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64,
        corr_unique_edges=True, max_edge_verts=1 << 12,
    )
    engine = DynFusion(params)
    d0 = sphere_depth((0.0, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    d1 = sphere_depth((0.01, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    engine(d0)
    dp, cfg = engine.dynfu_params, engine.tsdf_config
    c, pose = engine.canonical, engine.poses[-1]
    args = (engine.vol, engine.warpfield, c.vertices, c.normals, c.mask,
            jnp.asarray(d1, jnp.int32), pose)

    ref = _nonrigid_frame(*args, dp=dp, intr=intr, config=cfg,
                          strict_parity=True, integrate_mode="separable")
    step = sharded_engine_frame(mesh, dp, intr, cfg, strict_parity=True)
    got = step(*place_engine_state(mesh, *args))

    assert int(got[8]) == int(ref[8]) > 0  # n unique edge verts
    np.testing.assert_allclose(np.asarray(got[7]), np.asarray(ref[7]),
                               atol=1e-6)  # edge vertex buffer
    np.testing.assert_allclose(np.asarray(got[1].dqs),
                               np.asarray(ref[1].dqs), atol=1e-5)
    assert int(got[9].mc_dropped) == int(ref[9].mc_dropped) == 0


def test_sharded_engine_frame_foreground_tracking_matches(mesh):
    """Foreground tracking (DynFuParams.fg_aabb, round 5) under the mesh:
    the in-program rank_select compaction of the tracked live set must
    partition through GSPMD and reproduce the single-device frame."""
    from dynfu_tpu.dist.engine_spmd import (place_engine_state,
                                            sharded_engine_frame)
    from dynfu_tpu.engine.dynfusion import DynFusion, _nonrigid_frame
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64,
        fg_aabb=((0.0, 0.0, 0.0), (3.0, 3.0, 1.2)),
        max_fg_verts=1 << 12,
    )
    engine = DynFusion(params)
    d0 = sphere_depth((0.0, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    d1 = sphere_depth((0.01, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    engine(d0)
    dp, cfg = engine.dynfu_params, engine.tsdf_config
    c, pose = engine._fg_canonical, engine.poses[-1]
    assert c is not None and int(jnp.sum(c.mask)) > 100
    args = (engine.vol, engine.warpfield, c.vertices, c.normals, c.mask,
            jnp.asarray(d1, jnp.int32), pose)

    ref = _nonrigid_frame(*args, dp=dp, intr=intr, config=cfg,
                          strict_parity=True, integrate_mode="separable")
    step = sharded_engine_frame(mesh, dp, intr, cfg, strict_parity=True)
    got = step(*place_engine_state(mesh, *args))

    # live tracked set (post-compaction) identical
    np.testing.assert_allclose(np.asarray(got[4]), np.asarray(ref[4]),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[6]), np.asarray(ref[6]))
    np.testing.assert_allclose(np.asarray(got[1].dqs),
                               np.asarray(ref[1].dqs), atol=1e-5)
    assert int(got[9].corr_dropped) == int(ref[9].corr_dropped)


def test_sharded_fusion_frame_runs(mesh):
    """The persistent-canonical fusion frame (projective correspondence +
    warped-back band integration) also executes under the mesh and matches
    the single-device program."""
    from dynfu_tpu.dist.engine_spmd import (place_engine_state,
                                            sharded_fusion_frame)
    from dynfu_tpu.engine.dynfusion import DynFusion, _fusion_frame
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64,
        fusion_max_active=1 << 15,
    )
    engine = DynFusion(params, mode="fusion")
    d0 = sphere_depth((0.0, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    d1 = sphere_depth((0.008, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    engine(d0)

    dp, cfg = engine.dynfu_params, engine.tsdf_config
    c, pose = engine.canonical, engine.poses[-1]
    args = (engine.vol, engine.warpfield, c.vertices, c.normals, c.mask,
            jnp.asarray(d1, jnp.int32), pose)

    ref = _fusion_frame(*args, dp=dp, intr=intr, config=cfg)
    step = sharded_fusion_frame(mesh, dp, intr, cfg)
    got = step(*place_engine_state(mesh, *args))

    assert int(got[5]) == int(ref[5]) > 0  # n_verts
    np.testing.assert_allclose(np.asarray(got[1].dqs),
                               np.asarray(ref[1].dqs), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(got[0].tsdf, np.float32),
        np.asarray(ref[0].tsdf, np.float32), atol=1e-3)
    assert int(got[8].band.n_captured) == int(ref[8].band.n_captured)


def test_sharded_matches_unsharded_solve(mesh):
    """The psum-reduced normal equations give the same solution as one chip."""
    from dynfu_tpu.solver import gn

    rng = np.random.RandomState(3)
    verts = jnp.asarray(rng.rand(256, 3).astype(np.float32))
    live = verts + jnp.asarray([0.01, 0.0, -0.005])
    nodes = rng.rand(16, 3).astype(np.float32)
    wf = wfield.init_warpfield(nodes, weights=2.0)

    a, _ = gn.solve(wf, verts, live, lambda_reg=0.0)

    rows = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x"))
    verts_s = jax.device_put(verts, rows)
    live_s = jax.device_put(live, rows)
    b, _ = gn.solve(wf, verts_s, live_s, lambda_reg=0.0)

    np.testing.assert_allclose(
        np.asarray(a.dqs), np.asarray(b.dqs), atol=1e-5
    )


def test_sharded_fusion_frame_with_se3_rotations(mesh):
    """The fusion frame with solver_rotations=True — SE(3) solve + DLB
    warp — also executes under the mesh and matches the single-device
    program (the 6D normal-equation assembly reduces its vertex-sharded
    monomial Grams with the same psum pattern as the translation solve)."""
    import dataclasses

    from dynfu_tpu.dist.engine_spmd import (place_engine_state,
                                            sharded_fusion_frame)
    from dynfu_tpu.engine.dynfusion import DynFusion, _fusion_frame
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64,
        fusion_max_active=1 << 15,
        solver_rotations=True, se3_relinearize=2,
    )
    engine = DynFusion(params, mode="fusion")
    d0 = sphere_depth((0.0, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    d1 = sphere_depth((0.008, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    engine(d0)

    dp, cfg = engine.dynfu_params, engine.tsdf_config
    c, pose = engine.canonical, engine.poses[-1]
    args = (engine.vol, engine.warpfield, c.vertices, c.normals, c.mask,
            jnp.asarray(d1, jnp.int32), pose)

    ref = _fusion_frame(*args, dp=dp, intr=intr, config=cfg)
    step = sharded_fusion_frame(mesh, dp, intr, cfg)
    got = step(*place_engine_state(mesh, *args))

    assert int(got[5]) == int(ref[5]) > 0  # n_verts
    np.testing.assert_allclose(np.asarray(got[1].dqs),
                               np.asarray(ref[1].dqs), atol=1e-5)


def test_sharded_driver_chains_frames(mesh):
    """ShardedDynFusion drives MULTIPLE frames end-to-end over the mesh
    (frame-0 bootstrap + sharded chaining, state device-resident) and
    matches the single-device engine's warped cloud and node state."""
    from dynfu_tpu.dist.driver import ShardedDynFusion
    from dynfu_tpu.engine.dynfusion import DynFusion
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64,
    )
    frames = [sphere_depth((0.004 * i, 0.0, 1.5), 0.5, rows, cols,
                           intr.fx, intr.fy, intr.cx, intr.cy)
              for i in range(4)]

    ref = DynFusion(params)
    drv = ShardedDynFusion(params, mode="parity", mesh=mesh)
    for d in frames:
        ref(d)
        drv(d)

    # state stayed sharded through the chain
    shard_shapes = {s.data.shape for s in drv.engine.vol.tsdf.addressable_shards}
    assert shard_shapes == {(8, 64, 64)}, shard_shapes

    wv_r, wm_r = ref.warped_cloud()
    wv_d, wm_d = drv.warped_cloud()
    np.testing.assert_array_equal(np.asarray(wm_d), np.asarray(wm_r))
    np.testing.assert_allclose(np.asarray(wv_d), np.asarray(wv_r),
                               atol=1e-5, rtol=0)
    assert int(drv.engine.warpfield.count) == int(ref.warpfield.count)
    np.testing.assert_allclose(np.asarray(drv.engine.warpfield.dqs),
                               np.asarray(ref.warpfield.dqs),
                               atol=1e-5, rtol=0)


def test_sharded_driver_fusion_mode(mesh):
    """Fusion-mode driver: persistent canonical volume chained under the
    mesh matches single-device."""
    from dynfu_tpu.dist.driver import ShardedDynFusion
    from dynfu_tpu.engine.dynfusion import DynFusion
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64, 64, 64)),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64, fusion_max_active=1 << 15,
    )
    frames = [sphere_depth((0.004 * i, 0.0, 1.5), 0.5, rows, cols,
                           intr.fx, intr.fy, intr.cx, intr.cy)
              for i in range(3)]

    ref = DynFusion(params, mode="fusion")
    drv = ShardedDynFusion(params, mode="fusion", mesh=mesh)
    for d in frames:
        ref(d)
        drv(d)

    wv_r, wm_r = ref.warped_cloud()
    wv_d, wm_d = drv.warped_cloud()
    np.testing.assert_array_equal(np.asarray(wm_d), np.asarray(wm_r))
    np.testing.assert_allclose(np.asarray(wv_d), np.asarray(wv_r),
                               atol=1e-5, rtol=0)
