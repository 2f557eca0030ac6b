"""Dataset application driver — the `dynfu run` loop.

Analog of DynFuApp (src/apps/demo.cpp): loads sorted depth PNGs, drives the
DynFusion engine frame by frame under the fps sampler, and writes per-frame
artifacts into <dataset>/out:
  * pcl_canonical_to_live<i>.pcd — warped canonical cloud (demo.cpp:21-31)
  * <i>_tsdf_mesh.vtk / .ply     — live TSDF mesh (demo.cpp:33-37)
  * render<i>.png                — offline Phong render when --export-viz is
    set (replaces the reference's interactive OpenCV Viz window, which it
    refuses to open over SSH anyway, demo.cpp:179-185).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from dynfu_tpu.engine.dynfusion import DynFusion
from dynfu_tpu.engine.params import DynFuParams
from dynfu_tpu.io import meshio
from dynfu_tpu.io.native_loader import DepthLoader
from dynfu_tpu.utils.timers import SampledScopeTime, sync


def run_dataset(
    dataset: str,
    out_dir: Optional[str] = None,
    max_frames: int = 0,
    volume_dims: int = 128,
    export_viz: bool = False,
    params: Optional[DynFuParams] = None,
    save_every: int = 1,
    checkpoint_every: int = 0,
    resume: Optional[str] = None,
    rigid: bool = False,
    mode: Optional[str] = None,
    devices: int = 0,
    fg_aabb=None,
    max_fg_verts: int = 0,
) -> int:
    if rigid:
        return run_dataset_rigid(dataset, out_dir=out_dir, max_frames=max_frames,
                                 volume_dims=volume_dims, export_viz=export_viz,
                                 save_every=save_every)
    depths, colors = meshio.list_dataset(dataset)
    if max_frames:
        depths = depths[:max_frames]
        colors = colors[:max_frames]
    if not depths:
        print(f"no depth frames found under {dataset}/depth")
        return 1

    out_dir = out_dir or os.path.join(dataset, "out")
    os.makedirs(out_dir, exist_ok=True)

    if params is None:
        # buffer capacities scale with the volume (static shapes): the
        # 128-cube defaults would silently truncate a 512-cube surface
        params = DynFuParams(**DynFuParams.caps_for_volume(
            volume_dims, fusion=(mode == "fusion")))
        first = meshio.load_depth_png(depths[0])
        h, w = first.shape
        kf = dataclasses.replace(
            params.kinfu,
            rows=h,
            cols=w,
            volume_dims=(volume_dims, volume_dims, volume_dims),
        )
        params = dataclasses.replace(params, kinfu=kf)
    if fg_aabb is not None:
        params = dataclasses.replace(params, fg_aabb=fg_aabb,
                                     max_fg_verts=max_fg_verts)

    if devices and devices > 1:
        from dynfu_tpu.dist.driver import ShardedDynFusion

        engine = ShardedDynFusion(params, mode=mode or "parity",
                                  n_devices=devices)
        ckpt_target = engine.engine
    else:
        engine = DynFusion(params, mode=mode)
        ckpt_target = engine
    start = 0
    if resume:
        from dynfu_tpu.utils.checkpoint import load_checkpoint

        load_checkpoint(ckpt_target, resume)
        start = ckpt_target.frame_counter
        if devices and devices > 1 and start > 0:
            engine._place()
            engine._build_steps()
        print(f"resumed from {resume} at frame {start}")
    sampler = SampledScopeTime()
    loader = DepthLoader(depths)
    print(f"depth decoder: {loader.decoder}")

    for i in range(start, len(loader)):
        depth = loader[i]
        # color frames ride the reference's operator()(Depth, Image)
        # surface (demo.cpp:46-55); the engines accept and ignore them,
        # exactly as the reference's math does
        image = (meshio.load_color_png(colors[i])
                 if i < len(colors) else None)
        with sampler:
            has_surface = engine(depth, image)
            wv, wm = engine.warped_cloud()
            sync(wv)
        print(f"frame {i}: {'ok' if has_surface else 'bootstrap'}")

        if i % save_every == 0:
            cloud = np.asarray(wv)[np.asarray(wm)]
            meshio.save_pcd(
                os.path.join(out_dir, f"pcl_canonical_to_live{i}.pcd"), cloud
            )
            verts, n = engine.mesh()
            soup = np.asarray(verts)[: int(n)]
            meshio.save_vtk(os.path.join(out_dir, f"{i}_tsdf_mesh.vtk"), soup)
            meshio.save_ply(os.path.join(out_dir, f"{i}_tsdf_mesh.ply"), soup)
            if export_viz:
                img = np.asarray(engine.render(0))
                meshio.save_image_png(os.path.join(out_dir, f"render{i}.png"), img)
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            from dynfu_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(engine, os.path.join(out_dir, "checkpoint.npz"))
    return 0


def run_dataset_rigid(
    dataset: str,
    out_dir: Optional[str] = None,
    max_frames: int = 0,
    volume_dims: int = 512,
    export_viz: bool = False,
    save_every: int = 5,
) -> int:
    """Rigid KinectFusion over a dataset (the kfusion workload): tracks the
    camera, fuses the volume, exports the mesh + trajectory."""
    import dataclasses

    from dynfu_tpu.engine.kinfu import KinFu
    from dynfu_tpu.engine.params import KinFuParams

    depths, colors = meshio.list_dataset(dataset)
    if max_frames:
        depths = depths[:max_frames]
        colors = colors[:max_frames]
    if not depths:
        print(f"no depth frames found under {dataset}/depth")
        return 1
    out_dir = out_dir or os.path.join(dataset, "out")
    os.makedirs(out_dir, exist_ok=True)

    first = meshio.load_depth_png(depths[0])
    h, w = first.shape
    params = dataclasses.replace(
        KinFuParams.default_params(), rows=h, cols=w,
        volume_dims=(volume_dims,) * 3,
    )
    engine = KinFu(params)
    sampler = SampledScopeTime()
    loader = DepthLoader(depths)
    print(f"depth decoder: {loader.decoder}")
    poses = []
    for i in range(len(loader)):
        with sampler:
            ok = engine(loader[i])
            sync(engine.prev_pyr[0][0] if engine.prev_pyr else None)
        R, t = engine.get_camera_pose()
        poses.append(np.concatenate([np.asarray(R).ravel(), np.asarray(t)]))
        print(f"frame {i}: {'tracked' if ok else 'bootstrap'}")
        if export_viz and engine.prev_pyr is not None and i % save_every == 0:
            meshio.save_image_png(
                os.path.join(out_dir, f"rigid_render{i}.png"),
                np.asarray(engine.render(0)),
            )
    np.savetxt(os.path.join(out_dir, "trajectory.txt"), np.stack(poses))
    verts, faces = engine.get_mesh()
    meshio.save_ply_indexed(os.path.join(out_dir, "rigid_mesh.ply"), verts, faces)
    print(f"saved trajectory + mesh to {out_dir}")
    return 0
