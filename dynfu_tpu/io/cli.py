"""`dynfu` command-line entry point (analog of src/apps/demo.cpp).

Usage: dynfu run [--export-viz] [--frames N] [--volume-dims D] <dataset-dir>
The dataset dir must contain depth/*.png (16-bit depth in mm), as in the
reference's VolumeDeform layout (demo.cpp:39-55). Outputs per-frame warped
clouds (.pcd) and meshes (.ply/.vtk) under <dataset-dir>/out.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dynfu", description=__doc__)
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend (sets jax_platforms "
                             "before any jax use)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run non-rigid fusion on a dataset dir")
    run.add_argument("dataset", help="directory with depth/*.png")
    run.add_argument("--export-viz", action="store_true", help="export phong renders per frame")
    run.add_argument("--frames", type=int, default=0, help="max frames (0 = all)")
    run.add_argument("--volume-dims", type=int, default=128)
    run.add_argument("--out", default=None, help="output dir (default <dataset>/out)")
    run.add_argument("--checkpoint-every", type=int, default=0,
                     help="save <out>/checkpoint.npz every N frames")
    run.add_argument("--resume", default=None, help="checkpoint to resume from")
    run.add_argument("--rigid", action="store_true",
                     help="run the rigid kfusion pipeline instead of DynFusion")
    run.add_argument("--mode", default=None,
                     choices=["parity", "fixed", "fusion"],
                     help="DynFusion engine mode (default: parity; 'fusion' "
                          "= persistent canonical volume)")
    run.add_argument("--fg-box", default=None, metavar="x0,y0,z0,x1,y1,z1",
                     help="foreground-tracking box in volume-frame meters "
                          "(DynFuParams.fg_aabb — VolumeDeform-style "
                          "foreground masks as a box): warp/correspondence/"
                          "solve track only vertices inside; background "
                          "stays in the volume and exports")
    run.add_argument("--max-fg-verts", type=int, default=1 << 15,
                     help="tracked-set capacity with --fg-box (overflow "
                          "counts as dropped correspondences)")
    run.add_argument("--devices", type=int, default=0,
                     help="run the engine sharded over an N-device mesh "
                          "(dist.driver.ShardedDynFusion; volume blocked, "
                          "vertices row-sharded). 0 = single device. "
                          "Multi-host runs additionally set "
                          "DYNFU_COORDINATOR/DYNFU_NUM_PROCESSES/"
                          "DYNFU_PROCESS_ID (dist.runtime).")

    bench = sub.add_parser("bench", help="run the synthetic benchmark")
    bench.add_argument("--volume-dims", type=int, default=128)
    bench.add_argument("--frames", type=int, default=12)
    bench.add_argument("--rigid", action="store_true",
                       help="benchmark the rigid kfusion pipeline instead")
    bench.add_argument("--stages", action="store_true",
                       help="report per-stage ms (profiling breakdown) "
                            "instead of end-to-end fps")
    bench.add_argument("--profile", default=None, metavar="DIR",
                       help="write a jax.profiler trace of the benchmark "
                            "to DIR (inspect with TensorBoard/XProf)")
    bench.add_argument("--rotations", action="store_true",
                       help="with --fusion: per-node SE(3) solve + DLB warp")
    bench.add_argument("--fusion", action="store_true",
                       help="benchmark the persistent-canonical fusion mode "
                            "(fps + canonical/warped error in mm)")

    synth = sub.add_parser(
        "synth", help="generate a synthetic deforming depth sequence"
    )
    synth.add_argument("out_dir")
    synth.add_argument("--frames", type=int, default=30)
    synth.add_argument("--rows", type=int, default=480)
    synth.add_argument("--cols", type=int, default=640)

    args = parser.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.cmd == "run":
        # multi-host bootstrap BEFORE any device-enumerating jax API —
        # no-op without a configured coordinator (dist/runtime.py)
        from dynfu_tpu.dist.runtime import init_distributed

        init_distributed()
        from dynfu_tpu.utils.device import print_short_device_info
        from dynfu_tpu.utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        print_short_device_info()
        from dynfu_tpu.io.app import run_dataset

        fg_aabb = None
        if args.fg_box:
            v = [float(x) for x in args.fg_box.split(",")]
            if len(v) != 6:
                parser.error("--fg-box needs 6 comma-separated numbers")
            fg_aabb = (tuple(v[:3]), tuple(v[3:]))
        return run_dataset(
            args.dataset,
            out_dir=args.out,
            max_frames=args.frames,
            volume_dims=args.volume_dims,
            export_viz=args.export_viz,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            rigid=args.rigid,
            mode=args.mode,
            devices=args.devices,
            fg_aabb=fg_aabb,
            max_fg_verts=args.max_fg_verts,
        )
    if args.cmd == "bench":
        from dynfu_tpu.utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        from dynfu_tpu.utils.benchmarks import (
            run_benchmark, run_fusion_benchmark, run_rigid_benchmark,
            run_stage_benchmark)

        import contextlib

        @contextlib.contextmanager
        def _maybe_profile():
            if not args.profile:
                yield
                return
            import jax

            with jax.profiler.trace(args.profile):
                yield
            print(f"# trace written to {args.profile}")

        if args.stages:
            with _maybe_profile():
                result = run_stage_benchmark(volume_dims=args.volume_dims)
        elif args.fusion:
            with _maybe_profile():
                result = run_fusion_benchmark(volume_dims=args.volume_dims,
                                              frames=args.frames,
                                              rotations=args.rotations)
        elif args.rigid:
            with _maybe_profile():
                result = run_rigid_benchmark(volume_dims=args.volume_dims,
                                             frames=args.frames)
        else:
            with _maybe_profile():
                result = run_benchmark(volume_dims=args.volume_dims,
                                       frames=args.frames)
        print(result)
        return 0
    if args.cmd == "synth":
        from dynfu_tpu.io.datasets import generate_synthetic

        generate_synthetic(args.out_dir, frames=args.frames, h=args.rows, w=args.cols)
        print(f"wrote {args.frames} frames to {args.out_dir}/depth")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
