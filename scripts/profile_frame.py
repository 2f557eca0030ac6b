#!/usr/bin/env python
"""Trace the parity DynFusion frame and attribute device time to its stages.

    python scripts/profile_frame.py [--dims 512] [--frames 5] [--out DIR]

Runs the 512-cube parity engine (640x480 sphere sequence) past its warm-up,
records a `jax.profiler` trace of `--frames` frames, and reduces the trace:
every device event of the frame program is attributed, through the op
metadata of the compiled HLO, to the `jax.named_scope` stage it ran under
(`engine/dynfusion._nonrigid_frame`: integrate, extract, warp,
correspondence, solve with its gram assembly, insert), and the time of
every `ops/knn.knn_gather` call is also reported per stage. Prints one JSON
object and writes it, with the raw trace, under DIR (default
chiprun_out/profile_frame). CUDA-graph command buffers are switched off
for the traced process, so every kernel event names its HLO instruction;
the per-frame times therefore include one launch per kernel. Exits 2
unless JAX runs on a GPU; `--cpu` rehearses the reduction on the CPU
backend.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
STAGES = ("integrate", "extract", "warp", "correspondence", "solve", "insert")
OPS = ("knn_gather",)  # jitted ops whose time is also reported per stage
_NAME = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+) .*->.*\{\s*$")


def _kernel_name(instr: str) -> str:
    """HLO instruction name -> the name its GPU kernel carries."""
    return re.sub(r"[.\-]", "_", instr)


def stage_of(op_name: str) -> str | None:
    """First stage scope on an op_name path, with gram split out of solve,
    and ":op" appended when the path runs inside one of OPS (`jit(op)`)."""
    parts = op_name.split("/")
    for p in parts:
        if p in STAGES:
            st = "solve/gram" if p == "solve" and "gram" in parts else p
            ops = [o for o in OPS if f"jit({o})" in parts or o in parts]
            return f"{st}:{ops[0]}" if ops else st
    return None


def scope_map(hlo_text: str) -> dict:
    """Instruction name -> stage, from the compiled HLO text's op metadata.
    An instruction without metadata (some fusions) takes the most common
    stage among the ops of the computation it calls."""
    comp_stages = collections.defaultdict(collections.Counter)
    direct, calls = {}, {}
    comp = None
    for line in hlo_text.splitlines():
        mi = _NAME.match(line)
        if not mi:
            mc = _COMP.match(line)
            if mc:
                comp = mc.group(1)
            continue
        name = mi.group(1)
        mo, mcall = _OPNAME.search(line), _CALLS.search(line)
        st = stage_of(mo.group(1)) if mo else None
        if st:
            direct[name] = st
            if comp:
                comp_stages[comp][st] += 1
        elif mcall:
            calls[name] = mcall.group(1)
    for name, called in calls.items():
        if comp_stages[called]:
            direct[name] = comp_stages[called].most_common(1)[0][0]
    direct.update({_kernel_name(k): v for k, v in list(direct.items())})
    return direct


def _union_ns(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(xplane_path: str, stage_of_op: dict, module: str,
                 frames: int) -> dict:
    """Per-stage device ms per frame, busy share, and unattributed time."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    per_stage = collections.Counter()
    per_op = collections.defaultdict(collections.Counter)
    intervals, sample = [], []
    frame_ns = other_ns = 0.0
    planes = []
    for plane in pd.planes:
        if not (plane.name.startswith("/device:")
                or plane.name == "/host:CPU"):
            continue
        planes.append(plane.name)
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                dur = float(ev.duration_ns)
                intervals.append((float(ev.start_ns),
                                  float(ev.start_ns) + dur))
                if len(sample) < 40:
                    sample.append({"plane": plane.name, "line": line.name,
                                   "name": ev.name, "ns": dur,
                                   "stats": {k: str(v)[:120]
                                             for k, v in stats.items()}})
                if module not in str(stats.get("hlo_module", "")):
                    other_ns += dur
                    continue
                frame_ns += dur
                label = stage_of_op.get(op) or stage_of_op.get(ev.name)
                st, _, inner = (label or "unattributed").partition(":")
                per_stage[st] += dur
                if inner:
                    per_op[inner][st] += dur
    window_ns = (max(e for _, e in intervals) - min(s for s, _ in intervals)
                 if intervals else 0.0)
    busy_ns = _union_ns(intervals)
    ms = lambda ns: round(ns / frames / 1e6, 4)  # noqa: E731
    return {
        "planes": planes,
        "frames": frames,
        "frame_device_ms": ms(frame_ns),
        "stage_device_ms": {k: ms(v) for k, v in sorted(per_stage.items())},
        "stage_share": {k: round(v / frame_ns, 4)
                        for k, v in sorted(per_stage.items())} if frame_ns
        else {},
        "op_device_ms": {o: {"total": ms(sum(c.values())),
                             **{k: ms(v) for k, v in sorted(c.items())}}
                         for o, c in per_op.items()},
        "op_share": {o: round(sum(c.values()) / frame_ns, 4)
                     for o, c in per_op.items()} if frame_ns else {},
        "other_module_device_ms": ms(other_ns),
        "window_ms": round(window_ns / 1e6, 3),
        "busy_share": round(busy_ns / window_ns, 4) if window_ns else None,
        "sample_events": sample,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, default=512)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "profile_frame"))
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend")
    args = ap.parse_args(argv)
    # kernels inside CUDA-graph command buffers report the graph, not their
    # HLO instruction, as their op: launch each kernel on its own instead
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    sys.path.insert(0, str(REPO))
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from dynfu_tpu.utils.device import require_gpu

        require_gpu()
    import numpy as np

    from dynfu_tpu.core.camera import Intr
    from dynfu_tpu.engine import dynfusion as dyn
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth
    from dynfu_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    rows, cols = 480, 640
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    dp = DynFuParams(kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                                       volume_dims=(args.dims,) * 3),
                     **DynFuParams.caps_for_volume(args.dims))
    engine = dyn.DynFusion(dp)
    frames = [np.asarray(sphere_depth((0.004 * i, 0.0, 1.5), 0.5, rows, cols,
                                      525.0, 525.0, cols / 2 - 0.5,
                                      rows / 2 - 0.5), np.uint16)
              for i in range(4 + args.frames)]
    for i in range(4):
        engine(frames[i])
    jax.block_until_ready(engine.warped_cloud(unique=True))

    c = engine.canonical
    lowered = dyn._nonrigid_frame.lower(
        engine.vol, engine.warpfield, c.vertices, c.normals, c.mask,
        jax.numpy.asarray(frames[0]), engine.poses[-1], dp=dp, intr=intr,
        config=engine.tsdf_config, strict_parity=True,
        integrate_mode="separable", canonical_mult=engine.canonical_mult)
    hlo = lowered.compile().as_text()
    stage_map = scope_map(hlo)

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        for i in range(4, 4 + args.frames):
            engine(frames[i])
        jax.block_until_ready(engine.warped_cloud(unique=True))
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(
        args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    out = reduce_trace(path, stage_map, "_nonrigid_frame", args.frames)
    out.update(dims=args.dims, traced_wall_ms_per_frame=round(
        wall / args.frames * 1e3, 3), device=jax.devices()[0].device_kind,
        mapped_instructions=len(stage_map), xplane=os.path.relpath(path,
                                                                   REPO))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    with open(os.path.join(args.out, "frame_hlo.txt"), "w") as f:
        f.write(hlo)
    out.pop("sample_events")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
