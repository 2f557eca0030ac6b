#!/usr/bin/env python
"""Regenerate the vendored data/umbrella sequence (deterministic depths).

The reference validates end-to-end on the real VolumeDeform "umbrella"
Kinect recording (download_data.sh). Its mirrors are unreachable from this
build environment (no egress), so the vendored sequence is a Kinect-v1
sensor-model rendering of the same scene class — see
dynfu_tpu/io/kinect_sim.py for the noise model and provenance.

Usage: python scripts/make_umbrella_data.py [out_dir] [frames]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from dynfu_tpu.io import meshio
from dynfu_tpu.io.kinect_sim import umbrella_frame


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "data", "umbrella")
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    depth_dir = os.path.join(out, "depth")
    os.makedirs(depth_dir, exist_ok=True)
    for i in range(frames):
        d = umbrella_frame(i, frames=frames)
        meshio.save_depth_png(os.path.join(depth_dir, f"frame{i:04d}.png"), d)
        print(f"frame {i}: {int((d > 0).sum())} valid px, "
              f"z range [{d[d > 0].min()}, {d.max()}] mm")
    print(f"wrote {frames} frames to {depth_dir}")


if __name__ == "__main__":
    main()
