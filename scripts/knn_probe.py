#!/usr/bin/env python
"""Time the k-NN formulations and the correspondence window placement.

    python scripts/knn_probe.py [--part knn|window|all] [--seed 0]

--part knn: `ops/knn.knn_gather` (padded HIGHEST distance matmul, argmin
rounds, one-hot feature fetch) against two plain-XLA variants on one
warp-sized call — 65,536 queries x 1,024 nodes, k=8, 13 feature columns,
10% of the nodes masked: the same padded distances with a `table[idx]`
gather, and elementwise K=3 distances with the gather. Reports the median
of 5 runs of 10 calls and each variant's neighbour-index agreement with
knn_gather.

--part window: runs the 512-cube parity engine on the 640x480 sphere for 16
frames, then sweeps that frame's correspondence (`dynfusion._correspondence`)
with one 4096-point window per 4096-query tile and with 4096-point windows
placed at 1024-point granularity (the DynFuParams default): certificate
failures with the failure tiers off, drops with the preset tiers, and the
median time of each.

Prints the card line and one JSON line per measurement. Exits 2 unless JAX
runs on a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _time_ms(fn, *args, runs: int = 5, calls: int = 10) -> list:
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            r = fn(*args)
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / calls * 1e3)
    return out


def _report(name: str, ms: list, **extra) -> None:
    print(name, json.dumps({"ms_median": round(statistics.median(ms), 4),
                            "ms_all": [round(m, 4) for m in ms], **extra}),
          flush=True)


def part_knn(seed: int, queries: int = 65536) -> None:
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from dynfu_tpu.ops import knn

    Q, D, K, F = queries, 1024, 8, 13
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.rand(Q, 3).astype("float32") + [0.0, 0.0, 1.0])
    p = jnp.asarray(rng.rand(D, 3).astype("float32") + [0.0, 0.0, 1.0])
    table = jnp.asarray(rng.randn(D, F).astype("float32"))
    mask = jnp.asarray(rng.rand(D) >= 0.1)

    def topk_gather(d, table):
        d = jnp.where(mask[None, :], d, knn._INF)
        sqd, idx = knn._topk_argmin(d, K)
        return idx, sqd, table[idx]

    @jax.jit
    def padded_gather(q, p, table):
        return topk_gather(knn.pairwise_sqdist(q, p), table)

    @jax.jit
    def direct_gather(q, p, table):
        d = sum((q[:, None, c] - p[None, :, c]) ** 2 for c in range(3))
        return topk_gather(d, table)

    current = jax.jit(functools.partial(knn.knn_gather, k=K,
                                        point_mask=mask))
    want = np.asarray(current(q, p, table=table)[0])
    for name, fn in (("onehot (current)",
                      lambda q, p, t: current(q, p, table=t)),
                     ("padded dist + gather", padded_gather),
                     ("direct dist + gather", direct_gather)):
        idx = np.asarray(fn(q, p, table)[0])
        _report(name, _time_ms(fn, q, p, table),
                idx_agree=float((idx == want).mean()))


def part_window(seed: int, dims: int = 512, frames: int = 16) -> None:
    import jax
    import numpy as np

    from dynfu_tpu.core.camera import Intr
    from dynfu_tpu.engine import dynfusion as dyn
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    del seed  # the sphere sequence is analytic
    rows, cols = 480, 640
    intr = Intr(525.0, 525.0, cols / 2 - 0.5, rows / 2 - 0.5)
    dp = DynFuParams(kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                                       volume_dims=(dims,) * 3),
                     **DynFuParams.caps_for_volume(dims))
    engine = dyn.DynFusion(dp)
    for i in range(frames):
        engine(np.asarray(sphere_depth((0.004 * i, 0.0, 1.5), 0.5, rows, cols,
                                       525.0, 525.0, cols / 2 - 0.5,
                                       rows / 2 - 0.5), np.uint16))
    wv = engine.canonical_warped.vertices
    cm = engine.canonical.mask
    lv, lm = engine.live.vertices, engine.live.mask
    n_live = int(np.asarray(lm).sum())
    for name, block, wb in (("one 4096 window per 4096 tile", 4096, 1),
                            ("4096 windows at 1024 granularity",
                             dp.corr_block, dp.corr_window_blocks)):
        for tiers, rescue, escalate in (("off", 0, 0),
                                        ("preset", dp.corr_rescue,
                                         dp.corr_escalate)):
            fn = jax.jit(lambda wv, cm, lv, lm, b=block, w=wb, r=rescue,
                         e=escalate: dyn._correspondence(
                             wv, wv, cm, lv, lm, True, rescue=r, escalate=e,
                             block=b, window_blocks=w)[2])
            ok = np.asarray(fn(wv, cm, lv, lm))
            _report(f"{name}, tiers {tiers}", _time_ms(fn, wv, cm, lv, lm),
                    live=n_live, failed=int(n_live - ok.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("knn", "window", "all"), default="all")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from dynfu_tpu.utils.device import require_gpu
    from dynfu_tpu.utils.jaxcache import enable_compilation_cache

    require_gpu()
    enable_compilation_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.part in ("knn", "all"):
        part_knn(args.seed)
    if args.part in ("window", "all"):
        part_window(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
