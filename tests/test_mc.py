"""Marching cubes: table self-consistency + watertight meshing of analytic
surfaces (the strongest possible check on LUT correctness)."""

import numpy as np
import pytest

import jax.numpy as jnp

from dynfu_tpu.mesh import marching_cubes, tables
from dynfu_tpu.volume import tsdf as tv


def test_tables_consistent_with_crossings():
    """Every case's referenced edges == exactly its sign-crossing edges."""
    for c in range(256):
        inside = [(c >> i) & 1 for i in range(8)]
        crossed = {
            e
            for e, (a, b) in enumerate(tables.EDGE_CORNERS)
            if inside[a] != inside[b]
        }
        used = {int(x) for x in tables.TRI_TABLE[c] if x >= 0}
        assert used.issubset(crossed), f"case {c}: non-crossed edge used"
        if used:
            assert used == crossed, f"case {c}: crossed edge unused"
    assert tables.NUM_VERTS_TABLE[0] == 0 and tables.NUM_VERTS_TABLE[255] == 0
    assert tables.NUM_VERTS_TABLE.max() == 15


def sphere_volume(cfg, center, radius):
    X, Y, Z = cfg.dims
    vs = cfg.voxel_size
    # MC samples tsdf at voxel centers (+0.5 shift)
    x = (np.arange(X) + 0.5) * vs[0]
    y = (np.arange(Y) + 0.5) * vs[1]
    z = (np.arange(Z) + 0.5) * vs[2]
    g = np.stack(np.meshgrid(x, y, z, indexing="ij"), -1)
    d = np.linalg.norm(g - np.asarray(center), axis=-1) - radius
    t = np.clip(d / cfg.trunc_dist, -1, 1).astype(np.float16)
    vol = tv.create(cfg)
    return vol._replace(tsdf=jnp.asarray(t), weight=jnp.ones(cfg.dims, jnp.uint8))


def run_sphere(dims=32):
    cfg = tv.TsdfConfig(dims=(dims,) * 3, size=(1.0, 1.0, 1.0), trunc_dist=0.08)
    center, radius = (0.5, 0.5, 0.5), 0.3
    vol = sphere_volume(cfg, center, radius)
    verts, n, _ = marching_cubes(vol, cfg, max_voxels=1 << 15, max_verts=3 * 20000)
    n = int(n)
    verts = np.asarray(verts)[:n]
    return verts, center, radius


def test_sphere_vertices_on_surface():
    verts, center, radius = run_sphere()
    assert len(verts) > 1000 and len(verts) % 3 == 0
    r = np.linalg.norm(verts - np.asarray(center), axis=-1)
    # linear interpolation of a truncated SDF: sub-voxel accuracy
    assert np.abs(r - radius).max() < 0.01


def test_sphere_mesh_watertight():
    """Closed surface: every undirected edge shared by exactly 2 triangles,
    every directed edge appearing exactly once (consistent orientation).
    Any LUT typo breaks this immediately."""
    verts, _, _ = run_sphere()
    tris = verts.reshape(-1, 3, 3)
    # quantize vertices to merge identical interpolated positions
    q = np.round(verts / 1e-6).astype(np.int64)
    _, inv = np.unique(q, axis=0, return_inverse=True)
    tri_idx = inv.reshape(-1, 3)
    # drop degenerate triangles (repeated vertex ids)
    ok = (
        (tri_idx[:, 0] != tri_idx[:, 1])
        & (tri_idx[:, 1] != tri_idx[:, 2])
        & (tri_idx[:, 0] != tri_idx[:, 2])
    )
    tri_idx = tri_idx[ok]
    directed = {}
    for a, b, c in tri_idx:
        for u, v in ((a, b), (b, c), (c, a)):
            directed[(u, v)] = directed.get((u, v), 0) + 1
    # consistent orientation: each directed edge once, opposite edge once
    for (u, v), cnt in directed.items():
        assert cnt == 1, f"directed edge {(u, v)} seen {cnt} times"
        assert directed.get((v, u), 0) == 1, f"edge {(u, v)} unmatched"


def test_sphere_normals_orientation():
    """Triangle winding must face a consistent direction vs the SDF gradient
    (outward for tsdf = positive-outside)."""
    verts, center, _ = run_sphere()
    tris = verts.reshape(-1, 3, 3)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nn = np.linalg.norm(n, axis=-1)
    keep = nn > 1e-12
    n = n[keep] / nn[keep, None]
    centroid = tris[keep].mean(axis=1) - np.asarray(center)
    centroid /= np.linalg.norm(centroid, axis=-1, keepdims=True)
    d = np.sum(n * centroid, axis=-1)
    # all faces point the same way relative to outward
    assert (d < 0).all() or (d > 0).all()


def test_weight_gating_blocks_unobserved_cells():
    cfg = tv.TsdfConfig(dims=(16, 16, 16), size=(1.0, 1.0, 1.0), trunc_dist=0.1)
    vol = sphere_volume(cfg, (0.5, 0.5, 0.5), 0.3)
    vol0 = vol._replace(weight=jnp.zeros(cfg.dims, jnp.uint8))
    _, n, _ = marching_cubes(vol0, cfg, max_voxels=1 << 12, max_verts=3 * 4096)
    assert int(n) == 0


def test_capacity_truncation_is_safe():
    cfg = tv.TsdfConfig(dims=(32, 32, 32), size=(1.0, 1.0, 1.0), trunc_dist=0.08)
    vol = sphere_volume(cfg, (0.5, 0.5, 0.5), 0.3)
    verts, n, dropped = marching_cubes(vol, cfg, max_voxels=256, max_verts=300)
    assert int(n) <= 300
    assert np.isfinite(np.asarray(verts)).all()
    # the sphere occupies far more than 256 cells: the overflow must be
    # REPORTED, not silent
    assert int(dropped) > 0


def _forced_hierarchical_mc():
    """marching_cubes with the small-volume direct path disabled (same
    source-patch device as test_hierarchical_compaction_matches_direct)."""
    import types

    import dynfu_tpu.mesh.mc as mc_mod

    src = open(mc_mod.__file__).read()
    patched = src.replace("if n_cells < (1 << 18):", "if False:")
    assert patched != src, "hierarchical-path guard string changed; update test"
    mod = types.ModuleType("mc_forced_hierarchical")
    mod.__dict__.update(mc_mod.__dict__)
    exec(compile(patched, "mc_forced_hierarchical", "exec"), mod.__dict__)
    return mod


def test_hierarchical_column_overflow_is_counted():
    """A z-parallel wall with more crossings per column than the per-column
    budget K must report its dropped cells (a silent loss would hide
    behind a cpu-only debug print)."""
    cfg = tv.TsdfConfig(dims=(16, 16, 64), size=(1.0, 1.0, 1.0),
                        trunc_dist=0.08)
    # K = 4 + 4*ceil(trunc/voxel_z) = 4 + 4*ceil(0.08/(1/64)) = 28; a sign
    # flip every z cell gives 63 crossings per column > K
    t = np.fromfunction(lambda x, y, z: (-1.0) ** z, cfg.dims, dtype=np.int64)
    vol = tv.create(cfg)._replace(
        tsdf=jnp.asarray(t, jnp.float16),
        weight=jnp.ones(cfg.dims, jnp.uint8))
    mod = _forced_hierarchical_mc()
    v1, n1, d1 = mod.marching_cubes(vol, cfg, max_voxels=1 << 15,
                                    max_verts=3 * 60000)
    # direct path on the same volume: complete, zero dropped
    v2, n2, d2 = marching_cubes(vol, cfg, max_voxels=1 << 15,
                                max_verts=3 * 60000)
    assert int(d2) == 0
    assert int(d1) > 0
    # every interior cell of the alternating pattern crosses and emits
    # exactly 6 vertices (cases 0x0F/0xF0): dropped = total - captured
    occ_total = 15 * 15 * 63
    assert int(n2) == 6 * occ_total
    assert int(d1) == occ_total - int(n1) // 6
    assert int(n1) < int(n2)


def test_hierarchical_compaction_matches_direct():
    """The large-volume per-column compaction path must produce the same
    voxel stream as the direct nonzero path (identical order, no overflow
    on this scene)."""
    import types

    import dynfu_tpu.mesh.mc as mc_mod

    src = open(mc_mod.__file__).read()
    patched = src.replace("if n_cells < (1 << 18):", "if False:")
    assert patched != src, "hierarchical-path guard string changed; update test"
    mod = types.ModuleType("mc_forced_hierarchical")
    mod.__dict__.update(mc_mod.__dict__)
    exec(compile(patched, "mc_forced_hierarchical", "exec"), mod.__dict__)

    cfg = tv.TsdfConfig(dims=(32, 32, 32), size=(1.0, 1.0, 1.0), trunc_dist=0.08)
    vol = sphere_volume(cfg, (0.5, 0.5, 0.5), 0.3)
    v1, n1, d1 = marching_cubes(vol, cfg, max_voxels=1 << 14, max_verts=3 * 20000)
    v2, n2, d2 = mod.marching_cubes(vol, cfg, max_voxels=1 << 14, max_verts=3 * 20000)
    assert int(d1) == 0 and int(d2) == 0
    assert int(n1) == int(n2)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)


def test_no_ungated_host_callbacks_in_library():
    """A host callback (jax.debug.print / io_callback / pure_callback)
    traced into a GPU program stalls the device stream until the host
    answers, every frame. Library code may only use them behind an
    explicit `jax.default_backend() == "cpu"` trace-time gate."""
    import os
    import re

    import dynfu_tpu

    root = os.path.dirname(dynfu_tpu.__file__)
    pat = re.compile(r"debug\.print|io_callback|pure_callback|debug\.callback")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            lines = open(path).read().splitlines()
            for i, line in enumerate(lines):
                if not pat.search(line):
                    continue
                # gated iff a cpu-backend check appears within the
                # 10 preceding lines (the trace-time platform gate)
                ctx = "\n".join(lines[max(0, i - 10):i])
                if 'default_backend() == "cpu"' not in ctx:
                    offenders.append(f"{path}:{i + 1}: {line.strip()}")
    assert not offenders, (
        "host callbacks without a cpu-backend gate (they stall the device "
        "stream):\n" + "\n".join(offenders))


@pytest.mark.parametrize("spill", [False, True])
def test_emit_triangles_matches_numpy_loop(spill):
    """The triangle emission scatter reproduces the loop-form stream
    exactly: per-voxel counts, exclusive-scan offsets, zero rows beyond
    the last written one and, with `spill`, rows past max_tris dropped."""
    import jax.numpy as jnp

    from dynfu_tpu.mesh.mc import emit_triangles
    from dynfu_tpu.utils import reference

    rng = np.random.RandomState(5 + spill)
    M = 1024
    k = rng.randint(0, 6, M).astype(np.int32)
    k[rng.rand(M) < 0.3] = 0  # plenty of empty cells
    offs = (np.cumsum(k) - k).astype(np.int32)
    tris = rng.rand(M, 5, 9).astype(np.float32)
    max_tris = 100 if spill else int(k.sum()) + 7
    got = np.asarray(emit_triangles(jnp.asarray(tris), jnp.asarray(offs),
                                    jnp.asarray(k), max_tris))
    want = reference.emit_triangles(tris, offs, k, max_tris)
    np.testing.assert_array_equal(got, want)
