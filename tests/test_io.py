"""IO round-trips, synthetic dataset generation, and the CLI app loop
end-to-end on a tiny generated dataset."""

import os

import numpy as np
import pytest

from dynfu_tpu.core.camera import Intr
from dynfu_tpu.engine.params import DynFuParams, KinFuParams
from dynfu_tpu.io import meshio
from dynfu_tpu.io.app import run_dataset
from dynfu_tpu.io.cli import main as cli_main
from dynfu_tpu.io.datasets import generate_synthetic
from dynfu_tpu.utils.timers import SampledScopeTime, ScopeTime


def test_depth_png_roundtrip(tmp_path):
    d = (np.random.RandomState(0).rand(32, 40) * 4000).astype(np.int32)
    p = str(tmp_path / "d.png")
    meshio.save_depth_png(p, d)
    back = meshio.load_depth_png(p)
    np.testing.assert_array_equal(back, d)


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint16), ((20, 31), np.uint8), ((20, 31, 3), np.uint8),
    ((9, 7, 4), np.uint8), ((11, 13, 3), np.uint16)])
def test_png_codec_roundtrip(tmp_path, shape, dtype):
    """The numpy + zlib PNG writer/reader round-trips 16- and 8-bit gray,
    RGB and RGBA images bit-exactly."""
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    p = str(tmp_path / "x.png")
    meshio.write_png(p, img)
    back = meshio.read_png(p)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)


def _png_chunk(kind, body):
    import struct
    import zlib

    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def test_png_reader_undoes_every_filter(tmp_path):
    """Rows written with each of the five PNG filters (None, Sub, Up,
    Average, Paeth), as other encoders emit them, decode exactly."""
    import struct
    import zlib

    rng = np.random.RandomState(3)
    h, w, bpp = 10, 9, 3
    img = rng.randint(0, 256, (h, w * bpp)).astype(np.int64)
    raw, prev = [], np.zeros(w * bpp, np.int64)
    for y in range(h):
        ftype, cur, enc = y % 5, img[y], []
        for i in range(w * bpp):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else c)]
            enc.append((cur[i] - pred[ftype]) % 256)
        raw.append(bytes([ftype] + enc))
        prev = cur
    p = tmp_path / "f.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n"
                  + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                    0, 0, 0))
                  + _png_chunk(b"IDAT", zlib.compress(b"".join(raw)))
                  + _png_chunk(b"IEND", b""))
    np.testing.assert_array_equal(meshio.read_png(str(p)),
                                  img.reshape(h, w, bpp).astype(np.uint8))


def test_pcd_export(tmp_path):
    pts = np.random.RandomState(1).rand(17, 3).astype(np.float32)
    p = str(tmp_path / "c.pcd")
    meshio.save_pcd(p, pts)
    lines = open(p).read().splitlines()
    assert lines[1] == "VERSION 0.7"
    assert f"POINTS {len(pts)}" in lines
    data = np.loadtxt(lines[lines.index("DATA ascii") + 1 :])
    np.testing.assert_allclose(data, pts, rtol=1e-5)


def triangle_soup():
    # two triangles sharing an edge
    return np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0],
            [1, 0, 0], [1, 1, 0], [0, 1, 0],
        ],
        np.float32,
    )


def test_vtk_and_ply_export(tmp_path):
    soup = triangle_soup()
    vtk = str(tmp_path / "m.vtk")
    ply = str(tmp_path / "m.ply")
    meshio.save_vtk(vtk, soup)
    meshio.save_ply(ply, soup)
    vtk_text = open(vtk).read()
    assert "POINTS 4 float" in vtk_text  # shared vertices merged
    assert "POLYGONS 2 8" in vtk_text
    ply_text = open(ply).read()
    assert "element vertex 4" in ply_text and "element face 2" in ply_text
    # winding flip 0,2,1 (kinfu.cpp:250-257): faces reference valid indices
    faces = [
        list(map(int, l.split()))[1:]
        for l in ply_text.splitlines()
        if l.startswith("3 ")
    ]
    assert all(0 <= i < 4 for f in faces for i in f)


def test_generate_synthetic_and_list(tmp_path):
    root = generate_synthetic(str(tmp_path / "seq"), frames=3, h=48, w=64)
    depths, colors = meshio.list_dataset(root)
    assert len(depths) == 3 and colors == []
    d = meshio.load_depth_png(depths[0])
    assert d.shape == (48, 64) and d.max() > 1000


def test_timers(capsys):
    with ScopeTime("x"):
        pass
    assert "Time(x)" in capsys.readouterr().out
    s = SampledScopeTime()
    for _ in range(SampledScopeTime.EACH):
        with s:
            pass
    assert "fps" in capsys.readouterr().out


@pytest.mark.slow
def test_app_end_to_end(tmp_path):
    """dynfu synth + dynfu run on a tiny sequence: artifacts land in out/."""
    root = str(tmp_path / "seq")
    generate_synthetic(root, frames=3, h=96, w=128)

    params = DynFuParams(
        kinfu=KinFuParams(
            rows=96, cols=128,
            intr=Intr(140.0, 140.0, 63.5, 47.5),
            volume_dims=(64, 64, 64), volume_size=(2.0, 2.0, 2.0),
            volume_pose_t=(-1.0, -1.0, 0.5),
        ),
        max_nodes=256, max_vertices=3 * 4096, max_mc_voxels=1 << 13,
        max_new_nodes=128, node_sample_step=64,
    )
    rc = run_dataset(root, max_frames=3, params=params, export_viz=True)
    assert rc == 0
    out = os.path.join(root, "out")
    files = os.listdir(out)
    assert "pcl_canonical_to_live0.pcd" in files
    assert "1_tsdf_mesh.vtk" in files and "1_tsdf_mesh.ply" in files
    assert "render2.png" in files


def test_cli_synth(tmp_path):
    rc = cli_main(["synth", str(tmp_path / "s"), "--frames", "2",
                   "--rows", "32", "--cols", "40"])
    assert rc == 0
    assert len(os.listdir(tmp_path / "s" / "depth")) == 2


def test_render_cloud():
    from dynfu_tpu.utils.viz import render_cloud

    rng = np.random.RandomState(2)
    pts = rng.rand(500, 3).astype(np.float32) * 0.4 - 0.2
    pts[:, 2] += 1.0
    img = render_cloud(pts, Intr(140.0, 140.0, 63.5, 47.5), shape=(96, 128))
    assert img.shape == (96, 128, 3) and img.dtype == np.uint8
    assert img.max() > img.min()  # something rendered


@pytest.mark.slow
def test_rigid_app_end_to_end(tmp_path):
    """dynfu run --rigid on a tiny synthetic sequence."""
    from dynfu_tpu.io.app import run_dataset_rigid

    root = str(tmp_path / "seq")
    generate_synthetic(root, frames=3, h=96, w=128)
    # the synthetic generator's camera is fx=525-scaled; regenerate with a
    # matching small intrinsic via params? run_dataset_rigid probes H,W and
    # uses default 525 focal — scene visibility is narrow but nonzero.
    rc = run_dataset_rigid(root, max_frames=3, volume_dims=64, export_viz=False)
    assert rc == 0
    out = os.path.join(root, "out")
    assert "trajectory.txt" in os.listdir(out)
    assert "rigid_mesh.ply" in os.listdir(out)
