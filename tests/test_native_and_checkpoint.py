"""Native loader parity with the numpy PNG decoder, and checkpoint/resume."""

import numpy as np
import pytest

from dynfu_tpu.io import meshio
from dynfu_tpu.io.datasets import generate_synthetic
from dynfu_tpu.io.native_loader import DepthLoader, available
from dynfu_tpu.utils.checkpoint import load_checkpoint, save_checkpoint


def test_native_loader_matches_pil(tmp_path):
    root = generate_synthetic(str(tmp_path / "seq"), frames=4, h=64, w=80)
    depths, _ = meshio.list_dataset(root)
    ldr = DepthLoader(depths, queue_depth=2, threads=2)
    try:
        for i in range(len(ldr)):
            ref = meshio.load_depth_png(depths[i])
            np.testing.assert_array_equal(ldr[i], ref)
    finally:
        ldr.close()


@pytest.mark.skipif(not available(), reason="no native toolchain")
def test_native_loader_is_native(tmp_path):
    root = generate_synthetic(str(tmp_path / "seq"), frames=1, h=32, w=40)
    depths, _ = meshio.list_dataset(root)
    ldr = DepthLoader(depths)
    assert ldr.native
    ldr.close()


def _png_all_filters(path, img):
    """PNG of img whose rows cycle through all five filter types (spec
    section 9), with the IDAT stream split over two chunks."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bpp = ch * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1).astype(int)
    raw = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        ftype = y % 5
        pred = [0, a, prev, (a + prev) >> 1, paeth][ftype]
        raw.append(np.concatenate([[ftype], (cur - pred) & 0xFF]))
    data = zlib.compress(np.concatenate(raw).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    half = len(data) // 2
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h,
                                             8 * img.dtype.itemsize, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:])
                + chunk(b"IEND", b""))


@pytest.mark.skipif(not available(), reason="no native toolchain")
@pytest.mark.parametrize("dtype,channels", [
    (np.uint16, 1), (np.uint8, 1), (np.uint8, 2), (np.uint8, 3),
    (np.uint16, 4)])
def test_native_decode_matches_numpy_all_filters(tmp_path, dtype, channels):
    """The native decoder (no PNG library) undoes every row filter and
    returns the first channel widened to uint16, as the numpy decoder's
    load_depth_png does."""
    import ctypes

    from dynfu_tpu.io import native_loader as nl

    rng = np.random.RandomState(channels)
    shape = (23, 17) if channels == 1 else (23, 17, channels)
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "f.png")
    _png_all_filters(path, img)
    want = img if channels == 1 else img[..., 0]
    np.testing.assert_array_equal(meshio.load_depth_png(path), want)

    out = np.empty(img.size, np.uint16)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = nl._load().dfl_decode_one(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(h), ctypes.byref(w), out.size)
    assert rc == 0 and (h.value, w.value) == shape[:2]
    np.testing.assert_array_equal(out[: h.value * w.value].reshape(shape[:2]),
                                  want)


@pytest.mark.skipif(not available(), reason="no native toolchain")
def test_native_decode_rejects_corrupt_png(tmp_path):
    """A truncated IDAT stream is a decode failure (rc 1), not garbage."""
    import ctypes

    from dynfu_tpu.io import native_loader as nl

    path = tmp_path / "f.png"
    _png_all_filters(str(path), np.arange(64, dtype=np.uint16).reshape(8, 8))
    data = path.read_bytes()
    path.write_bytes(data[:40] + data[60:])
    out = np.empty(64, np.uint16)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = nl._load().dfl_decode_one(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(h), ctypes.byref(w), out.size)
    assert rc == 1


def test_native_load_failure_warns(tmp_path, monkeypatch):
    """A library that builds but does not load falls back with a warning
    that names the reason, not silently."""
    from dynfu_tpu.io import native_loader as nl

    bogus = tmp_path / "libbogus.so"
    bogus.write_text("not an ELF file")
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_find_or_build_lib", lambda: str(bogus))
    with pytest.warns(RuntimeWarning, match="did not load"):
        assert nl._load() is None


def _tiny_engine():

    from dynfu_tpu.core.camera import Intr
    from dynfu_tpu.engine.dynfusion import DynFusion
    from dynfu_tpu.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu.io.datasets import sphere_depth

    params = DynFuParams(
        kinfu=KinFuParams(
            rows=48, cols=64, intr=Intr(70.0, 70.0, 31.5, 23.5),
            volume_dims=(32, 32, 32), volume_size=(1.0, 1.0, 1.0),
            volume_pose_t=(-0.5, -0.5, 0.25),
        ),
        max_nodes=64, max_vertices=3 * 1024, max_mc_voxels=1 << 11,
        max_new_nodes=32, node_sample_step=32,
    )
    df = DynFusion(params)
    depth = sphere_depth((0.0, 0.0, 0.6), 0.2, 48, 64, 70.0, 70.0, 31.5, 23.5)
    return df, depth


def test_checkpoint_roundtrip(tmp_path):
    df, depth = _tiny_engine()
    df(depth)
    df(depth)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(df, path)

    df2, depth2 = _tiny_engine()
    load_checkpoint(df2, path)
    assert df2.frame_counter == df.frame_counter
    np.testing.assert_array_equal(np.asarray(df2.vol.tsdf), np.asarray(df.vol.tsdf))
    np.testing.assert_array_equal(
        np.asarray(df2.warpfield.pos), np.asarray(df.warpfield.pos)
    )
    # resumed engine continues identically to the uninterrupted one
    df(depth)
    df2(depth)
    a, _ = df.warped_cloud()
    b, _ = df2.warped_cloud()
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
