"""Dataset loading and point-cloud/mesh export (numpy + the standard
library; no OpenCV/PCL/PIL).

Replaces the reference's I/O surface:
* 16-bit depth PNG loading via cv::imread (demo.cpp:85-90) -> read_png;
* pcl::io::savePCDFileASCII warped-cloud export (demo.cpp:21-31) -> save_pcd;
* pcl::io::saveVTKFile mesh export (demo.cpp:33-37) -> save_vtk;
* plus .ply export (the modern default for downstream tools).

The mesh writers take the engine's triangle soup (3 consecutive vertices per
triangle) and apply the reference's winding (0, 2, 1 — convertToMesh,
kinfu.cpp:250-257).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples/pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec section 9): (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:]
        if ftype == 0:  # None
            line = cur.copy()
        elif ftype == 2:  # Up
            line = cur + prev
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            lanes = cur.reshape(-1, bpp).astype(np.int64)
            line = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).ravel()
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            c, p = cur.tolist(), prev.tolist()
            line_l = [0] * stride
            for i in range(stride):
                a = line_l[i - bpp] if i >= bpp else 0
                b = p[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = p[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc)
                line_l[i] = (c[i] + pred) & 0xFF
            line = np.asarray(line_l, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = line
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA
    PNG: (H, W) or (H, W, C) array, uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path!r} is not a PNG file")
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if interlace or depth not in (8, 16) or ctype not in _CHANNELS:
        raise ValueError(f"{path!r}: unsupported PNG (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        arr = px.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        arr = px.reshape(h, w, ch)
    return arr[..., 0] if arr.shape[-1] == 1 else arr


def write_png(path: str, img: np.ndarray) -> None:
    """Encode a uint8 or uint16 (H, W) gray, (H, W, 3) RGB or (H, W, 4)
    RGBA array as a PNG (every row Up-filtered)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1)
    up = rows - np.concatenate([np.zeros_like(rows[:1]), rows[:-1]])
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG in millimeters -> (H, W) int32."""
    arr = read_png(path)
    if arr.ndim == 3:  # some tools save depth replicated across channels
        arr = arr[..., 0]
    return arr.astype(np.int32)


def load_color_png(path: str) -> np.ndarray:
    """8-bit color PNG -> (H, W, 3) uint8 (the reference's cv::imread of
    the color/ directory, demo.cpp:46-55; the pipeline's math never reads
    it — the frame API carries it for parity)."""
    arr = read_png(path)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    elif arr.shape[2] == 2:  # gray + alpha
        arr = np.repeat(arr[..., :1], 3, axis=2)
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    return np.ascontiguousarray(arr[..., :3], dtype=np.uint8)


def list_dataset(root: str) -> Tuple[List[str], List[str]]:
    """Sorted depth/ and color/ file lists (DynFuApp::loadFiles,
    demo.cpp:39-55). color/ may be absent (depth-only pipeline)."""
    depth_dir = os.path.join(root, "depth")
    if not os.path.isdir(depth_dir):
        raise FileNotFoundError(
            f"dataset dir {root!r} must contain a depth/ subdirectory"
        )
    depths = sorted(
        os.path.join(depth_dir, f)
        for f in os.listdir(depth_dir)
        if f.lower().endswith((".png", ".pgm"))
    )
    color_dir = os.path.join(root, "color")
    colors = (
        sorted(
            os.path.join(color_dir, f)
            for f in os.listdir(color_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        if os.path.isdir(color_dir)
        else []
    )
    return depths, colors


def save_pcd(path: str, points: np.ndarray) -> None:
    """ASCII PCD v0.7 (x y z), matching pcl::io::savePCDFileASCII output."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, points, fmt="%.9g")


def _soup_to_indexed(tri_soup: np.ndarray):
    """Triangle soup (3N, 3) -> (unique vertices, faces) with the reference
    winding 0,2,1 (convertToMesh, kinfu.cpp:250-257)."""
    tri_soup = np.asarray(tri_soup, np.float32)
    n_tris = len(tri_soup) // 3
    soup = tri_soup[: 3 * n_tris]
    q = np.round(soup.astype(np.float64) / 1e-7).astype(np.int64)
    uniq, inv = np.unique(q, axis=0, return_inverse=True)
    verts = uniq.astype(np.float64) * 1e-7
    faces = inv.reshape(-1, 3)[:, [0, 2, 1]]
    return verts.astype(np.float32), faces.astype(np.int64)


def save_vtk(path: str, tri_soup: np.ndarray) -> None:
    """Legacy ASCII VTK PolyData, like pcl::io::saveVTKFile."""
    verts, faces = _soup_to_indexed(tri_soup)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nvtk output\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {len(verts)} float\n")
        np.savetxt(f, verts, fmt="%.9g")
        f.write(f"POLYGONS {len(faces)} {len(faces) * 4}\n")
        np.savetxt(
            f,
            np.concatenate([np.full((len(faces), 1), 3), faces], axis=1),
            fmt="%d",
        )


def save_ply(path: str, tri_soup: np.ndarray) -> None:
    """Binary-less ASCII PLY triangle mesh."""
    verts, faces = _soup_to_indexed(tri_soup)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        np.savetxt(f, verts, fmt="%.9g")
        np.savetxt(
            f,
            np.concatenate([np.full((len(faces), 1), 3), faces], axis=1),
            fmt="%d",
        )


def save_ply_indexed(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY from an already-indexed (verts, faces) mesh."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        np.savetxt(f, np.asarray(verts, np.float32), fmt="%.9g")
        np.savetxt(
            f,
            np.concatenate(
                [np.full((len(faces), 1), 3), np.asarray(faces)], axis=1
            ),
            fmt="%d",
        )


def save_depth_png(path: str, depth_mm: np.ndarray) -> None:
    """16-bit depth PNG writer (for the synthetic dataset generator)."""
    write_png(path, np.asarray(depth_mm).astype(np.uint16))


def save_image_png(path: str, img: np.ndarray) -> None:
    write_png(path, np.asarray(img))
