"""PLY point-cloud export of the sparse map + camera trajectory (port of
``structure_from_motion_tpu/io/ply.py``; host numpy, the same bytes).

The reference's only 3D output is a matplotlib X-Z scatter
(``ba_processor.py:507-544``) and pickled arrays. PLY is the lingua franca
for point-cloud tooling (MeshLab, CloudCompare, Open3D), so a complete
framework should emit it directly. Map points are written white, camera
centers red, so a viewer shows the trajectory inside the cloud at a glance.
"""

from __future__ import annotations

import numpy as np

_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ]
)

_POINT_RGB = (220, 220, 220)
_CAMERA_RGB = (255, 40, 40)


def export_ply(
    path: str,
    points,
    cameras=None,
    binary: bool = True,
) -> int:
    """Write ``points`` (N, 3) and optional ``cameras`` (F, 3) centers to
    ``path``. Returns the total vertex count."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    cams = (
        np.asarray(cameras, np.float64).reshape(-1, 3)
        if cameras is not None
        else np.zeros((0, 3))
    )
    n = len(pts) + len(cams)
    rec = np.empty(n, _DTYPE)
    for i, axis in enumerate("xyz"):
        rec[axis][: len(pts)] = pts[:, i]
        rec[axis][len(pts):] = cams[:, i]
    for j, ch in enumerate(("red", "green", "blue")):
        rec[ch][: len(pts)] = _POINT_RGB[j]
        rec[ch][len(pts):] = _CAMERA_RGB[j]

    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"comment structure_from_motion_tpu sparse model "
        f"({len(pts)} points, {len(cams)} cameras)\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(rec.tobytes())
        else:
            for r in rec:
                fh.write(
                    f"{r['x']:.8g} {r['y']:.8g} {r['z']:.8g} "
                    f"{r['red']} {r['green']} {r['blue']}\n".encode("ascii")
                )
    return n


def read_ply(path: str):
    """Minimal reader for the files :func:`export_ply` writes (both
    formats). Returns (xyz (N, 3) float64, rgb (N, 3) uint8)."""
    with open(path, "rb") as fh:
        line = fh.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = 0
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            parts = line.split()
            if parts[0] == b"format":
                fmt = parts[1].decode()
            elif parts[0] == b"element" and parts[1] == b"vertex":
                n = int(parts[2])
            elif parts[0] == b"end_header":
                break
        if fmt == "binary_little_endian":
            rec = np.frombuffer(fh.read(n * _DTYPE.itemsize), _DTYPE, count=n)
        elif fmt == "ascii":
            rows = [fh.readline().split() for _ in range(n)]
            rec = np.array(
                [tuple(float(v) for v in r) for r in rows],
                dtype=[(name, "<f8") for name in _DTYPE.names],
            ).astype(_DTYPE)
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float64)
    rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
    return xyz, rgb
