"""Host-side dataset utilities (port of
``structure_from_motion_tpu/io/datasets.py``; numpy, and PIL only where it is
installed -- nothing here touches the device).

The count-header txt point loader with its 2-column y/x swap, and image
ingestion: a built-in decoder for uncompressed 24/32-bit BMP files, PIL for
everything else.
"""

from __future__ import annotations

import struct

import numpy as np


def load_points_txt(path: str) -> np.ndarray:
    """Load the reference's txt point-file format -> homogeneous (N, 3).

    First line: point count. Then one point per line; 2-column lines are
    stored (y, x) and swapped on load, 3-column lines are (x, y, z)
    (reference ``utils.py:199-216``).
    """
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0].strip())
    pts = np.ones((n, 3), dtype=np.float64)
    for i in range(n):
        cols = lines[i + 1].split()
        if len(cols) == 2:
            y, x = (float(c) for c in cols)
            pts[i, 0], pts[i, 1] = x, y
        else:
            x, y, z = (float(c) for c in cols[:3])
            pts[i] = (x, y, z)
    return pts


def _decode_bmp_grayscale(path: str) -> np.ndarray:
    """Minimal 24/32-bit uncompressed BMP decoder -> float32 grayscale."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"not a BMP file: {path}")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError("unsupported BMP header")
    width, height = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression != 0 or bpp not in (24, 32):
        raise ValueError(f"unsupported BMP: bpp={bpp} compression={compression}")
    flip = height > 0
    height = abs(height)
    channels = bpp // 8
    row_stride = (width * channels + 3) & ~3
    buf = np.frombuffer(
        data, dtype=np.uint8, count=row_stride * height, offset=pixel_offset
    ).reshape(height, row_stride)
    img = buf[:, : width * channels].reshape(height, width, channels)
    if flip:
        img = img[::-1]
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    # ITU-R BT.601 luma, same weights cv2.cvtColor(BGR2GRAY) uses
    return (0.114 * b + 0.587 * g + 0.299 * r).astype(np.float32)


def load_image_grayscale(path: str) -> np.ndarray:
    """Decode an image to float32 grayscale (H, W) in [0, 255]."""
    if path.lower().endswith(".bmp"):
        try:
            return _decode_bmp_grayscale(path)
        except ValueError:
            pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"), dtype=np.float32)
        return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    except ImportError as exc:  # pragma: no cover
        raise RuntimeError(f"no decoder available for {path}") from exc


def upenn_intrinsics() -> np.ndarray:
    """Hard-coded K of the upenn test sequence (reference
    ``ba_processor.py:457-459``)."""
    return np.array(
        [
            [568.996140852, 0.0, 643.21055941],
            [0.0, 568.988362396, 477.982801038],
            [0.0, 0.0, 1.0],
        ]
    )
