"""Operations and bytes of the port's kernels, from the shapes a run gives
them, and the card's published peaks: the yardstick of every roofline share.

Each input byte is read once and each output byte written once, whatever a
kernel reads again; operations are what the function needs. Frozen copies
of the port's own counts (``tools/profile_kernels.py``, ``chip_smoke.py``'s
``moved=`` and ``flops=``), so that a change to the program cannot move its
own yardstick. Imports nothing of the port.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # CUDA cores
PEAK_TF32_FLOPS = 495e12  # tensor cores
BLOCK = 8  # the fused candidate kernel's pixel block (``topk_block``)


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def gaussian_taps(sigma: float) -> int:
    """Taps of the port's 1-D Gaussian of ``sigma`` (radius ceil(3 sigma))."""
    return 2 * max(1, int(math.ceil(3.0 * sigma))) + 1


def detect_launches(frontend: dict, size, lanes: int = 1) -> list:
    """(kernel, flops, bytes) of every B1 and B2 launch of one DoG frame
    of ``size`` (rows, columns) for ``lanes`` lanes, from the frontend's
    settings: the base blur, then per octave the five-level blur (B1) and
    the candidate kernel on the five DoG layers (B2: the fused block kernel
    where 8 divides both sides, else the response map)."""
    S = frontend["scales_per_octave"]
    s0 = frontend["sigma0"]
    sig = [s0 * 2.0 ** (i / S) for i in range(S + 3)]
    rel = [math.sqrt(max(s ** 2 - sig[0] ** 2, 1e-6)) for s in sig[1:]]
    h, w = size
    if frontend["upsample_first_octave"]:
        h, w = 2 * h, 2 * w
        base = math.sqrt(max(s0 ** 2 - 1.0, 0.01))
    else:
        base = s0
    out = [("blur_levels_kernel", lanes * 4 * gaussian_taps(base) * h * w, lanes * 4 * h * w * 2)]
    for _ in range(frontend["num_octaves"]):
        taps = [gaussian_taps(s) for s in rel]
        out.append(("blur_levels_kernel", lanes * sum(4 * t for t in taps) * h * w,
                    lanes * 4 * h * w * (1 + len(taps))))
        layers = len(rel)  # DoG layers of the octave; the inner ones are scored
        n_in = lanes * 4 * layers * h * w
        ops = lanes * 40 * (layers - 2) * h * w
        if h % BLOCK == 0 and w % BLOCK == 0:
            out.append(("candidate_block_max", ops,
                        n_in + lanes * 8 * (layers - 2) * (h // BLOCK) * (w // BLOCK)))
        else:
            out.append(("candidate_response", ops, n_in + lanes * 4 * (layers - 2) * h * w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def match_launch(n_views: int, n_keypoints: int, valid_queries: float, dim: int = 128,
                 lanes: int = 1) -> tuple:
    """(flops, bytes) of one B3 launch: every stored key of the window's
    views against the new view's valid keys; on the tensor cores at f32
    accuracy each product is three TF32 products."""
    n_ref = n_views * n_keypoints
    flops = lanes * 3 * 2 * n_ref * valid_queries * dim
    nbytes = lanes * (4 * (n_ref + n_keypoints) * dim + n_keypoints + 12 * n_ref)
    return flops, nbytes


def ba_blocks_launch(slots: int, n_views: int) -> tuple:
    """(flops, bytes) of one B4 launch over ``slots`` observation slots:
    the six gathered inputs (56 B a slot), DtD, W and b_p out (132 B), the
    camera sums (57 floats a camera)."""
    return 400 * slots, 188 * slots + 4 * 57 * n_views


def expand_cam_launch(slots: int, n_views: int) -> tuple:
    """(flops, bytes) of one B5 launch: ids, W and the slot's product, the
    camera vector."""
    return 2 * 21 * slots, slots * (4 + 84 + 12) + 28 * n_views


def reduce_cam_launch(filled: int, n_views: int, cam_rows: int) -> tuple:
    """(flops, bytes) of one B6 launch over the camera-major view: the
    filled slots' W and y rows, the view's ids and mask, the sums."""
    return 2 * 21 * filled, filled * (84 + 12) + 5 * n_views * cam_rows + 28 * n_views
