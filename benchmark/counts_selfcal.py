"""Operations and bytes of kernels B4, B5 and B6 at the self-calibrating
camera block (width 10: ``[C, q, f, k1, k2]``), from the shapes a run gives
them, priced as ``counts.py`` prices the width-7 launches: each input byte
read once and each output byte written once, operations what the function
needs. Imports nothing of the port."""

from __future__ import annotations


def ba_blocks10_launch(slots: int, n_views: int) -> tuple:
    """(flops, bytes) of one B4 launch at width 10 over ``slots`` slots: the
    seven gathered inputs (camera id, C, q, X, uv, weight and the camera's
    f, k1, k2: 68 B a slot), DtD, W (10x3) and b_p out (168 B), the camera
    sums (U, b_c and the cost: 112 floats a camera). Operations: the
    rotation and projection with the distortion (~120), the 2x10 and 2x3
    rows through the 2x2 pixel Jacobian (~90), the 55 + 10 + 1 payload
    products (~200) and the 30 + 9 + 3 block products (~130)."""
    return 540 * slots, 236 * slots + 4 * 112 * n_views


def expand_cam10_launch(slots: int, n_views: int) -> tuple:
    """(flops, bytes) of one B5 launch at width 10: the id, the W row (120
    B) and the slot's product (12 B) a slot, the camera vector (40 B)."""
    return 2 * 30 * slots, slots * (4 + 120 + 12) + 40 * n_views


def reduce_cam10_launch(filled: int, n_views: int, view_slots: int) -> tuple:
    """(flops, bytes) of one B6 launch at width 10 over the camera-major
    view: the filled slots' W and y rows (132 B), the view's ids and mask
    (5 B a view slot), each camera's run and sum (8 + 40 B)."""
    return 2 * 30 * filled, filled * (120 + 12) + 5 * view_slots + 48 * n_views
