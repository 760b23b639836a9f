"""Kernel B4: fused bundle-adjustment block assembly.

Port of ``structure_from_motion_tpu/ops/ba_pallas.py``. :func:`ba_blocks`
calls the ``sfm::ba_blocks`` operator, which launches ``csrc/ba_blocks.cu``
for CUDA tensors and runs :func:`ba_blocks_reference` for CPU tensors. Inputs are pre-gathered per
observation, as for the TPU kernel; any observation count O. With each
observation's camera intrinsics ``(f, k1, k2)`` as well (the operator's
optional last argument), the camera block is 10 wide (the kernel's width-10
instantiation, one lane).
"""

from __future__ import annotations

import functools

import torch

from structure_from_motion_tpu_torch import kernels
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians

_BLOCK = 128  # observations per block of csrc/ba_blocks.cu
# the kernel's partial rows: upper U | b_c | cost, by camera width
_ROW = {7: 36, 10: 66}


def huber_weights(res: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-observation sqrt-IRLS weights for the Huber loss; 1.0 if off."""
    if delta <= 0.0:
        return torch.ones(res.shape[0], dtype=res.dtype, device=res.device)
    norm = torch.linalg.norm(res, dim=-1)
    w = torch.where(norm <= delta, torch.ones_like(norm), delta / norm.clamp_min(1e-12))
    return torch.sqrt(w)


def cam_onehot(cam: torch.Tensor, n_views: int, dtype) -> torch.Tensor:
    """(..., O, V) one-hot of camera ids; ids outside [0, V) give a zero row."""
    return (cam[..., None] == torch.arange(n_views, device=cam.device)).to(dtype)


def ba_blocks_reference(cam, C_o, q_o, X_o, uv, w, n_views: int, huber_delta: float,
                        intr_o=None):
    """Plain version: (U (V,7,7), b_c (V,7), DtD (O,3,3), W (O,7,3),
    b_p (O,3), cost ()) from per-observation inputs; with a lane axis in
    front of every input, each output gets it too (cost (B,)). With
    ``intr_o`` (O,3), the camera blocks are 10 wide and ``uv`` in pixels."""
    lead = cam.shape[:-1]
    O = cam.shape[-1]
    res, J_cam, J_pt = batched_residual_jacobians(
        C_o.reshape(-1, 3), q_o.reshape(-1, 4), X_o.reshape(-1, 3), uv.reshape(-1, 2),
        None if intr_o is None else intr_o.reshape(-1, 3))
    nc = J_cam.shape[-1]
    rw = huber_weights(res, huber_delta) * w.reshape(-1)
    res = res * rw[:, None]
    J_cam = J_cam * rw[:, None, None]
    J_pt = J_pt * rw[:, None, None]
    UtU = torch.einsum("oki,okj->oij", J_cam, J_cam).reshape(lead + (O, nc, nc))
    DtD = torch.einsum("oki,okj->oij", J_pt, J_pt).reshape(lead + (O, 3, 3))
    W = torch.einsum("oki,okj->oij", J_cam, J_pt).reshape(lead + (O, nc, 3))
    bc_o = torch.einsum("oki,ok->oi", J_cam, res).reshape(lead + (O, nc))
    bp_o = torch.einsum("oki,ok->oi", J_pt, res).reshape(lead + (O, 3))
    oh = cam_onehot(cam.reshape(-1), n_views, UtU.dtype).reshape(lead + (O, n_views))
    U = torch.einsum("...ov,...oij->...vij", oh, UtU)
    b_c = oh.transpose(-1, -2) @ bc_o
    return U, b_c, DtD, W, bp_o, (res**2).reshape(lead + (-1,)).sum(-1)


@torch.library.custom_op("sfm::ba_blocks", mutates_args=(), device_types="cpu")
def _ba_blocks_op(cam: torch.Tensor, C_o: torch.Tensor, q_o: torch.Tensor, X_o: torch.Tensor,
                  uv: torch.Tensor, w: torch.Tensor, n_views: int, huber_delta: float,
                  intr_o: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """B4 as an operator: the plain version on the CPU, the kernel on the
    card, no other device."""
    return ba_blocks_reference(cam, C_o, q_o, X_o, uv, w, n_views, huber_delta, intr_o)


@_ba_blocks_op.register_fake
def _(cam, C_o, q_o, X_o, uv, w, n_views, huber_delta, intr_o=None):
    lead, O = cam.shape[:-1], cam.shape[-1]
    nc = 7 if intr_o is None else 10
    e = C_o.new_empty
    return (e(lead + (n_views, nc, nc)), e(lead + (n_views, nc)), e(lead + (O, 3, 3)),
            e(lead + (O, nc, 3)), e(lead + (O, 3)), e(lead))


def _check(cam, C_o, q_o, X_o, uv, w, n_views: int, intr_o=None) -> int:
    """What the kernel takes -> the lane count (0 without a lane axis)."""
    lead = cam.shape[:-1]
    lanes = cam.shape[0] if cam.dim() == 2 else 0
    O = cam.shape[-1]
    expect = {"C_o": (C_o, 3), "q_o": (q_o, 4), "X_o": (X_o, 3), "uv": (uv, 2)}
    if intr_o is not None:
        if lanes:
            raise ValueError("ba_blocks: the width-10 camera block takes no lane axis")
        expect["intr_o"] = (intr_o, 3)
    for name, (t, k) in expect.items():
        if t.shape != lead + (O, k) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != cam.device:
            raise ValueError(f"ba_blocks: {name} must be a contiguous {lead + (O, k)} "
                             "float32 tensor on the same device")
    if cam.dtype != torch.int32 or cam.dim() not in (1, 2) or w.shape != lead + (O,) \
            or w.dtype != torch.float32 or not (cam.is_contiguous() and w.is_contiguous()) \
            or w.device != cam.device:
        raise ValueError("ba_blocks: cam must be (O,) or (B, O) int32 and w the same float32")
    if O == 0 or n_views < 1 or (lanes and not (lanes <= 65535 and O % 4 == 0)):
        raise ValueError("ba_blocks: need O > 0 observations and n_views > 0 (and, with "
                         "lanes, 4 | O and at most 65535 of them)")
    return lanes


@_ba_blocks_op.register_kernel("cuda")
def _(cam, C_o, q_o, X_o, uv, w, n_views, huber_delta, intr_o=None):
    lanes = _check(cam, C_o, q_o, X_o, uv, w, n_views, intr_o)
    nc = 7 if intr_o is None else 10
    lead, O = cam.shape[:-1], cam.shape[-1]
    dev = cam.device
    n = max(lanes, 1)
    nb = -(-O // _BLOCK)
    # scratch of the camera reduction: one payload row (36 or 66 floats) per
    # (lane, block, camera present in it), then one slot byte per (lane,
    # camera, block)
    n_rows = n * nb * min(_BLOCK, n_views) * _ROW[nc]
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    dtd, wblk, bp = f32(lead + (O, 3, 3)), f32(lead + (O, nc, 3)), f32(lead + (O, 3))
    # each camera's cost share at [..., 0]: torch sums a strided vector in one
    # order whatever V is (a contiguous one over 128 floats it vectorises)
    U, b_c = f32(lead + (n_views, nc, nc)), f32(lead + (n_views, nc))
    cost = f32(lead + (n_views, 2))
    scratch = f32(n_rows + -(-n * n_views * nb // 4))
    rc = kernels.library().sfm_ba_blocks_lanes(
        cam.data_ptr(), C_o.data_ptr(), q_o.data_ptr(), X_o.data_ptr(), uv.data_ptr(),
        w.data_ptr(), None if intr_o is None else intr_o.data_ptr(), n, O, n_views,
        float(huber_delta), dtd.data_ptr(), wblk.data_ptr(), bp.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + 4 * n_rows, U.data_ptr(), b_c.data_ptr(), cost.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(rc, "sfm_ba_blocks_lanes")
    ba_blocks.launches += 1
    return U, b_c, dtd, wblk, bp, cost[..., 0].sum(-1)


def ba_blocks(cam, C_o, q_o, X_o, uv, w, n_views: int, huber_delta: float, intr_o=None):
    """Fused residual/Jacobian/block products over all observations; same
    outputs as :func:`ba_blocks_reference` (the ``sfm::ba_blocks``
    operator). With a lane axis ((B, O) ids, (B, O, 3) centres, ...) ONE
    launch makes every lane's blocks and camera sums, each lane exactly as
    its own launch (4 must divide O then). On the card an observation whose
    camera id lies outside [0, n_views) enters no camera sum, and the cost
    is the sum of the cameras' shares (the plain version's cost counts
    every residual; the pipeline gives such an id no weight). With
    ``intr_o`` (O,3), each observation's camera's ``(f, k1, k2)``, the
    camera blocks are 10 wide and ``uv`` is in pixels (no lane axis)."""
    if cam.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ba_blocks: unsupported device {cam.device}")
    return torch.ops.sfm.ba_blocks(cam, C_o, q_o, X_o, uv, w, int(n_views), float(huber_delta),
                                   intr_o)


ba_blocks.launches = 0
