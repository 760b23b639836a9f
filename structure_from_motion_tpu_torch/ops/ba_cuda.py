"""Kernel B4: fused bundle-adjustment block assembly.

Port of ``structure_from_motion_tpu/ops/ba_pallas.py``. :func:`ba_blocks`
launches ``csrc/ba_blocks.cu`` for CUDA tensors and runs
:func:`ba_blocks_reference` for CPU tensors. Inputs are pre-gathered per
observation, as for the TPU kernel; any observation count O.
"""

from __future__ import annotations

import torch

from structure_from_motion_tpu_torch import kernels
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians

_PAYLOAD = 57  # [U (49) | b_c (7) | cost (1)] per camera


def huber_weights(res: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-observation sqrt-IRLS weights for the Huber loss; 1.0 if off."""
    if delta <= 0.0:
        return torch.ones(res.shape[0], dtype=res.dtype, device=res.device)
    norm = torch.linalg.norm(res, dim=-1)
    w = torch.where(norm <= delta, torch.ones_like(norm), delta / norm.clamp_min(1e-12))
    return torch.sqrt(w)


def cam_onehot(cam: torch.Tensor, n_views: int, dtype) -> torch.Tensor:
    """(O, V) one-hot of camera ids; ids outside [0, V) give a zero row."""
    return (cam[:, None] == torch.arange(n_views, device=cam.device)).to(dtype)


def ba_blocks_reference(cam, C_o, q_o, X_o, uv, w, n_views: int, huber_delta: float):
    """Plain version: (U (V,7,7), b_c (V,7), DtD (O,3,3), W (O,7,3),
    b_p (O,3), cost ()) from per-observation inputs."""
    res, J_cam, J_pt = batched_residual_jacobians(C_o, q_o, X_o, uv)
    rw = huber_weights(res, huber_delta) * w
    res = res * rw[:, None]
    J_cam = J_cam * rw[:, None, None]
    J_pt = J_pt * rw[:, None, None]
    UtU = torch.einsum("oki,okj->oij", J_cam, J_cam)
    DtD = torch.einsum("oki,okj->oij", J_pt, J_pt)
    W = torch.einsum("oki,okj->oij", J_cam, J_pt)
    bc_o = torch.einsum("oki,ok->oi", J_cam, res)
    bp_o = torch.einsum("oki,ok->oi", J_pt, res)
    oh = cam_onehot(cam, n_views, UtU.dtype)
    U = torch.einsum("ov,oij->vij", oh, UtU)
    b_c = oh.T @ bc_o
    return U, b_c, DtD, W, bp_o, torch.sum(res**2)


def ba_blocks(cam, C_o, q_o, X_o, uv, w, n_views: int, huber_delta: float):
    """Fused residual/Jacobian/block products over all observations; same
    outputs as :func:`ba_blocks_reference`."""
    if cam.device.type == "cpu":
        return ba_blocks_reference(cam, C_o, q_o, X_o, uv, w, n_views, huber_delta)
    if cam.device.type != "cuda":
        raise ValueError(f"ba_blocks: unsupported device {cam.device}")
    O = cam.shape[0]
    expect = {"C_o": (C_o, 3), "q_o": (q_o, 4), "X_o": (X_o, 3), "uv": (uv, 2)}
    for name, (t, k) in expect.items():
        if t.shape != (O, k) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != cam.device:
            raise ValueError(f"ba_blocks: {name} must be a contiguous ({O}, {k}) "
                             "float32 tensor on the same device")
    if cam.dtype != torch.int32 or w.shape != (O,) or w.dtype != torch.float32 \
            or not (cam.is_contiguous() and w.is_contiguous()) or w.device != cam.device:
        raise ValueError("ba_blocks: cam must be (O,) int32 and w (O,) float32")
    if O == 0 or n_views < 1:
        raise ValueError("ba_blocks: need O > 0 observations and n_views > 0")
    dev = cam.device
    nb = (O + 127) // 128
    dtd = torch.empty((O, 9), dtype=torch.float32, device=dev)
    wblk = torch.empty((O, 21), dtype=torch.float32, device=dev)
    bp = torch.empty((O, 3), dtype=torch.float32, device=dev)
    partial = torch.empty((nb, n_views, _PAYLOAD), dtype=torch.float32, device=dev)
    acc = torch.empty((n_views, _PAYLOAD), dtype=torch.float32, device=dev)
    rc = kernels.library().sfm_ba_blocks(
        cam.data_ptr(), C_o.data_ptr(), q_o.data_ptr(), X_o.data_ptr(),
        uv.data_ptr(), w.data_ptr(), O, n_views, float(huber_delta),
        dtd.data_ptr(), wblk.data_ptr(), bp.data_ptr(), partial.data_ptr(),
        acc.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "sfm_ba_blocks")
    ba_blocks.launches += 1
    return (
        acc[:, :49].reshape(n_views, 7, 7),
        acc[:, 49:56],
        dtd.view(O, 3, 3),
        wblk.view(O, 7, 3),
        bp,
        acc[:, 56].sum(),
    )


ba_blocks.launches = 0
