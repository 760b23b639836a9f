"""Kernels B5 and B6: the two camera halves of the PCG Schur matvec; B8:
the block-Jacobi preconditioner's diagonal blocks over the same camera view.

Port of ``structure_from_motion_tpu/ops/ba_matvec_pallas.py``. One product
of the reduced camera system with ``x`` (``ops/ba.py::_solve_pcg``) runs

    B5 expand:  t_o    = W_o^T x[cam_o]                  (O, 3)
    (point sum, D^-1, point broadcast: y_o per slot)
    B6 reduce:  coup_v = sum_{o: cam_o = v} W_o y_o      (V, 7)

``W`` is B4's row-major ``(O, 7, 3)`` output, read as ``(O, 21)`` with
component ``i*3+c`` (the JAX package's ``w21`` transposed). B6 walks the
camera-major view of the stream that ``ops/ba.compute_cam_ell`` builds
once per BA call: ``perm[v*rows + r]`` is camera v's r-th observation,
``mask`` marks the filled slots. Once per LM iteration B8 sums each
camera's diagonal block of the reduced system over the same view,

    B8 cam_diag: S_v  = sum_{o: cam_o = v} W_o D^-1_{p(o)} W_o^T   (V, 7, 7)

(``ops/ba.py::_solve_pcg``'s preconditioner; B6 also forms the reduced
right-hand side's coupling, ``_reduce_and_solve``). :func:`expand_cam`,
:func:`reduce_cam` and :func:`cam_diag` call the ``sfm::expand_cam``,
``sfm::reduce_cam`` and ``sfm::cam_diag`` operators, which launch
``csrc/ba_matvec.cu`` for CUDA tensors and run the plain versions for CPU
tensors.

Both take the camera block's width from their arguments: ``x (V, 7)`` and
``w21 (O, 21)`` for ``[C, q]``, ``x (V, 10)`` and ``w (O, 30)`` for the
self-calibrating ``[C, q, f, k1, k2]`` (the kernels' width-10
instantiations); B8 from ``w``, giving (V, 10, 10). ``seg`` (V, 2) gives
each camera its own run of the camera-major view, ``(first slot, rows)``,
where the BA call cut the cameras into tiers of their own row counts
(``ops/ba.compute_cam_tiers``); without it camera v owns slots ``[v * rows,
(v + 1) * rows)``. B8 reads each run in about ``S / (V *
DIAG_PART_SLOTS)`` parts, one block a part, and adds them in a second
launch (``cam_diag_fold``) where there are several.
"""

from __future__ import annotations

import torch

from structure_from_motion_tpu_torch import kernels


def expand_cam_reference(cam: torch.Tensor, w21: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: t (O, 3) with t[o] = W_o^T x[cam_o]; a camera id
    outside [0, V) gives a zero row (the one-hot semantics of the TPU
    kernel)."""
    V, nc = x.shape
    ok = (cam >= 0) & (cam < V)
    xo = x[cam.long().clamp(0, V - 1)] * ok[:, None].to(x.dtype)
    return torch.einsum("oic,oi->oc", w21.reshape(-1, nc, 3), xo)


def reduce_cam_reference(w21: torch.Tensor, y: torch.Tensor, perm: torch.Tensor,
                         mask: torch.Tensor, n_views: int,
                         seg: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: coup (V, nc) with coup[v] = sum of W_o y_o over the
    filled slots of camera v's rows of the camera-major view (``seg``: its
    own run of them)."""
    nc = w21.shape[1] // 3
    z = torch.einsum("oic,oc->oi", w21.reshape(-1, nc, 3), y)
    return _view_sum(z[perm.long()] * mask[:, None].to(z.dtype), n_views, seg)


def cam_diag_reference(w: torch.Tensor, dinv: torch.Tensor, point: torch.Tensor,
                       perm: torch.Tensor, mask: torch.Tensor, n_views: int,
                       seg: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: S (V, nc, nc) with S[v] = sum of W_o D^-1_{p(o)} W_o^T
    over the filled slots of camera v's rows of the camera-major view
    (``seg``: its own run of them); ``point`` (O,) the slots' point ids,
    ``dinv`` (M, 3, 3)."""
    nc = w.shape[1] // 3
    o = perm.long()
    W = w.reshape(-1, nc, 3)[o]
    WD = torch.einsum("oic,ocd->oid", W, dinv[point[o].long()])
    g = torch.einsum("oid,ojd->oij", WD, W) * mask[:, None, None].to(W.dtype)
    return _view_sum(g, n_views, seg)


def _view_sum(g: torch.Tensor, n_views: int, seg: torch.Tensor | None) -> torch.Tensor:
    """Per-camera sums of values ``g`` (S, ...) laid out as the camera-major
    view: ``n_views`` equal runs, or each camera's run ``seg[v]``."""
    if seg is None:
        return g.reshape((n_views, -1) + g.shape[1:]).sum(1)
    by_start = torch.argsort(seg[:, 0].long(), stable=True)  # the runs in slot order
    owner = torch.repeat_interleave(by_start, seg[by_start, 1].long(), output_size=g.shape[0])
    return g.new_zeros((n_views,) + g.shape[1:]).index_add_(0, owner, g)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if t.shape != shape or t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on {dev}")


@torch.library.custom_op("sfm::expand_cam", mutates_args=(), device_types="cpu")
def _expand_cam_op(cam: torch.Tensor, w21: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """B5 as an operator: the plain version on the CPU, the kernel on the
    card, no other device."""
    return expand_cam_reference(cam, w21, x)


@_expand_cam_op.register_fake
def _(cam, w21, x):
    return w21.new_empty((cam.shape[0], 3))


def _width(name: str, x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[1] not in (7, 10):
        raise ValueError(f"{name} must be (V, 7) or (V, 10): a camera block of 7 or 10")
    return x.shape[1]


def _check_expand(cam, w21, x) -> None:
    O, V = cam.shape[0], x.shape[0]
    nc = _width("expand_cam: x", x)
    _check("expand_cam: cam", cam, (O,), torch.int32, cam.device)
    _check("expand_cam: w21", w21, (O, 3 * nc), torch.float32, cam.device)
    _check("expand_cam: x", x, (V, nc), torch.float32, cam.device)
    if O == 0 or V < 1:
        raise ValueError("expand_cam: need O > 0 observations and V > 0 cameras")


@_expand_cam_op.register_kernel("cuda")
def _(cam, w21, x):
    _check_expand(cam, w21, x)
    O, V = cam.shape[0], x.shape[0]
    t = torch.empty((O, 3), dtype=torch.float32, device=cam.device)
    rc = kernels.library().sfm_expand_cam_w(
        cam.data_ptr(), w21.data_ptr(), x.data_ptr(), O, V, x.shape[1], t.data_ptr(),
        kernels.stream_ptr(cam.device),
    )
    kernels.check(rc, "sfm_expand_cam_w")
    expand_cam.launches += 1
    return t


def expand_cam(cam: torch.Tensor, w21: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t (O, 3) = W_o^T x[cam_o]; same result as :func:`expand_cam_reference`
    (the ``sfm::expand_cam`` operator)."""
    if cam.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expand_cam: unsupported device {cam.device}")
    if cam.device.type == "cuda":
        _check_expand(cam, w21, x)
    return torch.ops.sfm.expand_cam(cam, w21, x)


@torch.library.custom_op("sfm::reduce_cam", mutates_args=(), device_types="cpu")
def _reduce_cam_op(w21: torch.Tensor, y: torch.Tensor, perm: torch.Tensor, mask: torch.Tensor,
                   n_views: int, seg: torch.Tensor | None = None) -> torch.Tensor:
    """B6 as an operator: the plain version on the CPU, the kernel on the
    card, no other device."""
    return reduce_cam_reference(w21, y, perm, mask, n_views, seg)


@_reduce_cam_op.register_fake
def _(w21, y, perm, mask, n_views, seg=None):
    return w21.new_empty((n_views, w21.shape[1] // 3))


def _check_view(op: str, w21, perm, mask, n_views: int, seg=None) -> None:
    """The W rows and the camera-major view that B6 and B8 walk."""
    O, S = w21.shape[0], perm.shape[0]
    dev = w21.device
    if w21.dim() != 2 or w21.shape[1] not in (21, 30):
        raise ValueError(f"{op}: w21 must be (O, 21) or (O, 30): a camera block of 7 or 10")
    _check(f"{op}: w21", w21, (O, w21.shape[1]), torch.float32, dev)
    _check(f"{op}: perm", perm, (S,), torch.int32, dev)
    _check(f"{op}: mask", mask, (S,), torch.bool, dev)
    if seg is not None:
        _check(f"{op}: seg", seg, (n_views, 2), torch.int32, dev)
    elif n_views < 1 or S % n_views:
        raise ValueError(f"{op}: {S} camera-major slots do not split into {n_views} cameras")


def _check_reduce(w21, y, perm, mask, n_views: int, seg=None) -> None:
    _check_view("reduce_cam", w21, perm, mask, n_views, seg)
    _check("reduce_cam: y", y, (w21.shape[0], 3), torch.float32, w21.device)


@_reduce_cam_op.register_kernel("cuda")
def _(w21, y, perm, mask, n_views, seg=None):
    _check_reduce(w21, y, perm, mask, n_views, seg)
    O, S = w21.shape[0], perm.shape[0]
    dev = w21.device
    nc = w21.shape[1] // 3
    coup = torch.empty((n_views, nc), dtype=torch.float32, device=dev)
    rc = kernels.library().sfm_reduce_cam_w(
        w21.data_ptr(), y.data_ptr(), perm.data_ptr(), mask.data_ptr(),
        None if seg is None else seg.data_ptr(), O, n_views,
        0 if seg is not None else S // n_views, nc, coup.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "sfm_reduce_cam_w")
    reduce_cam.launches += 1
    return coup


def reduce_cam(w21: torch.Tensor, y: torch.Tensor, perm: torch.Tensor, mask: torch.Tensor,
               n_views: int, seg: torch.Tensor | None = None) -> torch.Tensor:
    """coup (V, nc) = per-camera sum of W_o y_o; same result as
    :func:`reduce_cam_reference`, and the same bits on every run (the
    ``sfm::reduce_cam`` operator)."""
    if w21.device.type not in ("cpu", "cuda"):
        raise ValueError(f"reduce_cam: unsupported device {w21.device}")
    if w21.device.type == "cuda":
        _check_reduce(w21, y, perm, mask, n_views, seg)
    return torch.ops.sfm.reduce_cam(w21, y, perm, mask, int(n_views), seg)


@torch.library.custom_op("sfm::cam_diag", mutates_args=(), device_types="cpu")
def _cam_diag_op(w: torch.Tensor, dinv: torch.Tensor, point: torch.Tensor, perm: torch.Tensor,
                 mask: torch.Tensor, n_views: int, seg: torch.Tensor | None = None) -> torch.Tensor:
    """B8 as an operator: the plain version on the CPU, the kernel on the
    card, no other device."""
    return cam_diag_reference(w, dinv, point, perm, mask, n_views, seg)


@_cam_diag_op.register_fake
def _(w, dinv, point, perm, mask, n_views, seg=None):
    nc = w.shape[1] // 3
    return w.new_empty((n_views, nc, nc))


def _check_diag(w, dinv, point, perm, mask, n_views: int, seg=None) -> None:
    _check_view("cam_diag", w, perm, mask, n_views, seg)
    _check("cam_diag: dinv", dinv, (dinv.shape[0], 3, 3), torch.float32, w.device)
    _check("cam_diag: point", point, (w.shape[0],), torch.int32, w.device)


DIAG_PART_SLOTS = 512  # B8's parts a camera: the view's mean run over this, rounded up


@_cam_diag_op.register_kernel("cuda")
def _(w, dinv, point, perm, mask, n_views, seg=None):
    _check_diag(w, dinv, point, perm, mask, n_views, seg)
    O, S, nc = w.shape[0], perm.shape[0], w.shape[1] // 3
    dev = w.device
    parts = max(1, -(-S // (n_views * DIAG_PART_SLOTS)))
    out = torch.empty((n_views, nc, nc), dtype=torch.float32, device=dev)
    part_out = torch.empty((n_views, parts, nc * (nc + 1) // 2), dtype=torch.float32,
                           device=dev) if parts > 1 else None
    rc = kernels.library().sfm_cam_diag_w(
        w.data_ptr(), dinv.data_ptr(), point.data_ptr(), perm.data_ptr(), mask.data_ptr(),
        None if seg is None else seg.data_ptr(), O, dinv.shape[0], n_views,
        0 if seg is not None else S // n_views, nc, parts,
        None if part_out is None else part_out.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(dev),
    )
    kernels.check(rc, "sfm_cam_diag_w")
    cam_diag.launches += 1
    return out


def cam_diag(w: torch.Tensor, dinv: torch.Tensor, point: torch.Tensor, perm: torch.Tensor,
             mask: torch.Tensor, n_views: int, seg: torch.Tensor | None = None) -> torch.Tensor:
    """S (V, nc, nc) = per-camera sum of W_o D^-1_{p(o)} W_o^T; same result
    as :func:`cam_diag_reference`, and the same bits on every run (the
    ``sfm::cam_diag`` operator)."""
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cam_diag: unsupported device {w.device}")
    if w.device.type == "cuda":
        _check_diag(w, dinv, point, perm, mask, n_views, seg)
    return torch.ops.sfm.cam_diag(w, dinv, point, perm, mask, int(n_views), seg)


expand_cam.launches = 0
reduce_cam.launches = 0
cam_diag.launches = 0
