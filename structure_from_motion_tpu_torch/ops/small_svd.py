"""Kernel B7: the frame path's small SVDs without a host read.

No Pallas kernel of the JAX package stands behind this one: the JAX package
leaves its SVDs to XLA, whose device SVD returns without the host. On the
card ``torch.linalg.svd`` reads cuSOLVER's status on the host after every
call, so each of a frame's small SVDs would stop the host and keep the
stretch around it out of a CUDA graph. ``csrc/svd.cu`` computes, with every
decision on the device:

* :func:`nullspace` (``ops/linalg.nullspace``): the unit right singular
  vector of the smallest singular value of every ``(M, N)`` matrix of a
  batch, N = 4 (triangulation rows), 9 (eight-point fits and refits) or
  12 (PnP DLT), any M;
* :func:`svd3`: the full SVD ``(U, S, Vh)`` of every 3 x 3 matrix (the
  rank-2 projection of F, the rotation of the DLT).

Both return the sign rule of :func:`sign_rule`; the plain version is
``torch.linalg.svd`` with that rule. Everything goes through the
``sfm::small_svd`` operator (so an exported program keeps it): its CPU
implementation is the plain version, its CUDA one the kernel, and a vmap
rule lets ``utils/control.lane_map`` batch it.
"""

from __future__ import annotations

import collections

import torch

from structure_from_motion_tpu_torch import kernels

ONE_BLOCK = 2048  # rows the kernel reduces in one block (kOneBlock)
CHUNK = 1024  # rows a block takes when several share a matrix (kChunkRows)
MAX_ROWS = 32  # rows the Jacobi kernel takes directly
NULL_COLUMNS = (4, 9, 12)


def sign_rule(vh: torch.Tensor, u: torch.Tensor | None = None):
    """Right singular vectors ``vh`` (..., k, N) (one a row) with each
    row's largest component in magnitude (the first among equals)
    positive; ``u`` (..., M, k), when given, takes the same sign a column.
    The products ``u_i s_i v_i`` keep their bits (a sign flip is exact)."""
    big = vh.abs().argmax(-1, keepdim=True)
    sign = torch.where(torch.gather(vh, -1, big) < 0, -1.0, 1.0).to(vh.dtype)
    if u is None:
        return vh * sign
    return vh * sign, u * sign.transpose(-1, -2)


def small_svd_reference(A: torch.Tensor, null_only: bool):
    """Plain version. ``null_only``: ``(U, S, Vh)`` with U and S empty and
    Vh (..., 1, N) the null vector (``torch.linalg.svd``'s last right
    singular vector, of the full basis when M < N); else the full SVD of
    (..., 3, 3) matrices. The sign rule of :func:`sign_rule` either way."""
    lead = A.shape[:-2]
    if null_only:
        _, _, vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
        empty = A.new_empty(lead + (0,))
        return empty, empty.clone(), sign_rule(vh[..., -1:, :])
    u, s, vh = torch.linalg.svd(A)
    vh, u = sign_rule(vh, u)
    return u.contiguous(), s, vh.contiguous()  # row-major, as the kernel writes them


def _scratch_floats(batch: int, M: int, N: int) -> int:
    """Floats of the kernel's scratch (``csrc/svd.cu``): a matrix of more
    than :data:`ONE_BLOCK` rows is reduced by blocks of :data:`CHUNK` rows
    in one launch, which keep each block's N x N R (``batch * blocks * N *
    N`` floats) and its scale exponent (an int a block), then one int
    counter a matrix."""
    if M <= ONE_BLOCK:
        return 0
    blocks = -(-M // CHUNK)
    return batch * blocks * (N * N + 1) + batch


def _check(A: torch.Tensor, null_only: bool) -> None:
    if A.dtype != torch.float32 or A.dim() < 2:
        raise ValueError(f"small_svd: need a float32 (..., M, N) batch, got {A.dtype} "
                         f"{tuple(A.shape)}")
    M, N = A.shape[-2:]
    if null_only and N not in NULL_COLUMNS:
        raise ValueError(f"small_svd: the kernel's null vectors take N in {NULL_COLUMNS} "
                         f"columns, got {N}")
    if not null_only and (M, N) != (3, 3):
        raise ValueError(f"small_svd: the kernel's full SVD takes 3 x 3 matrices, got {M} x {N}")


@torch.library.custom_op("sfm::small_svd", mutates_args=(), device_types="cpu")
def _small_svd_op(A: torch.Tensor, null_only: bool) -> tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """B7 as an operator: the plain version on the CPU, the kernel on the
    card, no other device."""
    return small_svd_reference(A, null_only)


@_small_svd_op.register_fake
def _(A, null_only):
    lead, (M, N) = A.shape[:-2], A.shape[-2:]
    if null_only:
        return A.new_empty(lead + (0,)), A.new_empty(lead + (0,)), A.new_empty(lead + (1, N))
    k = min(M, N)
    return A.new_empty(lead + (M, k)), A.new_empty(lead + (k,)), A.new_empty(lead + (k, N))


@_small_svd_op.register_kernel("cuda")
def _(A, null_only):
    _check(A, null_only)
    lead, (M, N) = A.shape[:-2], A.shape[-2:]
    flat = A.reshape((-1, M, N)).contiguous()
    batch = flat.shape[0]
    dev = A.device
    if null_only:
        U = torch.empty(lead + (0,), dtype=A.dtype, device=dev)
        S = torch.empty(lead + (0,), dtype=A.dtype, device=dev)
        Vh = torch.empty(lead + (1, N), dtype=A.dtype, device=dev)
        floats = _scratch_floats(batch, M, N)
    else:
        U = torch.empty(lead + (3, 3), dtype=A.dtype, device=dev)
        S = torch.empty(lead + (3,), dtype=A.dtype, device=dev)
        Vh = torch.empty(lead + (3, 3), dtype=A.dtype, device=dev)
        floats = 0
    if batch == 0:
        return U, S, Vh
    scratch = torch.empty((floats,), dtype=A.dtype, device=dev) if floats else None
    rc = kernels.library().sfm_small_svd(
        flat.data_ptr(), batch, M, N, 0 if null_only else 1,
        scratch.data_ptr() if floats else None, floats, U.data_ptr() if not null_only else None,
        S.data_ptr() if not null_only else None, Vh.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "sfm_small_svd")
    _COUNTED.launches += 1
    _COUNTED.by_shape[(batch, M, N, not null_only)] += 1
    return U, S, Vh


def _vmap(info, in_dims, A, null_only):
    """A vmapped call is one call on the batch with the mapped axis first."""
    if in_dims[0] is not None:
        A = A.movedim(in_dims[0], 0)
    return torch.ops.sfm.small_svd(A, null_only), (0, 0, 0)


_small_svd_op.register_vmap(_vmap)


def small_svd(A: torch.Tensor, null_only: bool = False):
    """``(U, S, Vh)`` of every matrix of a (..., M, N) batch as
    :func:`small_svd_reference` gives them (the ``sfm::small_svd``
    operator): on a CUDA tensor the kernel, which raises on a shape it
    does not take."""
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"small_svd: unsupported device {A.device}")
    if A.device.type == "cuda":
        _check(A, null_only)
    return torch.ops.sfm.small_svd(A, bool(null_only))


def nullspace(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector (right singular vector of the smallest singular
    value, largest component positive) of each matrix of a (..., M, N)
    batch -> (..., N)."""
    return small_svd(A, null_only=True)[2][..., 0, :]


def svd3(A: torch.Tensor):
    """``torch.linalg.svd`` of a (..., 3, 3) batch -> (U, S, Vh), under the
    sign rule of :func:`sign_rule`."""
    return small_svd(A, null_only=False)


small_svd.launches = 0
small_svd.by_shape = collections.Counter()  # (batch, M, N, full) -> launches
_COUNTED = small_svd  # the counts stay on this function if a caller swaps the name
