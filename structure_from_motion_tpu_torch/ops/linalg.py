"""Small batched linear algebra (port of ``structure_from_motion_tpu/ops/linalg.py``).

Closed forms for 3x3 systems keep the tiny fixed-size solves elementwise;
null vectors go to kernel B7 (``ops/small_svd.py``) on the card, Cholesky
and small dense solves to ``torch.linalg``, as the JAX package leaves them
to XLA; :func:`pcg_solve` is the matrix-free
solver of the large reduced camera systems. The JAX package's
accelerator-only null vector and polar factor (``nullspace_gram``,
``polar_rotation_3x3``) are not ported: an SVD is more accurate
(``ops/pnp.py``).
The ``*_ex`` variants are used so that no solve synchronises the device to
check for a singular matrix.
"""

from __future__ import annotations

import functools

import torch

from structure_from_motion_tpu_torch.ops import small_svd
from structure_from_motion_tpu_torch.utils import profiling
from structure_from_motion_tpu_torch.utils.control import masked_loop, reads_named, unconditional


def floor_abs(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` with magnitudes below ``eps`` replaced by ``+-eps`` (sign of x,
    +eps at 0) — the JAX package's determinant/depth floor."""
    return torch.where(x.abs() < eps, torch.where(x < 0, -eps, eps), x)


def nullspace(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector (right-singular vector of the smallest singular value,
    its largest component positive) of each matrix in a ``(..., M, N)``
    batch -> ``(..., N)``: kernel B7 on the card (no host read), the SVD on
    the CPU (``ops/small_svd.py``)."""
    return small_svd.nullspace(A)


def det3x3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` batches (closed form)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form adjugate inverse of ``(..., 3, 3)`` batches. The
    determinant is floored at +-``eps``, so a singular block gives a huge
    but finite inverse (callers rely on that, e.g. the subpixel fit)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = floor_abs(a * co00 + b * co10 + c * co20, eps)
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _substitute(b: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``cholesky_solve`` of every system, one call a system: torch sends a
    stack of several to MAGMA's batched solve, which no CUDA graph capture
    takes, and one system to cuSOLVER's."""
    N = L.shape[-1]
    Ls, bs = L.reshape(-1, N, N), b.reshape(-1, N, 1)
    if Ls.shape[0] == 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cat([torch.cholesky_solve(bs[i:i + 1], Ls[i:i + 1])
                      for i in range(Ls.shape[0])]).reshape(b.shape)


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve symmetric positive-definite systems ``(..., N, N) x = (..., N)``
    by Cholesky. cuSOLVER's substitution allocates in the stream as it
    runs, which a conditional body of a CUDA graph may not hold: in a
    capture it runs outside the bucket switch's IF body around it
    (``utils/control.unconditional``)."""
    L, _ = torch.linalg.cholesky_ex(A)
    return unconditional(_substitute, b, L)


# CG iterations between two host reads of the stop test, at most (the
# 500-camera solve takes 6 to 64, the cap, a call: PERF.md)
CG_CHUNK = 8


def _identity(r, *_):
    return r


def _pcg_step(active, x, r, p, rz, count, stop, *operands, matvec, precond):
    """One CG iteration where ``active``; a stopped solve keeps its state."""
    Ap = matvec(p, *operands)
    denom = (p * Ap).sum()
    alpha = torch.where(denom.abs() > 0, rz / denom, 0.0)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    z = precond(r_new, *operands)
    rz_new = (r_new * z).sum()
    beta = torch.where(rz.abs() > 0, rz_new / rz, 0.0)
    p_new = z + beta * p
    rz = torch.where(active, rz_new, rz)
    return (active & (rz.abs() > stop), torch.where(active, x_new, x),
            torch.where(active, r_new, r), torch.where(active, p_new, p), rz, count + active)


def pcg_solve(matvec, b: torch.Tensor, iterations: int, rtol: float = 1e-6, precond=None,
              cg_iters: list | None = None, operands: tuple = (),
              capture: bool = True) -> torch.Tensor:
    """Matrix-free preconditioned conjugate gradients with early exit.

    ``matvec(x, *operands)`` maps ``x -> A x``; ``precond(r, *operands)``
    applies an approximate inverse to a residual (e.g. block-Jacobi 7x7
    inverses). The loop stops when ``|r.z| <= rtol**2 |r0.z0|`` or after
    ``iterations`` steps, and returns the iterate the JAX package's
    ``while_loop`` returns. The stop test runs on the device
    (:func:`~..utils.control.masked_loop`): one host read every
    :data:`CG_CHUNK` iterations, each chunk one CUDA graph replay on the
    card, so ``matvec`` and ``precond`` read no tensor but their
    arguments there. ``capture=False`` runs the chunks eagerly (a matvec
    that all-reduces through gloo cannot be captured). ``cg_iters``, when
    given, receives the number of iterations run (one host read). The
    spans (``utils/profiling``): ``pcg.read``, each read of the stop mask;
    ``pcg.count_read``, the read of the count.
    """
    apply_m = precond if precond is not None else _identity
    z = apply_m(b, *operands)
    rz = (b * z).sum()
    stop = rtol**2 * rz.abs()
    count = torch.zeros((), dtype=torch.long, device=b.device)
    step = functools.partial(_pcg_step, matvec=matvec, precond=apply_m)
    with reads_named("pcg.read"):
        _, x, _, _, _, count = masked_loop(iterations, CG_CHUNK, step,
                                           (rz.abs() > stop, torch.zeros_like(b), b, z, rz,
                                            count), stop, *operands, capture=capture)
    if cg_iters is not None:
        with profiling.span("pcg.count_read"):
            cg_iters.append(int(count))
    return x
