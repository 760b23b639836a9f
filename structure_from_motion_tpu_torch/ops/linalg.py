"""Small batched linear algebra (port of ``structure_from_motion_tpu/ops/linalg.py``).

Closed forms for 3x3 systems keep the tiny fixed-size solves elementwise;
null vectors, Cholesky and small dense solves go to ``torch.linalg``, as the
JAX package leaves them to XLA; :func:`pcg_solve` is the matrix-free
solver of the large reduced camera systems. The JAX package's
accelerator-only null vector and polar factor (``nullspace_gram``,
``polar_rotation_3x3``) are not ported: on the H100 the SVD is faster and
more accurate (``ops/pnp.py``).
The ``*_ex`` variants are used so that no solve synchronises the device to
check for a singular matrix.
"""

from __future__ import annotations

import torch


def floor_abs(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` with magnitudes below ``eps`` replaced by ``+-eps`` (sign of x,
    +eps at 0) — the JAX package's determinant/depth floor."""
    return torch.where(x.abs() < eps, torch.where(x < 0, -eps, eps), x)


def nullspace(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector (right-singular vector of the smallest singular value)
    of each matrix in a ``(..., M, N)`` batch -> ``(..., N)``."""
    wide = A.shape[-2] < A.shape[-1]
    _, _, vh = torch.linalg.svd(A, full_matrices=wide)
    return vh[..., -1, :]


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


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve symmetric positive-definite systems ``(..., N, N) x = (..., N)``
    by Cholesky."""
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def pcg_solve(matvec, b: torch.Tensor, iterations: int, rtol: float = 1e-6, precond=None,
              cg_iters: list | None = None) -> torch.Tensor:
    """Matrix-free preconditioned conjugate gradients with early exit.

    ``matvec`` maps ``x -> A x``; ``precond`` applies an approximate inverse
    to a residual (e.g. block-Jacobi 7x7 inverses). The loop stops when
    ``|r.z| <= rtol**2 |r0.z0|`` or after ``iterations`` steps, and returns
    the iterate the JAX package's ``while_loop`` returns. The stop test is
    one host read per iteration. ``cg_iters``, when given, receives the
    number of iterations run.
    """
    apply_m = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b)
    r = b
    z = apply_m(b)
    p = z
    rz = (b * z).sum()
    stop = rtol**2 * rz.abs()
    i = 0
    while i < iterations and bool(rz.abs() > stop):
        Ap = matvec(p)
        denom = (p * Ap).sum()
        alpha = torch.where(denom.abs() > 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = (r * z).sum()
        beta = torch.where(rz.abs() > 0, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        i += 1
    if cg_iters is not None:
        cg_iters.append(i)
    return x
