"""Speed-of-light (roofline) accounting for the matcher and one BA LM
iteration (port of ``structure_from_motion_tpu/utils/roofline.py``).

The FLOP and device-memory byte models are the JAX package's, count for
count; the peaks are one NVIDIA H100 SXM's at its full 700 W limit (NVIDIA's
data sheet, dense rates without sparsity), the same figures
``chip_smoke.py`` holds every kernel's bound to:

    sol_seconds = max(flops / peak_flops, bytes / peak_bandwidth)
    sol_pct     = 100 * sol_seconds / measured_seconds

The models price matmul FLOPs and streaming bytes only; top-k reductions
and row gathers are not priced, so a low percentage points at data
movement, not at arithmetic.
"""

from __future__ import annotations

H100_F32_FLOPS = 67e12  # CUDA cores
H100_TF32_FLOPS = 495e12  # tensor cores
H100_HBM_BYTES_PER_S = 3.35e12  # HBM3


def matcher_model(n_ref: int, n_que: int, dim: int, bytes_per_el: int = 4):
    """(flops, bytes) of one brute-force match: the (Nr, D) x (D, Nq)
    distance product and the top-2 reduction's streaming traffic."""
    flops = 2.0 * n_ref * n_que * dim
    bytes_ = bytes_per_el * (
        n_ref * dim + n_que * dim  # descriptor reads
        + n_ref * n_que  # distance matrix write or fused top-2 read-equivalent
        + 3 * n_ref  # d1/d2/argmax outputs
    )
    return flops, bytes_


def ba_iteration_model(
    n_views: int, n_points: int, n_obs: int, dense_schur: bool = True,
    pcg_iters: int = 8, bytes_per_el: int = 4, ell_rows: int = 0,
    adaptive: bool = True,
):
    """(flops, bytes) of one Schur-LM iteration: assembly and block
    products, the Schur reduction (dense coupling build and contraction, or
    PCG matvecs), the reduced solve, back-substitution and (``adaptive``)
    the accept test's residual pass. ``ell_rows`` > 0 prices the padded ELL
    stream (``n_points * ell_rows`` slots)."""
    V, M, O, b = n_views, n_points, n_obs, bytes_per_el
    if ell_rows:
        O = M * ell_rows  # padded slot count: invalid slots still stream
    flops = O * (300.0 + 360.0)  # assembly + block products
    # assemble: inputs (cam, uv, valid, C_o, q_o, X_o = 14) + outputs
    # (DtD 9, W 21, b_p 3) + camera gather outputs (C, q = 7)
    bytes_ = b * O * (14 + 9 + 21 + 3 + 7)
    # point reductions read DtD/b_p once more; D, Dinv, b_p at point grain
    bytes_ += b * O * (9 + 3) + b * M * (9 + 9 + 3)
    if adaptive:
        bytes_ += b * O * 14
        flops += O * 300.0
    if dense_schur:
        flops += M * V * V * (21 * 3 + 21 * 7)  # G Dinv G^T contraction
        if ell_rows:
            flops += M * ell_rows * V * 21 * 2.0
            bytes_ += b * (M * ell_rows * V) * 2 + b * (M * V * 21) * 3
        else:
            bytes_ += b * (M * V * 21) * 3
        flops += ((7 * V) ** 3) / 3.0  # dense solve
    else:
        per_cg = O * (2 * 42 + 2 * 21) + M * 9 + V * 49
        flops += pcg_iters * per_cg
        bytes_ += b * pcg_iters * (O * (21 + 7 + 3 + 3 + V) + M * 6)
    flops += O * 42 + M * 9  # back-substitution
    bytes_ += b * O * (21 + 7 + 3) + b * M * 6
    return flops, bytes_


def speed_of_light_seconds(flops: float, hbm_bytes: float, peak_flops: float = H100_F32_FLOPS,
                           peak_bw: float = H100_HBM_BYTES_PER_S) -> float:
    return max(flops / peak_flops, hbm_bytes / peak_bw)


def sol_pct(measured_seconds: float, flops: float, hbm_bytes: float,
            peak_flops: float = H100_F32_FLOPS) -> float:
    """Percent of the (optimistic) roofline the measured time achieves."""
    return 100.0 * speed_of_light_seconds(flops, hbm_bytes, peak_flops) / measured_seconds
