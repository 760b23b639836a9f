"""The plain reference's pieces on inputs whose answers are known."""

import numpy as np
import torch

from benchmark.reference import geometry, global_ba


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.1415926],
                     dtype=torch.float32)
    got = global_ba._tf32(x)
    assert got[0] == 1.0 + 2.0 ** -10  # representable
    assert got[1] == 1.0  # a tie goes to the even neighbour
    assert got[2] == 1.0 + 2 * 2.0 ** -10  # a tie goes to the even neighbour
    assert abs(float(got[3]) + 3.1415926) < 2.0 ** -9 and got[3] != x[3]


def test_alignment_undoes_a_similarity():
    rng = np.random.default_rng(0)
    truth = rng.normal(size=(50, 3))
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R *= np.sign(np.linalg.det(R))
    est = 0.37 * truth @ R.T + np.array([1.0, -2.0, 0.5])
    assert geometry.aligned_errors(est, truth).max() < 1e-12
