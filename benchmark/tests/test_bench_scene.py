"""The benchmark's torch renderer against the port's numpy original."""

import numpy as np
import pytest

from benchmark.reference import scene


@pytest.mark.parametrize("n,size,loops", [(200, (960, 1280), 14.0), (1000, (480, 640), 10.0),
                                          (7, (96, 128), 0.49)])
def test_poses_equal_the_original(n, size, loops):
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_poses

    K, C, R = scene.path_poses(n, size, loops)
    K0, C0, R0 = synthetic_scene_poses(n, size, loops=loops)
    assert np.array_equal(K, K0) and np.array_equal(C, C0) and np.array_equal(R, R0)


def test_frames_equal_the_original():
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence

    imgs = synthetic_scene_sequence(5, (72, 96), seed=2 ** 31 + 5, loops=0.35)[0]
    scene.PIXELS_A_BATCH, saved = 72 * 96 * 2, scene.PIXELS_A_BATCH  # several batches
    try:
        mine = scene.render(5, (72, 96), 2 ** 31 + 5, 0.35).numpy()
    finally:
        scene.PIXELS_A_BATCH = saved
    assert np.array_equal(mine, imgs)


def test_the_ring_is_periodic():
    """200 frames over 14 turns: the frame after the last is the first."""
    _, C, _ = scene.path_poses(201, (960, 1280), 14.0 * 201 / 200)
    assert np.allclose(C[200], C[0], atol=1e-9)
