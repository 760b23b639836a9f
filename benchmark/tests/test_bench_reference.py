"""The plain reference's pieces on inputs whose answers are known."""

import dataclasses
import json

import numpy as np
import torch

from benchmark.reference import frame_ba, geometry, global_ba, scene


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


def test_frame_reference_follows_the_program(tiny, monkeypatch):
    """What the per-frame BA of a tiny CPU run receives, solved by the plain
    float64 LM (``frame_ba.assemble``, ``global_ba.solve``), gives the
    program's three costs within 1e-5 relative on the CPU (the program in
    float32: sound runs read about 1e-6), in frames before and after the
    window slides."""
    from structure_from_motion_tpu_torch.config import PipelineConfig
    from structure_from_motion_tpu_torch.models import incremental

    stage, seen = incremental._ba_stage, []

    def recording(st, config):
        entry = {k: getattr(st, k)[0].numpy().copy() for k in frame_ba.FIELDS}
        res = stage(st, config)
        seen.append((entry, res[1][0].double().numpy()))
        return res

    monkeypatch.setattr(incremental, "_ba_stage", recording)
    size = tuple(tiny["frame_size"])
    config = PipelineConfig.from_json(json.dumps(tiny["pipeline"]))
    K, _, _ = scene.path_poses(40, size, 1.4)
    eng = incremental.IncrementalSfM(config, K, seed=7, device="cpu")
    for f in scene.render(7, size, 3, 1.4 * 7 / 40).numpy():
        eng.process_image(f)
    assert len(seen) == 5  # frames 2-6; the window slides at frame 4
    ba = dataclasses.asdict(config.ba)
    for entry, costs in seen:
        arrays = frame_ba.assemble(entry)
        assert arrays["left_out"] == 0 and len(arrays["cam"]) > 100
        truth = global_ba.solve(global_ba.to_problem(arrays, "cpu", torch.float64),
                                config.ba.iterations, ba, "f64")["costs"]
        assert np.abs(costs - truth).max() / truth.min() < 1e-5, (costs, truth)
