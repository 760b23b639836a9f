"""Batched incremental SfM: B sequences reconstructed in lockstep (port of
``structure_from_motion_tpu/models/batched.py``).

The JAX package ``vmap``s its fused frame step over a leading lane axis.
Here every tensor of the :class:`~.tracks.SfMState` carries that axis
((B, V, K, 2) keypoints, (B,) counters, ...), and the frame step is the one
``models/incremental.py`` runs for a single sequence, written for a lane
stack: every kernel launches ONCE a stage for the whole batch (B1 and B2
on the (B, H, W) frames, B3 on each lane's prior views against its own new
view, B4 on every lane's BA observations), and the frame branch and the
localisation and BA bucket sizes are taken once for the batch, from the
LARGEST live count across lanes, on the device (see that module for the LM
loops and the draws). A steady frame of the batch is one CUDA graph replay
on the card, as a single engine's is. Lane b draws from the generators of ``IncrementalSfM(seed=seed_b)``,
so with the same seeds and buckets a lane draws what the single engine
draws.

Slide mode evicts the oldest view of every lane in lockstep and archives
the evicted poses per lane. Refused, as in the JAX package: sharded BA and
the keyframe gate (lanes would admit different frames).
"""

from __future__ import annotations

import numpy as np
import torch

from structure_from_motion_tpu_torch.config import PipelineConfig
from structure_from_motion_tpu_torch.device import fetch, to_device
from structure_from_motion_tpu_torch.models import tracks
from structure_from_motion_tpu_torch.models.incremental import LazyDraws, _frame_step
from structure_from_motion_tpu_torch.models.tracks import EvictionArchive, SfMState
from structure_from_motion_tpu_torch.ops.features import detect_and_describe
from structure_from_motion_tpu_torch.utils.rotations import quat_to_rotation


class BatchedIncrementalSfM:
    """B independent reconstructions advanced in lockstep: one set of kernel
    launches a stage for the whole batch.

    ``K`` is (3, 3) for every lane, (B, 3, 3) one a lane, or (B, V, 3, 3)
    one a lane and view. ``seed`` is an int (lane b gets ``seed + b``) or B
    ints; lane b draws the generators of ``IncrementalSfM(seed=seed_b)``.
    ``device`` defaults to ``"cuda"`` (the hand-written kernels; it raises
    without a card); ``"cpu"`` runs their plain versions."""

    def __init__(self, config: PipelineConfig, K, batch: int, frontend: str = "native",
                 seed=0, *, device="cuda"):
        if config.frontend.max_keypoints != config.capacity.max_keypoints:
            raise ValueError("frontend.max_keypoints must equal capacity.max_keypoints")
        if config.ba_num_shards > 1:
            raise NotImplementedError(
                "BatchedIncrementalSfM does not support ba_num_shards > 1; use the "
                "single-sequence IncrementalSfM for distributed BA")
        if config.keyframe_min_flow_px > 0:
            raise NotImplementedError(
                "keyframe selection is per-lane data-dependent (lanes would admit different "
                "frames and fall out of lockstep); use the single-sequence IncrementalSfM "
                "for keyframed video")
        self.config = config
        self.batch = batch
        self.frontend = frontend
        self.device = torch.device(device)
        V = config.capacity.max_views
        K = np.asarray(K, np.float32)
        if K.ndim == 2:
            K = np.broadcast_to(K, (batch, V, 3, 3))
        elif K.ndim == 3:
            K = np.broadcast_to(K[:, None], (batch, V, 3, 3))
        if K.shape != (batch, V, 3, 3):
            raise ValueError(f"K must be (3, 3), ({batch}, 3, 3) or ({batch}, {V}, 3, 3); "
                             f"got {K.shape}")
        single = tracks.init_state(config.capacity, np.eye(3, dtype=np.float32),
                                   desc_dim=config.frontend.descriptor_dim, device=self.device)
        self.state = SfMState(*(t.expand((batch,) + t.shape).clone() for t in single))._replace(
            K=torch.as_tensor(np.ascontiguousarray(K), device=self.device))
        seeds = np.arange(seed, seed + batch) if np.ndim(seed) == 0 else np.asarray(seed)
        if seeds.shape != (batch,):
            raise ValueError(f"need one seed per lane; got {seeds.shape}")
        self.seeds = [int(s) for s in seeds]
        self._frame = 0
        self._window = min(V, config.window_size)
        # slide mode's evicted views, oldest first: EvictionRecords of (B, ...)
        # host arrays, each copied in the background and read at first use
        self._archive = EvictionArchive()
        self._graphs: dict = {}  # the frame's CUDA graphs (``utils/control.graphed``)

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        return to_device(a, self.state.points.device, dtype)

    def _begin_frame(self, v: int):
        """The slot of frame v, or None past the window in "stop" mode; in
        "slide" mode every lane evicts its oldest view first."""
        if v < self._window:
            return v
        if self.config.window_mode != "slide":
            return None
        self.state, rec = tracks.evict_oldest_view(self.state)
        self._archive.append_device(rec)
        return self._window - 1

    def _step(self, frame) -> dict:
        """The frame step on (B, H, W) images or the lanes' (xy, desc, valid)."""
        v = self._frame
        slot = self._begin_frame(v)
        if slot is None:
            return {"skipped": True, "frame": v}
        draws = LazyDraws(self.seeds, v, self.state.points.device)
        self.state, info = _frame_step(self.state, slot, draws, frame, self.config, self._graphs)
        self._frame = v + 1
        info = fetch(info)  # one grouped copy and one wait
        info["frame"] = v
        return info

    def detect(self, imgs):
        """The frontend alone on (B, H, W) frames: one launch of each kernel
        a stage for every lane."""
        return detect_and_describe(self._to_device(imgs), self.config.frontend)

    def process_images(self, imgs) -> dict:
        """``imgs``: (B, H, W), frame t of every sequence."""
        if self.frontend != "native":
            raise RuntimeError("process_images requires the native frontend")
        return self._step(self._to_device(imgs))

    def process_features(self, xy, desc, valid) -> dict:
        """(B, K, 2), (B, K, D), (B, K) features of frame t of every lane."""
        return self._step((self._to_device(xy, torch.float32),
                           self._to_device(desc, torch.float32),
                           self._to_device(valid, torch.bool)))

    # -- results -------------------------------------------------------------
    def lane_state(self, b: int) -> SfMState:
        return tracks.lane_state(self.state, b)

    def reprojection_error(self) -> np.ndarray:
        """(B,) mean pixel reprojection error of each lane."""
        return tracks.reprojection_error(self.state).cpu().numpy()

    def poses(self):
        """(locs (B, F, 3), rots (B, F, 3, 3)) for every processed frame of
        every lane: the archived views, then the live window."""
        n = min(self._frame, self._window)
        C = self.state.cam_C[:, :n].cpu().numpy()
        R = quat_to_rotation(self.state.cam_q[:, :n]).cpu().numpy()
        if self._archive:
            Ca = np.stack([r.C for r in self._archive], axis=1)
            qa = torch.as_tensor(np.stack([r.q for r in self._archive], axis=1))
            C = np.concatenate([Ca, C], axis=1)
            R = np.concatenate([quat_to_rotation(qa).numpy(), R], axis=1)
        return C, R

    def map_points(self, b: int) -> np.ndarray:
        return self.state.points[b][self.state.pt_valid[b]].cpu().numpy()
