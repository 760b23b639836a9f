"""Configuration tree of the PyTorch/CUDA port.

The port's own copy of the dataclasses of
``structure_from_motion_tpu/config.py``: the port imports nothing of the JAX
package. Every field name and default is kept, so that
``PipelineConfig.from_json(other.to_json())`` carries a configuration from
one package to the other and a config file or checkpoint written by one
reads in the other (``tests/test_torch_config.py`` holds the two trees
field by field).

Fields that choose an implementation in the JAX package (``blur_impl``,
``blur_precision``, ``topk``, ``grad_pack``, ``extrema_dtype``,
``extrema_impl``, ``MatcherConfig.impl``, ``assemble_impl``,
``matvec_impl``) are kept for that round trip only. Nothing in the port
reads them: a CPU tensor runs a kernel's plain version, a CUDA tensor
launches the kernel, and the frontend always runs the exact f32 blur and
extremum semantics. ``grad_dtype`` is honoured (gradients stored in bf16).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched-hypothesis RANSAC. ``iteration`` is the hypothesis-batch size;
    it is raised to the statistically required count
    ``log(1 - subset_confidence) / log(1 - sample_confidence ** sample_num)``
    when it is lower."""

    inlier_threshold: float = 1e-3
    subset_confidence: float = 0.99
    sample_confidence: float = 0.75
    sample_num: int = 8
    iteration: int = 300
    seed: int = 0
    # > 0: rank hypotheses on a random subset of this many valid
    # correspondences; the winner is always re-scored on the full set
    score_subset: int = 0

    def required_iterations(self) -> int:
        denom = math.log(1.0 - self.sample_confidence**self.sample_num)
        if denom >= 0.0:
            return self.iteration
        return int(math.ceil(math.log(1.0 - self.subset_confidence) / denom))

    @property
    def num_hypotheses(self) -> int:
        """Hypothesis-batch size (>= the statistically required count)."""
        return max(self.iteration, self.required_iterations())


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg-Marquardt settings of the nonlinear refiners: ``damping``
    is the lambda added to the normal equations, ``iterations`` the step
    count, ``adaptive`` switches on lambda up/down adaptation."""

    damping: float = 5.0
    iterations: int = 100
    adaptive: bool = False
    damping_up: float = 2.0
    damping_down: float = 0.5


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """On-device feature detection and description: a DoG detector with a
    gradient-histogram descriptor. ``max_keypoints`` fixes the per-view key
    capacity, so every downstream shape is fixed."""

    detector: str = "dog"  # "dog" or "harris"
    max_keypoints: int = 2048
    num_octaves: int = 4
    # detect octave -1 on a 2x bilinear-upsampled image: fine keypoints
    # localise to half-pixel precision at the cost of one 4x-sized level
    upsample_first_octave: bool = True
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.015
    edge_threshold: float = 10.0
    descriptor_dim: int = 128
    patch_size: int = 16
    blur_impl: str = "matmul"  # round trip only (module docstring)
    blur_precision: str = "high"  # round trip only
    topk: str = "exact"  # round trip only: the port's top-k is exact
    # block-local pre-reduction before the per-octave top-k: keep only the
    # strongest candidate per (scale layer, B x B pixel block); 0 disables.
    # B = 8 takes the fused kernel; another B > 1 reduces the response map
    topk_block: int = 8
    grad_pack: str = "quad"  # round trip only
    grad_dtype: str = "bf16"  # gradient storage: "bf16" or "f32"
    extrema_dtype: str = "bf16"  # round trip only
    extrema_impl: str = "auto"  # round trip only
    # orientation/descriptor sampling: "rotated" (two 16x16 sample passes:
    # orientation window, then the rotated descriptor grid) or "shared" (ONE
    # unrotated shared_grid x shared_grid grid at shared_grid_step sigma
    # serving both)
    sampling: str = "rotated"
    shared_grid: int = 18
    shared_grid_step: float = 0.95


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching: a fused L2 top-2 search (kernel B3) with Lowe's
    ratio test and per-query dedup."""

    ratio: float = 0.7
    cross_check: bool = False  # mutual nearest neighbours only
    impl: str = "auto"  # round trip only
    metric: str = "l2"  # "l2" or "hamming" (+-1 codes)
    use_fundamental_gate: bool = False
    # thresholds are pixel Sampson distances (ops/epipolar.py)
    gate_ransac: RansacConfig = dataclasses.field(
        default_factory=lambda: RansacConfig(inlier_threshold=3.0, iteration=200)
    )


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment: Schur-complement LM over [C(3), q(4)] camera
    blocks and XYZ point blocks (``ops/ba.py``)."""

    iterations: int = 3
    damping: float = 5.0  # initial lambda
    # adaptive trust region: accepted steps shrink lambda, rejected steps
    # are discarded and grow it
    adaptive: bool = True
    damping_down: float = 0.3
    damping_up: float = 4.0
    min_damping: float = 1e-8
    max_damping: float = 1e8
    huber_delta: float = 0.0  # 0 disables the robust loss
    fix_first_camera_gauge: bool = False
    pcg_fallback_cameras: int = 256  # from this many cameras, solve S by PCG
    pcg_iterations: int = 64
    assemble_impl: str = "auto"  # round trip only
    matvec_impl: str = "auto"  # round trip only
    # observation layout inside the LM loop: "ell" packs the stream once per
    # BA call so point m owns ell_rows slots; "tiered" takes a stream packed
    # by models/global_ba.pack_tiered; "csr" sorts the stream by point id
    # (segment sums; any other value)
    obs_layout: str = "ell"
    # slots per point in the ELL table; 0 = the camera-slot count V (at most
    # one observation per (view, point) pair, so V never drops any)
    ell_rows: int = 0
    ell_tail: int = 0  # hybrid-ELL spill capacity (the sharded global solve sets it)
    # > 0: camera-axis reductions run over a camera-major view with this
    # many slots per camera; must be >= the busiest camera's observation
    # count or the excess drops. 0 = sized by the PCG path when it needs one
    cam_rows: int = 0
    # obs_layout="tiered": ((n_points, rows), ...) in descending track
    # length; tier t covers the next n_t points with rows_t slots each
    tiers: tuple = ()


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed capacities of the track store."""

    max_views: int = 16
    max_keypoints: int = 2048
    max_points: int = 16384
    max_observations: int = 65536


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config: one object wires the full incremental pipeline."""

    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    # F-gated matching on by default
    matcher: MatcherConfig = dataclasses.field(
        default_factory=lambda: MatcherConfig(
            ratio=0.75,
            use_fundamental_gate=True,
            gate_ransac=RansacConfig(inlier_threshold=3.0, iteration=128),
        )
    )
    # RANSAC for the fundamental matrix; pixel Sampson threshold
    fundamental_ransac: RansacConfig = dataclasses.field(
        default_factory=lambda: RansacConfig(inlier_threshold=2.0, iteration=300)
    )
    # RANSAC for PnP; pixel reprojection threshold; hypotheses are ranked
    # against a 2048-point sample of the whole-map candidate set
    pnp_ransac: RansacConfig = dataclasses.field(
        default_factory=lambda: RansacConfig(
            inlier_threshold=8.0, sample_num=6, iteration=1024, score_subset=2048,
        )
    )
    pnp_lm: LMConfig = dataclasses.field(
        default_factory=lambda: LMConfig(damping=5.0, iterations=100)
    )
    triangulation_lm: LMConfig = dataclasses.field(
        default_factory=lambda: LMConfig(damping=5.0, iterations=50)
    )
    # Huber delta is in normalised camera units (0.01 ~ 5.7 px at f = 570)
    ba: BAConfig = dataclasses.field(
        default_factory=lambda: BAConfig(huber_delta=0.01)
    )
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    window_size: int = 10
    # past window_size frames: "stop" ignores them; "slide" evicts the
    # oldest view (archives its pose, drops its observations, compacts the
    # map) and keeps going
    window_mode: str = "stop"
    # map admission: max per-view reprojection error of a new point (px)
    triangulation_max_error_px: float = 8.0
    # map admission: minimum ray (parallax) angle of a new point (degrees)
    min_parallax_deg: float = 2.0
    # after every BA run, observations with reprojection error above this
    # (or negative depth) are dropped and points left with < 2 observations
    # die; 0 disables
    prune_max_error_px: float = 16.0
    # keyframe gate: admit a frame only when its median match displacement
    # against the last accepted frame is at least this many pixels; 0 = off
    keyframe_min_flow_px: float = 0.0
    # lens distortion (k1, k2[, p1, p2[, k3]]), undistorted at ingest; () = pinhole
    distortion: tuple = ()
    # > 1: the per-frame BA sharded over that many ranks (parallel/; torchrun)
    ba_num_shards: int = 1
    # per-frame BA runs on the smallest power-of-2 prefix bucket that holds
    # the live counts (one host read per stage picks it)
    ba_bucketing: bool = True
    # the same for the PnP and triangulation candidate sets
    localize_bucketing: bool = True

    # -- (de)serialisation -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        return _from_dict(cls, json.loads(text))


_DATACLASSES = {
    c.__name__: c
    for c in (RansacConfig, LMConfig, FrontendConfig, MatcherConfig, BAConfig,
              CapacityConfig, PipelineConfig)
}


def _from_dict(klass: Any, data: Any) -> Any:
    """Build ``klass`` from parsed JSON; unknown keys are ignored, and lists
    become tuples (JSON has none; the configs stay hashable)."""
    kwargs = {}
    for f in dataclasses.fields(klass):
        if f.name not in data:
            continue
        value = data[f.name]
        target = _DATACLASSES.get(f.type) if isinstance(f.type, str) else None
        if target is not None:
            kwargs[f.name] = _from_dict(target, value)
        elif isinstance(value, list):
            kwargs[f.name] = tuple(value)
        else:
            kwargs[f.name] = value
    return klass(**kwargs)
