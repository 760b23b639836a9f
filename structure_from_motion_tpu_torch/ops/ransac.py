"""Hypothesis-batch RANSAC (port of ``structure_from_motion_tpu/ops/ransac.py``).

The hypothesis index sets are an INPUT of :func:`ransac`: the main path
draws them with :func:`sample_index_sets` from a ``torch.Generator`` (or
takes uniforms drawn beforehand, as an exported frame program does), and
the tests hand in the JAX package's own draws (``jax.random`` cannot be
reproduced in torch). Everything may carry leading batch axes (the F-gate
runs one RANSAC per prior view in one batch).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from structure_from_motion_tpu_torch.device import stable_topk


class RansacResult(NamedTuple):
    model: tuple  # best model parameters (each (..., ...) without the hypothesis axis)
    inliers: torch.Tensor  # (..., N) bool
    num_inliers: torch.Tensor  # (...,) int
    best_index: torch.Tensor  # (...,) index of the winning hypothesis


def draw_uniform(gen, shape: tuple, device) -> torch.Tensor:
    """``shape`` uniforms from one ``torch.Generator``; from a list of them,
    one a lane, ``(B,) + shape`` with lane b drawn from ``gen[b]`` exactly as
    ``torch.rand(shape, generator=gen[b])`` draws them alone: one draw a
    lane (the one per-lane loop of the batched engine; a generator's
    stream cannot be split across lanes). A tensor ``gen`` holds the draw
    already, with its lane axis, and is returned as it is."""
    if torch.is_tensor(gen):
        if gen.shape[1:] != tuple(shape):
            raise ValueError(f"drawn uniforms of shape {tuple(gen.shape)}, need (B,) + {shape}")
        return gen
    if isinstance(gen, torch.Generator):
        return torch.rand(shape, generator=gen, device=device)
    if len(gen) == 1:
        return torch.rand(shape, generator=gen[0], device=device)[None]
    return torch.stack([torch.rand(shape, generator=g, device=device) for g in gen])


def sample_index_sets(gen, mask: torch.Tensor, num_hypotheses: int,
                      sample_size: int) -> torch.Tensor:
    """``(..., num_hypotheses, sample_size)`` index sets of valid points,
    uniform without replacement within each hypothesis (top-k of i.i.d.
    uniforms with masked entries at -inf). ``gen`` is a generator, or a list
    of them for a lane axis in front of ``mask``: lane b's sets are then
    what ``sample_index_sets(gen[b], mask[b], ...)`` gives; or those lanes'
    uniforms (:func:`draw_uniform`)."""
    lead = 0 if isinstance(gen, torch.Generator) else 1
    shape = mask.shape[lead:-1] + (num_hypotheses, mask.shape[-1])
    u = draw_uniform(gen, shape, mask.device)
    u = torch.where(mask[..., None, :], u, torch.full_like(u, float("-inf")))
    return stable_topk(u, sample_size)[1]


def ransac(
    idx_sets: torch.Tensor,
    mask: torch.Tensor,
    fit: Callable[[torch.Tensor], tuple],
    score: Callable[[tuple], torch.Tensor],
) -> RansacResult:
    """Batched RANSAC over given hypothesis index sets ``(..., H, s)``.

    ``fit`` maps the index sets to a tuple of models with a hypothesis axis
    ``(..., H, ...)``; ``score`` maps them to a ``(..., H, N)`` bool inlier
    matrix. The winner is the first hypothesis with the most inliers."""
    models = fit(idx_sets)
    inl = score(models) & mask[..., None, :]
    counts = inl.sum(-1)
    best = torch.argmax(counts, dim=-1)  # ties -> lowest index

    def pick(m):
        idx = best.reshape(best.shape + (1,) * (m.dim() - best.dim()))
        idx = idx.expand(best.shape + (1,) + m.shape[best.dim() + 1 :])
        return torch.gather(m, best.dim(), idx).squeeze(best.dim())

    return RansacResult(
        model=tuple(pick(m) for m in models),
        inliers=pick(inl),
        num_inliers=pick(counts),
        best_index=best,
    )
