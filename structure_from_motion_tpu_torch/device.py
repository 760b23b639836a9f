"""Device and float32 policy, plus the index helpers every stage shares.

The port runs in float32 end to end, like the JAX package on its
accelerator. Matrix products and convolutions on the card must therefore
stay in full float32: PyTorch's TF32 shortcut keeps ~3 decimal digits, which
would move DoG candidates and RANSAC consensus. Both switches are set here,
once, when the package is imported. (Kernel B3 does use the tensor cores,
but at float32-level accuracy: every operand is split into a TF32 head and
its exact rest and three products are summed, ``csrc/match_top2.cu``.)

Two JAX behaviours have no PyTorch default and get explicit helpers:

* ``lax.top_k``/``argmax`` break ties towards the LOWEST index;
  ``torch.topk`` promises no order among ties -> :func:`stable_topk`.
* JAX gathers clamp out-of-range indices and ``mode="drop"`` scatters drop
  them; PyTorch raises (or asserts on the device) -> :func:`clamp_index`
  at every gather whose index may be out of range.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the ``k`` largest entries along ``dim``, equal
    values ordered by ascending index (``lax.top_k``'s tie rule)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def repeat_each(x: torch.Tensor, r: int, dim: int = 0) -> torch.Tensor:
    """``x.repeat_interleave(r, dim)`` for an int ``r``: the same values by a
    broadcast and one copy (an exported program runs ``repeat_interleave``
    by an int through a slow path on the card: a served frame took 3.7x a
    live one with it, 1.3x without; PERF.md)."""
    dim = dim % x.dim()
    out = x.unsqueeze(dim + 1).expand(x.shape[:dim + 1] + (r,) + x.shape[dim + 1:])
    return out.reshape(x.shape[:dim] + (x.shape[dim] * r,) + x.shape[dim + 1:])


def clamp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Clamp gather indices into ``[0, n)`` (JAX's gather semantics)."""
    return idx.clamp(0, max(n - 1, 0))


def generator(device: torch.device, *keys: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from integer ``keys``
    (e.g. ``(seed, frame, stream)``) — the counterpart of
    ``jax.random.fold_in``. The draws differ from JAX's for the same keys."""
    seed = int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
    return g
