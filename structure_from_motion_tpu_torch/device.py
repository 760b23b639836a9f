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

import collections

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


_CONSTANTS: dict = {}  # (values, dtype, device) -> the uploaded tensor


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, uploaded once a
    device and kept: the frame path reads small constant tables, and an
    upload from pageable memory each frame would wait for the card (a host
    synchronisation) and could not be captured in a CUDA graph. The tensor
    is shared: never write into it. While ``torch.export`` traces, a fresh
    tensor (the program keeps it as its constant)."""
    if torch.compiler.is_exporting():
        return torch.tensor(values, dtype=dtype, device=device)
    arr = np.asarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def generator(device: torch.device, *keys: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from integer ``keys``
    (e.g. ``(seed, frame, stream)``) — the counterpart of
    ``jax.random.fold_in``. The draws differ from JAX's for the same keys."""
    seed = int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def to_device(a: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``a.to(device, dtype)``; a host tensor bound for the card goes
    through pinned memory with a non-blocking copy, so the upload does not
    wait for the card (an upload from pageable memory does). The pinned
    buffer is torch's caching host allocator's, which reuses it only after
    the copy has completed."""
    if dtype is not None:
        a = a.to(dtype)
    device = torch.device(device)
    if a.device.type == "cpu" and device.type == "cuda":
        return a.pin_memory().to(device, non_blocking=True)
    return a.to(device)


class HostCopy:
    """Tensors copied to the host, started at once and waited for once, when
    :meth:`arrays` is first called (the JAX package's
    ``copy_to_host_async`` and grouped ``device_get``).

    The tensors of one dtype are concatenated and copied into ONE host
    buffer; on the card the buffer is pinned, the copy non-blocking, and an
    event is recorded after the copies, which :meth:`arrays` waits for (the
    one host wait, counted in :attr:`waits`). :meth:`arrays` gives numpy
    views of the buffers with every tensor's dtype, shape and values, as
    ``.cpu().numpy()`` gives them. The buffers belong to the copy and its
    arrays alone, so none is reused while a copy into it is in flight."""

    waits = 0  # host waits for a copy on the card, since the process began

    def __init__(self, tensors):
        tensors = list(tensors)
        self._shapes = [tuple(t.shape) for t in tensors]
        self._event, self._arrays = None, None
        groups = collections.defaultdict(list)
        for i, t in enumerate(tensors):
            groups[t.dtype].append(i)
        self._groups = []
        for dtype, idx in groups.items():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            if flat.is_cuda:
                buf = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
                buf.copy_(flat, non_blocking=True)
                flat = buf
            self._groups.append((idx, flat))
        if any(t.is_cuda for t in tensors):
            self._event = torch.cuda.Event()
            self._event.record()

    def arrays(self) -> list:
        """The numpy arrays, in the order the tensors were given."""
        if self._arrays is None:
            if self._event is not None:
                self._event.synchronize()
                HostCopy.waits += 1
            out = [None] * len(self._shapes)
            for idx, buf in self._groups:
                host, at = buf.numpy(), 0
                for i in idx:
                    n = int(np.prod(self._shapes[i], dtype=np.int64))
                    out[i] = host[at:at + n].reshape(self._shapes[i])
                    at += n
            self._arrays, self._groups = out, None
        return self._arrays


def fetch(tensors: dict) -> dict:
    """``{key: tensor.cpu().numpy()}`` for a dict of tensors, made by one
    :class:`HostCopy` (one wait on the card, not one a key)."""
    return dict(zip(tensors, HostCopy(tensors.values()).arrays()))
