"""Process-group set-up for the sharded bundle adjustment (port of
``structure_from_motion_tpu/parallel/distributed.py``).

``torchrun --nproc-per-node N`` starts one process a shard and tells each
its place through the environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).
:func:`initialize_distributed` reads them and joins the group: NCCL for
the card, gloo for the CPU. A plain single process (no ``WORLD_SIZE`` and
no arguments) needs no group, and every function here is then a no-op, so
the same code runs on one rank or many.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, backend: str | None = None) -> bool:
    """Join the process group of this run. Arguments default to torchrun's
    environment; ``backend`` to NCCL when a card is visible, else gloo (for
    NCCL the process's card becomes ``cuda:LOCAL_RANK``). Returns True when
    a group is (or already was) initialised, False for a plain single
    process."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if world_size is None:
        return False  # single process: nothing to initialise
    if init_method is None:
        init_method = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank if rank is not None else 0)
    return True


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``; 0 for a plain single process)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def shutdown_distributed() -> None:
    """Leave the process group (no-op if none was initialised)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_topology() -> tuple[int, int]:
    """(hosts, ranks a host) of the current run, the arguments of
    ``parallel.mesh.make_mesh_2d``: one rank a card, torchrun's
    ``LOCAL_WORLD_SIZE`` ranks on each host; (1, 1) without a group."""
    if not dist.is_initialized():
        return 1, 1
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return world // per_host, per_host
