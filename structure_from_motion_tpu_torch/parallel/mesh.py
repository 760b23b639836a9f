"""The shard groups of the sharded bundle adjustment (port of
``structure_from_motion_tpu/parallel/mesh.py``): one shard a rank."""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``size`` shards, this process holding shard ``rank``; ``group`` is the
    process group the shards sum over (None: one shard in this process, no
    group). ``shape`` and ``axis_names`` describe the layout of the ranks
    ((size,) and ("shard",), or (hosts, chips) and ("host", "chip")); the
    bundle adjustment gangs every axis into the one group."""

    size: int
    rank: int
    group: object | None
    shape: tuple
    axis_names: tuple

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards, the same bits on every rank
        (``x`` itself is left as it is). Bools are summed as int32."""
        if self.group is None:
            return x
        y = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
        flat = y.reshape(-1)  # 0-d tensors as one element
        dist.all_reduce(flat, group=self.group)
        return flat.reshape(x.shape)


def _world(n: int, what: str):
    """(group, rank) of the initialised world of exactly ``n`` ranks."""
    if not dist.is_initialized():
        raise ValueError(
            f"{what} needs {n} ranks, one a shard, and no process group is initialised: start "
            f"the program with `torchrun --nproc-per-node {n} ...` (or call "
            "parallel.initialize_distributed first)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{what} needs {n} ranks; the process group has {world} (start it "
                         f"with `torchrun --nproc-per-node {n} ...`)")
    return dist.group.WORLD, dist.get_rank()


def make_mesh(n_devices: int | None = None, axis_name: str = "shard") -> Mesh:
    """A 1-D mesh of ``n_devices`` shards over the world group (default: all
    of its ranks). One shard without an initialised group is this process
    alone; any other count needs a group of exactly that size."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices < 1:
        raise ValueError(f"requested {n_devices} shards")
    if n_devices == 1 and not dist.is_initialized():
        return Mesh(1, 0, None, (1,), (axis_name,))
    group, rank = _world(n_devices, f"a mesh of {n_devices} shards")
    return Mesh(n_devices, rank, group, (n_devices,), (axis_name,))


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axis_names: tuple = ("host", "chip")) -> Mesh:
    """A (hosts, chips) mesh over the world group
    (``torch.distributed.device_mesh.init_device_mesh``): rank ``h *
    chips_per_host + c`` is chip c of host h. The bundle adjustment shards
    its points over both axes, so its sums run over the whole group."""
    total = n_hosts * chips_per_host
    if total == 1 and not dist.is_initialized():
        return Mesh(1, 0, None, (n_hosts, chips_per_host), tuple(axis_names))
    group, rank = _world(total, f"a ({n_hosts}, {chips_per_host}) mesh")
    from torch.distributed.device_mesh import init_device_mesh

    # the (host, chip) layout of the ranks; the BA sums over the whole group
    init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                     (n_hosts, chips_per_host), mesh_dim_names=tuple(axis_names))
    return Mesh(total, rank, group, (n_hosts, chips_per_host), tuple(axis_names))
