"""Sharded Schur-complement bundle adjustment over ``torch.distributed``
(port of ``structure_from_motion_tpu/parallel/``).

The shard model. The JAX package runs S shards in one process over S local
devices (``shard_map``, ``lax.psum``), and one process per host on a pod.
Here, as PyTorch does it, there is ONE SHARD PER RANK of a process group:

* ``psum`` is ``dist.all_reduce`` over the group (:meth:`Mesh.psum`), and
  only all-reduce is used: the refined points come back as an all-reduce
  of a zero-filled full-size array into which each rank wrote its own
  shard (adding zeros is exact), so one collective serves NCCL and gloo
  over CUDA tensors alike (gloo is what two ranks on ONE card use: NCCL
  refuses two ranks on the same GPU);
* every rank holds the same host-side problem (the same frames, the same
  generator seeds) and takes its own shard of it, which is the JAX
  package's multi-host branch (``models/global_ba.py:460-500``); only BA
  is sharded. As the engine's bits on the card may differ between
  processes, the sharded paths first take rank 0's problem
  (``replicate_first_rank``);
* ``--ba-shards N`` / ``ba_num_shards=N`` / ``solve_global(num_shards=N)``
  therefore mean N ranks, started by ``torchrun --nproc-per-node N``;
  without an initialised group of that size :func:`make_mesh` raises a
  ``ValueError`` that names ``torchrun``;
* one shard needs no group: ``psum`` is then the identity, and the sharded
  layout (partition, interleave, hybrid ELL, tail) runs in one process.
"""

from structure_from_motion_tpu_torch.parallel.ba_sharded import (  # noqa: F401
    deinterleave_points,
    gather_point_shards,
    interleave_points,
    interleaved_bundle_adjustment,
    partition_observations,
    replicate_first_rank,
    sharded_bundle_adjustment,
)
from structure_from_motion_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    process_topology,
    shutdown_distributed,
)
from structure_from_motion_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d  # noqa: F401
