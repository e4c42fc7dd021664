"""Multi-node entry points on ``torch.distributed`` (PyTorch port of
``exponentialutilities_jl_tpu/parallel/multihost.py``).

Two layouts, as in the JAX package:

1. ``make_global_mesh``: one row axis over every rank of every node,
   rank-major (the ranks of one node are consecutive), so a ring halo
   exchange crosses between nodes only at node boundaries while the
   per-step psum spans all ranks. Right when one state vector exceeds a
   node's memory.
2. ``make_host_data_mesh``: a 2-D mesh, ``data`` across nodes and
   ``shard`` within a node. Operator rows are sharded over ``shard``;
   independent right-hand sides run data-parallel over ``data``, so the
   Krylov body has no collective across nodes.

``initialize_distributed`` starts ``torch.distributed`` from explicit
arguments or the ``torchrun`` environment (``MASTER_ADDR``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``). Nothing on a machine tells a program of
its cluster otherwise: the caller gives the address, the world size and
the rank. A node count ``n_hosts`` splits the ranks into that many
consecutive blocks, so the layouts can be exercised by several ranks of
one machine.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import Mesh, check_devices, default_rank_device

__all__ = ["initialize_distributed", "make_global_mesh",
           "make_host_data_mesh"]

_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, *,
                           backend: str | None = None) -> bool:
    """Initialize the default ``torch.distributed`` process group.

    ``coordinator_address``: an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``); default ``env://`` (the ``torchrun`` variables).
    ``num_processes``, ``process_id``: world size and rank (default: the
    environment's). ``local_device_ids``: this rank's CUDA device (an int
    or a one-element list), made current. ``backend``: default NCCL when
    CUDA is available, else gloo.

    Returns True when it initialized the group, False when the group was
    already up or nothing is configured (one process, no environment).
    A requested initialization that fails raises: it must not degrade to
    N disconnected runs."""
    if dist.is_initialized():
        return False
    if (coordinator_address is None and num_processes is None
            and not all(k in os.environ for k in _TORCHRUN_ENV)):
        return False
    if local_device_ids is not None:
        ids = (list(local_device_ids)
               if isinstance(local_device_ids, (list, tuple))
               else [local_device_ids])
        torch.cuda.set_device(int(ids[0]))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=coordinator_address
                            or "env://", **kw)
    return True


def _hosts(n_hosts: int | None) -> tuple[int, int]:
    """(hosts, ranks per host): ``n_hosts`` consecutive blocks of ranks,
    default one block per node of the ``torchrun`` environment
    (``LOCAL_WORLD_SIZE``) or one."""
    world = dist.get_world_size()
    if n_hosts is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_hosts = max(1, world // per)
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not divide over {n_hosts} hosts")
    return n_hosts, world // n_hosts


def make_global_mesh(n_hosts: int | None = None, axis_name: str = "shard",
                     device=None) -> Mesh:
    """One row axis over every rank of every node, rank-major (layout 1):
    a drop-in wherever a 1-D mesh is accepted (``expv_sharded``,
    ``make_expv_step``, ...)."""
    _hosts(n_hosts)
    ranks = list(range(dist.get_world_size()))
    device = torch.device(device) if device is not None \
        else default_rank_device()
    check_devices(ranks, device, dist.get_backend())
    return Mesh({axis_name: (dist.group.WORLD, ranks)}, device)


def make_host_data_mesh(n_hosts: int | None = None, data_axis: str = "data",
                        shard_axis: str = "shard", device=None) -> Mesh:
    """2-D mesh (layout 2): ``data`` across the nodes (the ranks with the
    same position in their node) and ``shard`` within a node. Every rank
    creates every group, in the same order (creating a group is
    collective: a rank that skips one deadlocks the others)."""
    hosts, per = _hosts(n_hosts)
    me = dist.get_rank()
    shard_groups = [list(range(h * per, (h + 1) * per)) for h in range(hosts)]
    data_groups = [list(range(j, hosts * per, per)) for j in range(per)]
    axes = {}
    for name, groups in ((shard_axis, shard_groups), (data_axis, data_groups)):
        for ranks in groups:
            g = dist.new_group(ranks=ranks)
            if me in ranks:
                axes[name] = (g, ranks)
    device = torch.device(device) if device is not None \
        else default_rank_device()
    check_devices(list(range(dist.get_world_size())), device,
                  dist.get_backend())
    return Mesh({data_axis: axes[data_axis], shard_axis: axes[shard_axis]},
                device)
