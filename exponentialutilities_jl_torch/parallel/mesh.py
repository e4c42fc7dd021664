"""The port's device mesh on ``torch.distributed``.

A JAX shard is one device inside one program; a shard of the port is one
rank: one process with one device, in PyTorch's SPMD idiom. A ``Mesh``
bundles, per axis name, the process group of the ranks along that axis,
this rank's index and the axis size, plus the device where this rank's
tensors live (``Mesh.device``). Results of the sharded entry points are
this rank's rows, the counterpart of a row-sharded ``jax.Array``;
``gather_vector`` assembles the whole vector where JAX reads the array.

The collectives are methods of a ``MeshAxis`` (``mesh.axis(name)``), so a
call names its axis as the JAX one does (``mesh.axis("shard").psum(t)`` is
``lax.psum(t, "shard")``), and carry the names of the JAX ones they
replace:

* ``psum(t)``           ``lax.psum``       all_reduce(SUM)
* ``pmax(t)``           ``lax.pmax``       all_reduce(MAX)
* ``ppermute_halo``     ``lax.ppermute``   the two ring neighbours'
                        boundary rows, zeros at the global ends (the
                        Dirichlet truncation), by ``batch_isend_irecv``
* ``axis_index()``, ``axis_size()``

Every call is counted per axis in ``mesh.census`` (``psum``, ``pmax``,
``ppermute``, ``all_gather``), which is how the collective-census tests
of the JAX package carry over.

``psum`` is differentiable: a sum that autograd or a ``torch.func``
transform must see runs through ``_PSum``, whose reverse rule is the psum
of the cotangents (every rank's outputs read the summed value) and whose
tangent is the psum of the tangents. So reverse mode through a sharded
driver is the single-device gradient of the sum of the ranks' losses,
each rank calling ``backward`` on its own part; the ranks' backward
passes meet in those psums in the same order, as their forward passes
did. ``pmax`` feeds only host decisions and masks and has no rule.

Backends and devices. NCCL when every rank owns its own GPU (a NCCL mesh
whose ranks share a device raises: NCCL refuses it); gloo for CPU tensors;
gloo with CUDA tensors for several ranks sharing one card. gloo's send,
recv and all_gather take host memory only, so on that backend the halo
rows and gathered vectors of CUDA tensors are staged explicitly through
pinned host buffers (one device synchronization each); gloo's all_reduce
takes CUDA tensors itself. No collective moves compute to the CPU: the
results land on the tensors' own device.
"""

from __future__ import annotations

import collections
import os
import socket

import torch
import torch.distributed as dist

__all__ = ["Mesh", "MeshAxis", "make_mesh", "gather_vector",
           "default_rank_device"]


class MeshAxis:
    """One named axis of a ``Mesh``: the process group of the ranks along
    it (``ranks``: their global ranks in axis order), this rank's index,
    the axis size, and the mesh's device. It is what the drivers' ``comm``
    argument takes."""

    def __init__(self, name: str, group, ranks, device, census):
        self.name = name
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.device = torch.device(device)
        self._census = census
        me = dist.get_rank()
        self.member = me in self.ranks
        self.index = self.ranks.index(me) if self.member else -1
        self.size = len(self.ranks)
        self.backend = dist.get_backend(group) if self.member else None

    def __repr__(self):
        return (f"MeshAxis({self.name!r}, index={self.index}, "
                f"size={self.size}, backend={self.backend}, "
                f"device={self.device})")

    def axis_index(self) -> int:
        return self.index

    def axis_size(self) -> int:
        return self.size

    def _count(self, what):
        if not self.member:
            raise RuntimeError(f"rank {dist.get_rank()} is not on mesh axis "
                               f"{self.name!r} (ranks {self.ranks})")
        self._census[what] += 1

    def _staged(self, t) -> bool:
        """gloo cannot send or gather device memory: stage through the
        host."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def _reduce(self, t, op, what):
        self._count(what)
        out = t.clone()
        if self.size > 1 or self.backend == "nccl":
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, t):
        """Sum of ``t`` over the axis (a new tensor; ``lax.psum``), seen by
        autograd where it must be (module doc)."""
        if (torch._C._functorch.is_functorch_wrapped_tensor(t)
                or (torch.is_grad_enabled() and t.requires_grad)):
            return _PSum.apply(t, self)
        return self._reduce(t, dist.ReduceOp.SUM, "psum")

    def pmax(self, t):
        """Maximum of ``t`` over the axis (``lax.pmax``)."""
        return self._reduce(t, dist.ReduceOp.MAX, "pmax")

    def ppermute_halo(self, lo, hi):
        """(below, above): the previous rank's ``hi`` and the next rank's
        ``lo``, zeros at the two ends of the axis. ``lo`` are this rank's
        first boundary rows (the previous rank's upper halo), ``hi`` its
        last ones (the next rank's lower halo); one call is the two
        ``lax.ppermute`` hops of a halo exchange."""
        self._count("ppermute")
        below, above = hi.new_zeros(hi.shape), lo.new_zeros(lo.shape)
        prev = self.index - 1 if self.index > 0 else None
        nxt = self.index + 1 if self.index + 1 < self.size else None
        if prev is None and nxt is None:
            return below, above
        staged = self._staged(lo)
        if staged:
            send_lo = _pinned_copy(lo) if prev is not None else None
            send_hi = _pinned_copy(hi) if nxt is not None else None
            recv_below = _pinned_empty(hi) if prev is not None else None
            recv_above = _pinned_empty(lo) if nxt is not None else None
        else:
            send_lo = lo.contiguous() if prev is not None else None
            send_hi = hi.contiguous() if nxt is not None else None
            recv_below, recv_above = below, above
        ops = []
        if prev is not None:
            peer = self.ranks[prev]
            ops.append(dist.P2POp(dist.isend, send_lo, peer, self.group))
            ops.append(dist.P2POp(dist.irecv, recv_below, peer, self.group))
        if nxt is not None:
            peer = self.ranks[nxt]
            ops.append(dist.P2POp(dist.isend, send_hi, peer, self.group))
            ops.append(dist.P2POp(dist.irecv, recv_above, peer, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            if recv_below is not None:
                below.copy_(recv_below, non_blocking=True)
            if recv_above is not None:
                above.copy_(recv_above, non_blocking=True)
        return below, above

    def all_gather(self, t):
        """The axis members' ``t`` concatenated in axis order along dim 0
        (every member's ``t`` has the same shape)."""
        self._count("all_gather")
        if self.size == 1:
            return t.clone()
        staged = self._staged(t)
        src = _pinned_copy(t) if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(t.device, non_blocking=True) if staged else out


class _PSum(torch.autograd.Function):
    """psum seen by autograd: reverse rule and tangent are psums too."""

    @staticmethod
    def forward(t, axis):
        return axis.psum(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.psum(g), None

    @staticmethod
    def jvp(ctx, t_t, _):
        return ctx.axis.psum(t_t)


def _pinned_empty(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _pinned_copy(t):
    # a synchronous device-to-host copy: the send reads it at once
    h = _pinned_empty(t)
    h.copy_(t)
    return h


class Mesh:
    """A mesh of ranks: one ``MeshAxis`` per axis name (module doc), the
    device of this rank's tensors and the collective census, a
    ``collections.Counter`` per axis name."""

    def __init__(self, axes: dict, device):
        self.device = torch.device(device)
        self.census = {name: collections.Counter() for name in axes}
        self.axes = {name: MeshAxis(name, group, ranks, self.device,
                                    self.census[name])
                     for name, (group, ranks) in axes.items()}
        self.axis_names = tuple(axes)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, device={self.device}, "
                f"rank={dist.get_rank()})")

    @property
    def shape(self) -> dict:
        return {name: ax.size for name, ax in self.axes.items()}

    def axis(self, name: str | None = None) -> MeshAxis:
        """The axis ``name`` (default: the first)."""
        return self.axes[name or self.axis_names[0]]

    def reset_census(self):
        for c in self.census.values():
            c.clear()


def default_rank_device(backend: str | None = None) -> torch.device:
    """Where this rank's tensors live by default: ``cuda:LOCAL_RANK`` on a
    NCCL group (one device per rank), else the port's default device
    (``utils.device``: ``cuda`` unless changed)."""
    from ..utils.device import resolve_device

    backend = backend or dist.get_backend()
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % max(1, torch.cuda.device_count())))
        return torch.device("cuda", local)
    dev = resolve_device(None)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_devices(ranks, device, backend):
    """Raise when a NCCL group maps two ranks to one device (NCCL refuses
    such a communicator: its ranks must own distinct GPUs). The ranks'
    devices are compared through the process group's store, so no NCCL
    call runs first."""
    if backend != "nccl":
        return
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a NCCL mesh needs CUDA devices, got {device}")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(idx).uuid)
    store = dist.distributed_c10d._get_default_store()
    key = "eu_mesh_device/" + "-".join(str(r) for r in ranks)
    me = dist.get_rank()
    store.set(f"{key}/{me}", f"{socket.gethostname()}/{uuid}")
    seen = {}
    for r in ranks:
        where = store.get(f"{key}/{r}").decode()
        if where in seen:
            raise ValueError(
                f"NCCL mesh: ranks {seen[where]} and {r} share one device "
                f"({where}); NCCL needs one device per rank. Several ranks "
                "on one card run over gloo (init_process_group('gloo'))")
        seen[where] = r


def make_mesh(n_devices: int | None = None, axis_name: str = "shard",
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all) of the
    initialized default process group (``initialize_distributed``).

    Raises when fewer ranks than ``n_devices`` are attached, and takes a
    subgroup of the first ``n_devices`` ranks otherwise (every rank must
    call it: creating a group is collective; the ranks outside get a mesh
    whose collectives raise). ``device``: where this rank's tensors live
    (``default_rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group: call parallel.initialize_distributed(...) first")
    world = dist.get_world_size()
    if n_devices is not None:
        if world < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-rank mesh but only {world} "
                "rank(s) are attached; start more processes (torchrun "
                "--nproc-per-node, or one per rank with "
                "initialize_distributed)")
        ranks = list(range(n_devices))
    else:
        ranks = list(range(world))
    backend = dist.get_backend()
    device = torch.device(device) if device is not None \
        else default_rank_device(backend)
    group = dist.group.WORLD if len(ranks) == world \
        else dist.new_group(ranks=ranks)
    if dist.get_rank() in ranks:
        check_devices(ranks, device, backend)
    return Mesh({axis_name: (group, ranks)}, device)


def gather_vector(x_local, mesh: Mesh, axis_name: str | None = None):
    """The whole row-sharded vector (or (n, p) block) from every rank's
    rows: an all_gather along the axis, on ``x_local``'s device."""
    return mesh.axis(axis_name).all_gather(x_local)
