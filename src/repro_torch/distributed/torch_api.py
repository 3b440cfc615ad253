"""The ``torch.distributed`` APIs of the sharding layer, imported in one
place: DTensor and its placements, ``DeviceMesh``, ``implicit_replication``,
``local_map``, ``CommDebugMode`` and the fake process group of the
dry-run. Only public names are imported when the module loads; the
private helpers the dry-run needs are imported inside the functions that
use them, and ``CommDebugMode`` (whose module loads ``torch._dynamo``)
on first use. ``describe()`` names the torch release. Importing this module
creates no process group.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DeviceMesh, DTensor, Partial,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

__all__ = ["DeviceMesh", "DTensor", "Partial", "Replicate", "Shard",
           "CommDebugMode", "distribute", "implicit_replication", "local_map",
           "init_device_mesh", "is_dtensor", "init_fake_group",
           "destroy_group", "describe", "mixed_inputs", "local_offset",
           "einsum"]


def __getattr__(name):
    if name == "CommDebugMode":
        from torch.distributed.tensor.debug import CommDebugMode
        return CommDebugMode
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor: each rank
    keeps its own slice, and nothing is sent (every rank holds ``t``
    already, and the dry-run's fake tensors hold no data)."""
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def local_offset(t: DTensor) -> tuple:
    """The global index of the first element of this rank's shard of
    ``t``, per dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                 t.placements)[1]


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``; where ``b`` is a DTensor each rank runs
    it on its own shards (``local_map``) with the layout fixed here: per
    mesh axis, the dim that an operand shards stays sharded (where both
    shard different dims, the larger operand's: a decode's cache keeps
    its sequence split and the one-token query moves), the other operand
    is split on the same letter or whole, and a contracted letter leaves
    the output ``Partial``. DTensor's own einsum flattens the head dims
    of a projection (``bsd,dhk->bshk``) into one and may split it where
    the heads do not divide the axis, which it then cannot unflatten.
    Plain tensors take ``torch.einsum`` itself."""
    if not isinstance(b, DTensor):
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = b.device_mesh
    a_pl = a.placements if isinstance(a, DTensor) else \
        (Replicate(),) * mesh.ndim
    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        sa = a_pl[i].dim if isinstance(a_pl[i], Shard) else None
        sb = b.placements[i].dim if isinstance(b.placements[i], Shard) \
            else None
        if sa is not None and (sb is None or a.numel() >= b.numel()):
            letter = la[sa]
        else:
            letter = lb[sb] if sb is not None else None
        if letter is None:
            pa.append(Replicate()), pb.append(Replicate())
            po.append(Replicate())
            continue
        pa.append(Shard(la.index(letter)) if letter in la else Replicate())
        pb.append(Shard(lb.index(letter)) if letter in lb else Replicate())
        po.append(Shard(out.index(letter)) if letter in out else Partial())
    # an operand whole on an axis that splits a dim it lacks (the batch
    # for a weight) gets the sum of each rank's part as its gradient
    ga = [Partial() if isinstance(x, Replicate) and isinstance(y, Shard)
          and lb[y.dim] not in la else x for x, y in zip(pa, pb)]
    gb = [Partial() if isinstance(y, Replicate) and isinstance(x, Shard)
          and la[x.dim] not in lb else y for x, y in zip(pa, pb)]
    fn = local_map(lambda x, y: torch.einsum(eq, x, y),
                   out_placements=po,
                   in_placements=(tuple(pa), tuple(pb)),
                   in_grad_placements=(tuple(ga), tuple(gb)),
                   device_mesh=mesh, redistribute_inputs=True)
    if not isinstance(a, DTensor):
        a = DTensor.from_local(a, mesh, a_pl, run_check=False)
    return fn(a, b)


def mixed_inputs(*trees):
    """``implicit_replication()`` where any tensor of ``trees`` (dicts,
    lists, tuples, modules) is a DTensor, so that the plain tensors a
    forward makes (``arange`` positions, masks) join DTensor ops as
    replicated; a null context otherwise, so the one-device program is
    untouched."""
    def has(x):
        if isinstance(x, DTensor):
            return True
        if isinstance(x, torch.nn.Module):
            return any(isinstance(p, DTensor) for p in x.parameters())
        if isinstance(x, dict):
            return any(has(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return any(has(v) for v in x)
        return False
    return implicit_replication() if any(has(t) for t in trees) \
        else contextlib.nullcontext()


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """The default process group as torch's fake backend of
    ``world_size`` ranks: collectives return at once with outputs of the
    right shape, so one process traces the program of one rank of a
    mesh as large as the dry-run's."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def destroy_group() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def describe() -> str:
    """torch's release, printed beside the sharding layer's results."""
    return f"torch {torch.__version__}"
