"""Mesh construction for the sharded steps, the counterpart of the JAX
package's ``launch/mesh.py``.

Functions only, never module-level meshes: importing this module makes
no process group. The production meshes span torch's fake process group
of 256 or 512 ranks, which ``launch/dryrun.py`` creates
(``distributed.torch_api.init_fake_group``) before it calls
``make_production_mesh``; one process then traces one rank's program.
A ``DeviceMesh`` reads its axes as ``mesh_dim_names`` and its sizes as
``shape``; ``distributed.sharding`` reads either that or a shape-only
mesh's ``axis_names`` and ``shape`` mapping.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.torch_api import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model").
    Over the default process group, which must have that many ranks (the
    dry-run's fake group); device type "cpu"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda"):
    """The 1x1 ("data", "model") mesh of one device, for the host-mesh
    steps. Where no process group exists it makes one of a single rank
    (gloo over an in-process store), which
    ``distributed.torch_api.destroy_group`` takes down. Raises without a
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":            # the mesh's device, set before it
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
