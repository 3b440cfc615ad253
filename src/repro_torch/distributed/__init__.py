"""Tensor-parallel serving over ``torch.distributed``: the rank group and
its gathers (``TPGroup``), the slicing plan (``TPServePlan``) and the
worker ranks that a tensor-parallel ``TorchEngine`` spawns
(``tp_serve``, ``worker``)."""
from .tp_serve import TPGroup, TPServePlan, pick_backend

__all__ = ["TPGroup", "TPServePlan", "pick_backend"]
