"""KV memory hierarchy (DESIGN: docs/kvcache.md).

Replaces the flat per-request block accounting of ``core/kvpool.py`` with a
three-tier model every scheduling decision flows through:

  1. :class:`PrefixCache` — refcounted radix-style cache over chained
     token-block hashes; requests sharing a prompt prefix reuse HBM blocks
     and *skip* those prefill tokens.
  2. :class:`HostSwapPool` — host-RAM tier; relegated requests swap KV out
     over the PCIe/host link instead of free-and-recompute, and pay a
     bandwidth-modeled swap-in cost (charged against deadline slack) on
     resume.
  3. live KV transfer — the fleet controller moves in-flight requests
     between replicas with the transfer time modeled over ``link_bw``
     (see ``serving/fleet/controller.py``).

:class:`KVHierarchy` is a drop-in ``KVPool``: with both features disabled it
is bit-identical to the flat pool, so the solo-replica scheduler behaves
exactly as before.
"""
from repro_torch.serving.kvcache.hierarchy import KVCacheConfig, KVHierarchy
from repro_torch.serving.kvcache.prefix import (CachedBlock, PrefixCache,
                                               block_hashes)
from repro_torch.serving.kvcache.swap import HostSwapPool

__all__ = [
    "CachedBlock",
    "HostSwapPool",
    "KVCacheConfig",
    "KVHierarchy",
    "PrefixCache",
    "block_hashes",
]
