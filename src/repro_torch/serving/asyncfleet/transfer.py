"""Wire-payload helpers for cross-engine KV migration.

The payload format is defined by ``TorchEngine.export_swapped`` /
``import_swapped``, the port's form of the JAX package's wire format
(docs/fleet.md §Migration wire format), with CPU tensors where JAX has
numpy arrays:

    {"swap": {"tokens": int, "last_token": int,
              "pages": {layer: (k_pages, v_pages)},   # CPU tensors
              "mamba": {layer: (conv, ssm)}},
     "prompt": np.ndarray,         # the full prompt token ids
     "generated": [int, ...]}      # tokens emitted so far

int8 pages carry four fields a layer, ``(k, v, k_scale, v_scale)``.

The link delay a migration models is priced from the *cost model's*
``kv_transfer_bytes`` (the paper-scale figure); ``payload_nbytes`` below
measures the actual serialized demo payload so tests and telemetry can
relate the two.
"""
from __future__ import annotations


def payload_nbytes(payload: dict) -> int:
    """Actual host bytes of an exported wire payload."""
    n = 0
    swap = payload.get("swap", {})
    for fields in swap.get("pages", {}).values():
        n += sum(a.nbytes for a in fields)   # (k, v), or int8 + scales
    for conv, ssm in swap.get("mamba", {}).values():
        n += conv.nbytes + ssm.nbytes
    prompt = payload.get("prompt")
    if prompt is not None:
        n += prompt.nbytes
    n += 8 * len(payload.get("generated", ()))
    n += 16     # tokens + last_token cursors
    return n
