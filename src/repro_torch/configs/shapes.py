"""The four assigned input shapes (see assignment block).

``kind`` selects which program the dry-run lowers:
  train   -> train_step      (tokens + labels)
  prefill -> prefill          (full-prompt chunked prefill)
  decode  -> serve_step       (ONE new token against a seq_len KV cache)
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
