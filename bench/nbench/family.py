"""A configuration's architecture, as the benchmark knows it: the family
module that its file's ``model.family`` names,
``<root>/bench/reference/<family>.py``, loaded by path so that a
checkout (or a test's temporary one) brings its own.

Everything in the harness that depends on the architecture goes through
that module, so a family is added as new files alone. A family module
exports:

- ``layer_leaves(m, li)``: layer ``li``'s leaves as ``(name, shape,
  std)`` or ``(name, shape, std, mean)`` tuples, named as the program's
  ``state_dict`` names them. ``std`` 0 marks a norm (its ``w``, the gain
  less one, is drawn as N(0, ``weights.NORM_STD``)); ``mean``, where
  given, is added to the draw, so that a leaf such as a Mamba ``A_log``,
  ``D`` or ``dt_bias`` lies around its published initial value.
- ``final_hidden(m, get, seqs, keep, precision)``: the final-normed
  float32 hidden states ``[n_i, d]`` of each sequence of token ids at its
  positions ``keep[i]``, in plain PyTorch; ``get(stream)`` returns a
  group's weights; ``precision`` is ``"fp32"`` or ``"fp8"`` (the
  control: fp8 e4m3 operands in every product with a weight).
- ``logits(m, head, hid, precision)``: ``[n, vocab_size]`` float32
  logits of final hidden states through the ``[d, V_pad]`` head.
- ``step_flops(m, chunks, ctxs, sampled)``: the model FLOPs of one step
  (the prefill chunks ``(start, real)``, the decode rows' lengths after
  this step's write, the rows that emit a token).
- ``kv_layers(m)``: the number of layers that hold paged KV.

Weights come in streams (``weights.groups``): 0 the embedding, 1 + i
layer i, 1 + L the final norm, 2 + L the output head. A family module
imports nothing of the program (``repro_torch``), of the JAX package
(``repro``) or of JAX.
"""
from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@functools.cache
def _load(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no family module {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_family_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path, m: dict) -> ModuleType:
    """The family module of a configuration's ``model`` block ``m``,
    loaded once a path."""
    name = m.get("family")
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"model.family {name!r} is not a module name")
    return _load((Path(root) / "bench" / "reference"
                  / f"{name}.py").resolve())
