"""The weights of a run, made on the device from the run's seed.

One ``torch.Generator`` on the device, seeded from the run's seed and
the layer's index, draws each layer's weights in one call (the
embedding and the output head in one call each), in the dtype they are
served in; the leaves are views of that draw, scaled in place. A layer
is thus a pure function of (seed, layer), so the reference draws each
layer again after the window instead of keeping a copy, and the program
is handed a mapping that draws one layer at a time as it copies them:
the card never holds more than one layer beside the program's weights.

The names, shapes and scales of a layer's leaves are its family's
(``layer_leaves``, ``nbench/family.py``), named as the program's
``state_dict`` names them. A norm's entry ``w`` (std 0) is its gain less
one (the gain is ``1 + w``), drawn as N(0, 0.1) so that the norms'
weights matter to the comparison; a leaf that gives a mean has it added
to its draw. The embedding and the head are drawn at 0.02.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import torch

from nbench.traffic import seed_words

NORM_STD = 0.1


def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def groups(fam, m: dict) -> List[Tuple[int, List[tuple]]]:
    """The draws in order: (stream id, its leaves), the layers' from the
    family module ``fam``. Stream 0 is the embedding, 1 + i layer i,
    1 + L the final norm, 2 + L the head."""
    d, L = m["d_model"], m["num_layers"]
    vp = padded_vocab(m["vocab_size"])
    out = [(0, [("embed", (vp, d), 0.02)])]
    out += [(1 + li, fam.layer_leaves(m, li)) for li in range(L)]
    out.append((1 + L, [("final_norm", (d,), 0.0)]))
    out.append((2 + L, [("lm_head", (d, vp), 0.02)]))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(m: dict, seed: int, stream: int, leaves, device,
         dtype) -> Dict[str, torch.Tensor]:
    """One group's leaves from one draw of the device's generator."""
    gen = torch.Generator(device=device)
    lo, hi = seed_words(seed)
    gen.manual_seed(((hi * 1000003 + lo) * 4099 + stream) % (1 << 63))
    total = sum(_numel(leaf[1]) for leaf in leaves)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std, *mean in leaves:
        n = _numel(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(std if std else NORM_STD)
        if mean:
            t.add_(mean[0])
        out[name] = t
        at += n
    return out


class SeededWeights(Mapping):
    """The run's weights as a read-only mapping of name to tensor, drawn
    one group at a time in the mapping's order; the group last drawn is
    kept until a name of another group is asked for."""

    def __init__(self, fam, m: dict, seed: int, device, dtype):
        self.m, self.seed, self.device, self.dtype = m, seed, device, dtype
        self._group_of = {}
        self._leaves = {}
        for stream, leaves in groups(fam, m):
            self._leaves[stream] = leaves
            for leaf in leaves:
                self._group_of[leaf[0]] = stream
        self._held: Tuple[int, Dict[str, torch.Tensor]] = (-1, {})

    def __getitem__(self, name: str) -> torch.Tensor:
        stream = self._group_of[name]
        if self._held[0] != stream:
            self._held = (-1, {})
            self._held = (stream, draw(self.m, self.seed, stream,
                                       self._leaves[stream], self.device,
                                       self.dtype))
        return self._held[1][name]

    def group(self, stream: int) -> Dict[str, torch.Tensor]:
        """Every leaf of one group, drawn afresh."""
        return draw(self.m, self.seed, stream, self._leaves[stream],
                    self.device, self.dtype)

    def release(self) -> None:
        self._held = (-1, {})

    def __iter__(self) -> Iterator[str]:
        return iter(self._group_of)

    def __len__(self) -> int:
        return len(self._group_of)
