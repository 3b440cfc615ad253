"""The weights of a run, made on the device from the run's seed.

One ``torch.Generator`` on the device, seeded from the run's seed and
the layer's index, draws each layer's weights in one call (the
embedding and the output head in one call each), in the dtype they are
served in; the leaves are views of that draw, scaled in place. A layer
is thus a pure function of (seed, layer), so the reference draws each
layer again after the window instead of keeping a copy, and the program
is handed a mapping that draws one layer at a time as it copies them:
the card never holds more than one layer beside the program's weights.

The names and shapes are those of the program's ``state_dict``
(``embed [V_pad, d]``, ``layers.i.attn.wq [d, H, hd]``, ``wo [H, hd,
d]``, ``layers.i.ffn.w_gate [d, f]``, ``layers.i.moe.w_gate [E, d,
f_e]`` ...). A norm's entry ``w`` is its gain less one (the gain is
``1 + w``), drawn as N(0, 0.1) so that the norms' weights matter to the
comparison. The other scales are fan-in scales: ``d ** -0.5`` for the
projections out of the model width and the router, ``(H * hd) ** -0.5``
for ``wo``, ``f ** -0.5`` for ``w_down``, 0.02 for the embedding and
the head.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import torch

from nbench.traffic import seed_words

NORM_STD = 0.1


def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def layer_leaves(m: dict, li: int) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of layer ``li``'s leaves; std 0 marks a norm."""
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    p = f"layers.{li}."
    out = [(p + "norm1", (d,), 0.0),
           (p + "attn.wq", (d, H, hd), d ** -0.5),
           (p + "attn.wk", (d, KV, hd), d ** -0.5),
           (p + "attn.wv", (d, KV, hd), d ** -0.5),
           (p + "attn.wo", (H, hd, d), (H * hd) ** -0.5),
           (p + "norm2", (d,), 0.0)]
    moe = m.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        out += [(p + "moe.router", (d, E), d ** -0.5),
                (p + "moe.w_gate", (E, d, f), d ** -0.5),
                (p + "moe.w_up", (E, d, f), d ** -0.5),
                (p + "moe.w_down", (E, f, d), f ** -0.5)]
    else:
        f = m["d_ff"]
        out += [(p + "ffn.w_gate", (d, f), d ** -0.5),
                (p + "ffn.w_up", (d, f), d ** -0.5),
                (p + "ffn.w_down", (f, d), f ** -0.5)]
    return out


def groups(m: dict) -> List[Tuple[int, List[Tuple[str, tuple, float]]]]:
    """The draws in order: (stream id, its leaves). Stream 0 is the
    embedding, 1 + i layer i, 1 + L the final norm, 2 + L the head."""
    d, L = m["d_model"], m["num_layers"]
    vp = padded_vocab(m["vocab_size"])
    out = [(0, [("embed", (vp, d), 0.02)])]
    out += [(1 + li, layer_leaves(m, li)) for li in range(L)]
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
    total = sum(_numel(s) for _, s, _ in leaves)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std in leaves:
        n = _numel(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(std if std else NORM_STD)
        out[name] = t
        at += n
    return out


class SeededWeights(Mapping):
    """The run's weights as a read-only mapping of name to tensor, drawn
    one group at a time in the mapping's order; the group last drawn is
    kept until a name of another group is asked for."""

    def __init__(self, m: dict, seed: int, device, dtype):
        self.m, self.seed, self.device, self.dtype = m, seed, device, dtype
        self._group_of = {}
        self._leaves = {}
        for stream, leaves in groups(m):
            self._leaves[stream] = leaves
            for name, _, _ in leaves:
                self._group_of[name] = stream
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
