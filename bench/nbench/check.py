"""Whether what the timed path served is right: the served tokens of a
sample of the requests it served against the plain reference.

The sample is drawn from the run's seed among the requests that had
been served a token by the window's close, each with the tokens served
by then (in an overloaded cell few requests finish in a window): the
one with the most served tokens first, then others in a seeded order
until ``TARGET_TOKENS`` served tokens and ``TARGET_REQUESTS`` requests
are in it (one long answer alone would leave most prompts unchecked). The
reference (the configuration's family module in ``bench/reference``,
float32) runs once over each prompt followed by its served tokens, and
at each position where the program chose a token it reads the gap by
which that token's logit lies below the reference's best there: the
widest gap and the mean gap over the checked tokens, and the largest of
the checked requests' own mean gaps
(``request_mean_gap``, so that a fault confined to one request or slot
is not averaged away over the others) over the requests of at least
``REQUEST_TOKENS`` checked tokens (the longest request always among
them): a request of one to a few tokens has a mean that is as noisy as
one token's gap; a configuration's ``check`` names the ones compared and
their limits.
Under greedy decoding a sound program picks the reference's best or a
near-tie of it; a wrong kernel, layer or token shows as a gap of the
logits' own scale.

With ``control``, ``served_gaps`` also reads the control that the
limits were set against: the reference computed with fp8 operands
(``precision="fp8"``) at the same positions, its first choice read in
the float32 reference's logits.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Sequence

import numpy as np
import torch

from nbench.records import ReqRec
from nbench.traffic import seed_words
from nbench.weights import SeededWeights

TARGET_TOKENS = 256
TARGET_REQUESTS = 8
MIN_TOKENS = 64
REQUEST_TOKENS = 10


def sample(reqs: Dict[int, ReqRec], served: Dict[int, list],
           seed: int) -> List[int]:
    done = sorted(rid for rid in reqs if served.get(rid))
    if not done:
        return []
    longest = max(done, key=lambda rid: (len(served[rid]),
                                         reqs[rid].prompt_len, -rid))
    rest = [rid for rid in done if rid != longest]
    order = np.random.default_rng(seed_words(seed) + [29]).permutation(
        len(rest))
    out, n = [longest], len(served[longest])
    for i in order:
        if n >= TARGET_TOKENS and len(out) >= TARGET_REQUESTS:
            break
        out.append(rest[i])
        n += len(served[rest[i]])
    return out


def _inputs(rids, prompts, served, device):
    seqs, keep, toks = [], [], []
    for rid in rids:
        p, s = prompts[rid], served[rid]
        seqs.append(torch.as_tensor(np.concatenate(
            [p, np.asarray(s[:-1], np.int32)]), device=device))
        keep.append(torch.arange(len(p) - 1, len(p) - 1 + len(s),
                                 device=device))
        toks.append(torch.as_tensor(s, device=device, dtype=torch.long))
    return seqs, keep, toks


def _logits(fam, m, w: SeededWeights, seqs, keep, precision):
    hid = fam.final_hidden(m, w.group, seqs, keep, precision)
    head = w.group(m["num_layers"] + 2)["lm_head"]
    out = [fam.logits(m, head, h, precision) for h in hid]
    del head, hid
    return out


def _gap(lg: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]


def _request_floor(lengths: Sequence[int]) -> int:
    """The fewest checked tokens of a request held to ``request_mean_gap``:
    ``REQUEST_TOKENS``, or the longest request's where it has fewer."""
    return min(REQUEST_TOKENS, max(lengths))


def _summary(gaps) -> Dict[str, object]:
    """The widest and the mean gap over every checked token, and the
    largest mean gap of a request held to it (one tensor of gaps a
    request)."""
    if not gaps:
        return {"max_logit_gap": None, "mean_logit_gap": None,
                "request_mean_gap": None}
    g = torch.cat(gaps)
    n = _request_floor([len(x) for x in gaps])
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "request_mean_gap": max(float(x.mean()) for x in gaps
                                    if len(x) >= n)}


def failed(per_request: Dict[int, dict], limits: Dict[str, float]) -> int:
    """The checked requests over a limit that holds each request: the
    widest gap, and the mean gap of a request held to
    ``request_mean_gap``."""
    n = _request_floor([g["tokens"] for g in per_request.values()] or [0])

    def over(g):
        return (g["max_logit_gap"] > limits.get("max_logit_gap", 1e30)
                or (g["tokens"] >= n and g["mean_logit_gap"]
                    > limits.get("request_mean_gap", 1e30)))
    return sum(over(g) for g in per_request.values())


@torch.no_grad()
def served_gaps(fam, m: dict, w: SeededWeights, rids: Sequence[int],
                prompts: Dict[int, np.ndarray], served: Dict[int, list],
                device, control: bool = False) -> Dict[str, object]:
    """The gaps of the served tokens of ``rids`` in the float32
    reference's logits (the family module ``fam``'s; ``_summary``), in
    all and by request (with the request's checked tokens); with
    ``control``, also the fp8 control's at the same positions."""
    seqs, keep, toks = _inputs(rids, prompts, served, device)
    ref = _logits(fam, m, w, seqs, keep, "fp32")
    each = [_gap(lg, t) for lg, t in zip(ref, toks)]
    out = {"per_request": {r: dict(_summary([g]), tokens=len(g))
                           for r, g in zip(rids, each)},
           "tokens": int(sum(len(t) for t in toks))}
    out.update(_summary(each))
    if control:
        ctl = _logits(fam, m, w, seqs, keep, "fp8")
        cgaps = [_gap(lg, c.argmax(dim=-1)) for lg, c in zip(ref, ctl)]
        out.update({f"control_{k}": v for k, v in _summary(cgaps).items()})
        out["control_per_request"] = {
            r: dict(_summary([g]), tokens=len(g))
            for r, g in zip(rids, cgaps)}
        del ctl
    del ref
    gc.collect()
    return out
