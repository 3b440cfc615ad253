"""The open loop on the wall clock, around ``Replica.step``.

Each request is submitted when its due time comes; the replica's clock
(``rep.now``) is set to the wall clock before each step, and the tokens
a step produced take the wall time at which the step returned (the
engine's one device-to-host read has synchronised by then). The replica
never runs its own virtual clock (``Replica.run``). A proxy around the
scheduler's ``schedule`` times it and keeps the plan, so each step's
record holds the scheduler's host seconds, its prediction, the plan's
real chunks and decode rows, and the pool's use after the step.

With a tracer (``profile.Profiled``) the last ``PROFILE_S`` seconds of the
window (its second half, in a window shorter than twice that) run under
``torch.profiler``; host spans named ``bench.*`` mark what the loop was
doing, so idle device time can be put down to it. The steps before the
profiler's start are what the host-side readers read.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional

from nbench import program
from nbench.records import ReqRec, StepRec
from nbench.traffic import Item, Mix

clock = time.perf_counter
PROFILE_S = 10.0


class _Proxy:
    """Times ``schedule`` and keeps what the step is about to run."""

    def __init__(self, sched, span):
        self.inner = sched.schedule
        self.span = span
        self.cur: Optional[StepRec] = None
        self.plan = None
        self.starts: Dict[int, int] = {}
        sched.schedule = self

    def __call__(self, now, view):
        t = clock()
        with self.span("bench.schedule"):
            plan = self.inner(now, view)
        self.cur.sched_s += clock() - t
        self.plan = plan
        self.starts = {r.rid: r.prefilled for r, _ in plan.prefill}
        return plan


def drive(rep, items: List[Item], mix: Mix, prompts: Dict[int, object],
          seconds: float, t_ramp: float, tracer=None):
    """Offer ``items`` from ``t_ramp`` on, through the ramp and the
    window, and stop at the window's close. Returns (requests by rid,
    steps, window open, window close, the profiler's start or None)."""
    eng = rep.backend
    span = tracer.span if tracer is not None else (lambda name: nullcontext())
    proxy = _Proxy(rep.scheduler, span)
    t_open = t_ramp + mix.ramp_s
    t_close = t_open + seconds
    t_prof = t_close - min(PROFILE_S, seconds / 2)
    reqs: Dict[int, ReqRec] = {}
    pending = deque(items)
    steps: List[StepRec] = []
    n_log = len(eng.iteration_log)
    while True:
        now = clock()
        if tracer is not None and not tracer.on and now >= t_prof:
            tracer.start()
        if now >= t_close:
            break
        while pending and t_ramp + pending[0].offset <= now:
            it = pending.popleft()
            tier = mix.tiers[it.tier]
            req = program.make_request(it, tier)
            req.arrival = t_ramp + it.offset
            program.give_prompt(eng, it.rid, prompts[it.rid])
            reqs[it.rid] = ReqRec(it.rid, req.arrival, tier.name,
                                  tier.interactive, it.prompt_len,
                                  it.decode_len, it.in_window)
            rep.submit(req)
        if not rep.pending:
            nxt = t_ramp + pending[0].offset if pending else t_close
            with span("bench.wait"):
                time.sleep(max(0.0, min(nxt, t_close) - clock()))
            continue
        cur = StepRec(t0=now, profiled=tracer is not None and tracer.on)
        proxy.cur, proxy.plan = cur, None
        rep.now = now
        with span("bench.step"):
            rep.step()
        cur.t1 = t1 = clock()
        plan = proxy.plan
        if plan is not None:
            _record(cur, plan, proxy.starts, reqs, t1)
            if len(eng.iteration_log) > n_log:
                cur.engine_s = eng.iteration_log[-1][1]
                cur.predicted_s = plan.predicted_time
                n_log = len(eng.iteration_log)
        cur.kv_used, cur.kv_total = rep.kv.used, rep.kv.num_blocks
        steps.append(cur)
    if tracer is not None and tracer.on:
        tracer.stop()
    return reqs, steps, t_open, t_close, \
        (t_prof if tracer is not None else None)


def _record(cur: StepRec, plan, starts, reqs, t1: float) -> None:
    """What the step ran, from the plan and the requests it moved: each
    prefill chunk's real (start, length), each decode row's length after
    its write, and a wall time for every token it produced."""
    for req, _ in plan.prefill:
        start = starts[req.rid]
        real = req.prefilled - start
        if real <= 0:
            continue            # deferred by the engine's backpressure
        cur.chunks.append((start, real))
        rec = reqs[req.rid]
        if rec.admitted is None:
            rec.admitted = cur.t0
    for req in plan.decode:
        # the step wrote the last token emitted and read every key so far
        cur.ctxs.append(req.prompt_len + req.decoded - 1)
    for req in [r for r, _ in plan.prefill] + list(plan.decode):
        rec = reqs[req.rid]
        new = len(req.token_times) - len(rec.tokens)
        if new > 0:
            rec.tokens.extend([t1] * new)
            cur.sampled += new
