"""Event-driven fleet runtime (the tentpole of the fleet layer).

All replicas advance in lockstep virtual time: the controller picks a
barrier ``t_end = t + tick``, routes every arrival falling inside the
window using barrier snapshots, lets each replica simulate up to the
barrier, and only THEN makes global decisions:

  1. **relegation offload** — a request a replica relegated is re-homed to
     the least-loaded replica instead of parking locally. With the KV
     hierarchy (``serving/kvcache``) the controller chooses, per request,
     between *transferring* the host-swapped KV over the inter-replica
     link and the PR-1 *recompute* path (free + full re-prefill),
     whichever the cost model says finishes earlier;
  2. **queued-prefill migration** (Llumnix-style) — when the backlog gap
     between the most- and least-loaded replicas exceeds a threshold,
     not-yet-prefilled requests (no private KV, no backend state) move;
  3. **live KV-transfer migration** — in-flight *decode* requests move off
     a KV-pressured replica, their cache state crossing the link at
     ``link_bw``; the request pauses for exactly the modeled transfer
     time and resumes decoding at the destination.

Because every cross-replica read happens at a barrier, no replica ever
observes another's future; migrated requests are delivered at
``max(barrier, source.now)`` (plus any transfer time) so they never
arrive in anyone's past.

The controller degrades gracefully to the legacy offline deployment:
``dispatch()`` + ``router=None`` + ``offload=migrate=False`` routes
one-shot JSQ and drains each replica independently — exactly the old
``serving/cluster.py`` behaviour, which now shims onto this class.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, Optional, Sequence

from repro_torch.core.kvpool import blocks_for
from repro_torch.core.request import Phase, Request
from repro_torch.serving.fleet.router import Router, offline_jsq
from repro_torch.serving.fleet.telemetry import (FleetReport, MigrationEvent,
                                                 ReplicaSnapshot,
                                                 full_prefill_seconds,
                                                 prefill_seconds, replica_cost,
                                                 snapshot)
from repro_torch.serving.replica import Replica


class FleetController:
    def __init__(self, replicas: Sequence[Replica],
                 router: Optional[Router] = None, *,
                 tick: float = 0.1,
                 offload: bool = True,
                 migrate: bool = True,
                 live_migrate: bool = False,
                 imbalance_s: float = 1.0,
                 spare_s: float = 1.0,
                 offload_margin_s: float = 0.1,
                 max_migrations: int = 3,
                 max_moves_per_tick: int = 8,
                 kv_pressure: float = 0.85,
                 kv_relief: float = 0.60,
                 max_live_per_tick: int = 2,
                 max_live_pause_s: float = 0.25,
                 relegated_park_s: Optional[float] = None,
                 allowed: Optional[Callable[[Request],
                                            Sequence[int]]] = None):
        self.replicas = list(replicas)
        self.router = router
        self.tick = tick
        self.offload = offload
        self.migrate = migrate
        self.live_migrate = live_migrate
        self.imbalance_s = imbalance_s
        self.spare_s = spare_s
        self.offload_margin_s = offload_margin_s
        self.max_migrations = max_migrations
        self.max_moves_per_tick = max_moves_per_tick
        self.kv_pressure = kv_pressure
        self.kv_relief = kv_relief
        self.max_live_per_tick = max_live_per_tick
        self.max_live_pause_s = max_live_pause_s
        self.allowed = allowed if allowed is not None \
            else (router.allowed if router is not None else None)
        # keep the routing constraint consistent in BOTH directions: the
        # online router must honor a controller-level constraint too
        if router is not None and router.allowed is None \
                and self.allowed is not None:
            router.allowed = self.allowed
        # first-class relegation park: wired into the replicas (and their
        # scheduler configs) ONCE at construction, so the offload pass gets
        # first refusal on relegated work before a replica resumes it
        # locally. Replicas handed to an offloading controller keep this
        # setting — they belong to the fleet now. An explicitly passed
        # value is authoritative (set verbatim, even with offload off);
        # the 2-tick default only raises and only when offload runs.
        explicit = relegated_park_s is not None
        self.relegated_park_s = (relegated_park_s if explicit
                                 else 2.0 * tick)
        if explicit or (self.offload and self.relegated_park_s > 0):
            for rep in self.replicas:
                rep.relegated_park_s = (
                    self.relegated_park_s if explicit
                    else max(rep.relegated_park_s, self.relegated_park_s))
                cfg = getattr(rep.scheduler, "cfg", None)
                if cfg is not None and hasattr(cfg, "relegated_park_s"):
                    cfg.relegated_park_s = (
                        self.relegated_park_s if explicit
                        else max(cfg.relegated_park_s,
                                 self.relegated_park_s))
        self._pending: list = []   # heap of (arrival, seq, req)
        self._seq = 0
        self._t = 0.0              # barrier clock, persists across run()s
        # observability attach points (repro_torch.obs): both stay None
        # unless a caller installs them, and every use is gated on that —
        # the lockstep loop and decision passes read nothing from either
        self.tracer = None
        self.registry = None
        self.report = FleetReport(n_replicas=len(self.replicas))
        self._n_submitted = 0
        # dirty-flagged barrier snapshots: keyed on Replica.state_version,
        # so a replica that did nothing since the last barrier (idle, or
        # between the post-advance and next pre-route snapshot) is not
        # re-snapshotted. Any mutation that could change a snapshot also
        # bumps the version, so a cache hit is exact by construction.
        self._snap_cache: dict = {}

    def _snapshot(self, i: int) -> ReplicaSnapshot:
        rep = self.replicas[i]
        hit = self._snap_cache.get(i)
        if hit is not None and hit[0] == rep.state_version:
            # hand out a copy: the router and the migration passes mutate
            # snapshots in place (incremental same-tick accounting), and
            # the cached original must stay pristine for the next hit
            return dataclasses.replace(hit[1],
                                       tier_mix=dict(hit[1].tier_mix))
        snap = snapshot(rep)
        self._snap_cache[i] = (rep.state_version,
                               dataclasses.replace(
                                   snap, tier_mix=dict(snap.tier_mix)))
        return snap

    # ------------------------------------------------ intake
    def submit(self, requests: Sequence[Request]) -> None:
        """Online intake: requests are routed at their arrival tick using
        live fleet state (requires a router)."""
        assert self.router is not None, \
            "online submit() needs a Router; use dispatch() for offline"
        for req in requests:
            heapq.heappush(self._pending, (req.arrival, self._seq, req))
            self._seq += 1
        self._count(requests)

    def dispatch(self, requests: Sequence[Request],
                 route: Optional[Callable[[Request],
                                          Sequence[int]]] = None) -> None:
        """Legacy offline intake: one-shot JSQ over expected work, assigned
        before anything runs (the pre-fleet Cluster behaviour)."""
        reqs = list(requests)
        assign = offline_jsq(reqs, len(self.replicas),
                             route if route is not None else self.allowed)
        for req, i in zip(reqs, assign):
            self.replicas[i].submit(req)
        self._count(reqs)

    def _count(self, reqs: Sequence[Request]) -> None:
        self._n_submitted += len(reqs)
        for r in reqs:
            self.report.tier_mix[r.qos.name] = \
                self.report.tier_mix.get(r.qos.name, 0) + 1

    # ------------------------------------------------ properties
    @property
    def dynamic(self) -> bool:
        return (self.router is not None or self.offload or self.migrate
                or self.live_migrate)

    @property
    def pending(self) -> int:
        return len(self._pending) + sum(r.pending for r in self.replicas)

    def now(self) -> float:
        return max((r.now for r in self.replicas), default=0.0)

    # ------------------------------------------------ main loop
    def run(self, until: Optional[float] = None,
            max_ticks: int = 10_000_000) -> None:
        if not self.dynamic:
            # no cross-replica coupling: independent drains are identical
            # to the lockstep loop, minus the barrier overhead
            self._advance_to(until)
            self._finalize()
            return
        self._run_lockstep(until, max_ticks)

    def _advance_to(self, t_end: Optional[float]) -> None:
        """Advance every replica to the barrier. THE extension seam for
        execution backends: the async runtime overrides this to fan the
        advance out to per-engine worker threads and join — every global
        decision above it stays byte-for-byte this class's code."""
        for rep in self.replicas:
            rep.run(until=t_end)

    def _run_lockstep(self, until: Optional[float],
                      max_ticks: int) -> None:
        t = self._t   # resume from the last barrier on incremental run()s
        for _ in range(max_ticks):
            if until is not None and t >= until:
                break
            if not self.pending:
                break
            t = self._skip_idle_gap(t)
            t_end = t + self.tick
            if until is not None:
                t_end = min(t_end, until)

            # --- route this window's arrivals on barrier snapshots
            # (taken lazily: a window with nothing to route reads nothing,
            # so idle/drain ticks skip the snapshot pass entirely)
            if self.router is not None and self._pending \
                    and self._pending[0][0] < t_end:
                snaps = [self._snapshot(i)
                         for i in range(len(self.replicas))]
                self.router.begin_tick()
                while self._pending and self._pending[0][0] < t_end:
                    _, _, req = heapq.heappop(self._pending)
                    i = self.router.choose(req, snaps)
                    self.replicas[i].submit(req)

            # --- advance every replica to the barrier
            self._advance_to(t_end)
            self.report.ticks += 1

            # --- global decisions at the barrier
            snaps = [self._snapshot(i) for i in range(len(self.replicas))]
            self._observe(t_end, snaps)
            if self.offload:
                self._offload_relegated(t_end, snaps)
            if self.migrate:
                self._rebalance_queued(t_end, snaps)
            if self.live_migrate:
                self._migrate_live(t_end, snaps)
            t = self._t = t_end
        self._t = max(self._t, t)
        self._finalize()

    def _skip_idle_gap(self, t: float) -> float:
        """If every replica is quiescent and the next event is far in the
        future, snap the barrier clock forward instead of spinning ticks."""
        if any(rep.prefill_queue or rep.decode_queue or rep.relegated_queue
               for rep in self.replicas):
            return t
        nxt = [self._pending[0][0]] if self._pending else []
        nxt += [rep._arrivals[0][0] for rep in self.replicas
                if rep._arrivals]
        if not nxt:
            return t
        return max(t, min(nxt) - 0.5 * self.tick)

    # ------------------------------------------------ global decisions
    def _least_loaded(self, snaps: Sequence[ReplicaSnapshot],
                      req: Request, exclude: int) -> Optional[int]:
        idxs = list(self.allowed(req)) if self.allowed is not None \
            else range(len(self.replicas))
        idxs = [i for i in idxs if i != exclude]
        if not idxs:
            return None
        return min(idxs, key=lambda i: (snaps[i].load_s, i))

    def _record_move(self, req: Request, src: Replica, dst_i: int,
                     t: float, kind: str,
                     snaps: Sequence[ReplicaSnapshot],
                     count_backlog: bool = True,
                     nbytes: float = 0.0,
                     t_arr: Optional[float] = None) -> None:
        req.migrations += 1
        req.last_migrated_at = t
        dst = self.replicas[dst_i]
        if count_backlog:   # prefill joins the dst queue (not live decode)
            snaps[dst_i].backlog_s += prefill_seconds(dst, [req])
            snaps[dst_i].n_queued += 1
        self.report.events.append(
            MigrationEvent(t=t, rid=req.rid, src=src.rid, dst=dst.rid,
                           kind=kind))
        if self.tracer is not None:
            self.tracer.emit(
                "migrate", t, rid=req.rid, src=src.rid, dst=dst.rid,
                mkind=kind, bytes=float(nbytes),
                t_arr=t_arr if t_arr is not None else max(t, src.now))

    def _deliver(self, req: Request, src: Replica, dst_i: int,
                 t: float, kind: str,
                 snaps: Sequence[ReplicaSnapshot]) -> None:
        req.phase = Phase.QUEUED
        # never deliver into anyone's past: the request re-arrives at the
        # decision barrier (or the source's clock if it overshot it)
        self.replicas[dst_i].submit_at(req, max(t, src.now))
        self._record_move(req, src, dst_i, t, kind, snaps,
                          t_arr=max(t, src.now))

    def _host_room(self, rep: Replica, blocks: int) -> bool:
        host = getattr(rep.kv, "host", None)
        return host is not None and host.free >= blocks

    # ------------------------------------------------ KV transfer seams
    # The lockstep controller moves *accounting* (sim backends hold no
    # real KV). The async runtime overrides these six hooks so the same
    # decision code moves actual engine pages over the link; the defaults
    # preserve the historical behavior exactly (golden-trace guarantee).
    def _transfer_ok(self, src: Replica, dst: Replica,
                     req: Request) -> bool:
        """May ``req``'s host-parked KV travel src -> dst as a payload?"""
        return True

    def _detach_swapped(self, src: Replica, req: Request) -> Optional[int]:
        return src.detach_swapped(req)

    def _receive_swapped(self, dst: Replica, req: Request, t_arr: float,
                         tokens: int) -> bool:
        return dst.receive_swapped(req, t_arr, tokens)

    def _live_ok(self, src: Replica, dst: Replica, req: Request) -> bool:
        """May ``req``'s live decode state travel src -> dst?"""
        return True

    def _detach_live(self, src: Replica, req: Request) -> Optional[int]:
        return src.detach_live(req)

    def _receive_live(self, dst: Replica, req: Request, t_arr: float,
                      tokens: int) -> None:
        dst.receive_live(req, t_arr, tokens)

    def _offload_relegated(self, t: float,
                           snaps: Sequence[ReplicaSnapshot]) -> None:
        for si, src in enumerate(self.replicas):
            src_cost = replica_cost(src)
            for req in list(src.relegated_queue):
                if req.migrations >= self.max_migrations:
                    continue
                di = self._least_loaded(snaps, req, exclude=si)
                if di is None:
                    continue
                # re-homing only helps when the destination has genuinely
                # SPARE capacity — shuffling relegated work between two
                # busy replicas just spreads the interference around
                if snaps[di].load_s >= self.spare_s:
                    continue
                dst = self.replicas[di]
                dst_cost = replica_cost(dst)
                swapped = src.kv.swapped_tokens(req.rid)

                # staying local: remaining prefill behind the local load,
                # plus the swap-in the request would pay on local resume
                t_src = snaps[si].load_s + prefill_seconds(src, [req])
                if swapped and src_cost is not None:
                    t_src += src_cost.host_transfer_time(
                        src.kv.swap_in_bytes(req.rid))

                # option A (PR-1 recompute): free everything, full
                # re-prefill at the destination
                t_rc = snaps[di].load_s + full_prefill_seconds(dst, req)
                # option B (KV transfer): prefilled KV crosses the link
                # into the destination's host tier; remaining prefill plus
                # a swap-in there
                t_tx = float("inf")
                nbytes = 0.0
                if swapped and dst_cost is not None \
                        and self._transfer_ok(src, dst, req):
                    nbytes = dst_cost.kv_transfer_bytes(req.prefilled)
                    if self._host_room(dst, blocks_for(req.prefilled,
                                                       dst.kv.block_size)):
                        t_tx = (snaps[di].load_s
                                + dst_cost.link_transfer_time(nbytes)
                                + dst_cost.host_transfer_time(nbytes)
                                + prefill_seconds(dst, [req]))

                t_dst, transfer = (t_tx, True) if t_tx < t_rc \
                    else (t_rc, False)
                if t_dst + self.offload_margin_s >= t_src:
                    continue
                if transfer:
                    tokens = self._detach_swapped(src, req)
                    if tokens is None:
                        continue
                    req.phase = Phase.QUEUED
                    # nbytes was sized from req.prefilled == tokens; reuse
                    # it so decision, pause, and report cannot diverge
                    t_arr = max(t, src.now) \
                        + dst_cost.link_transfer_time(nbytes)
                    if not self._receive_swapped(dst, req, t_arr, tokens):
                        # raced out of host room: fall back to recompute
                        req.prefilled = 0
                        req.cache_hit_tokens = 0
                        self._deliver(req, src, di, t, "offload", snaps)
                        self.report.offloads += 1
                        continue
                    self._record_move(req, src, di, t, "offload-transfer",
                                      snaps, nbytes=nbytes, t_arr=t_arr)
                    self.report.offload_transfers += 1
                    self.report.kv_moved_bytes += nbytes
                else:
                    if not src.take_for_migration(req):
                        continue
                    self._deliver(req, src, di, t, "offload", snaps)
                    self.report.offloads += 1

    def _rebalance_queued(self, t: float,
                          snaps: Sequence[ReplicaSnapshot]) -> None:
        for _ in range(self.max_moves_per_tick):
            order = sorted(range(len(snaps)),
                           key=lambda i: snaps[i].backlog_s)
            lo, hi = order[0], order[-1]
            if snaps[hi].backlog_s - snaps[lo].backlog_s <= self.imbalance_s:
                return
            src = self.replicas[hi]
            moved = False
            # newest queued work first: it is served last locally, so it
            # loses the least by restarting its wait elsewhere
            for req in reversed(src.prefill_queue):
                if req.phase != Phase.QUEUED \
                        or src.kv.private_blocks(req.rid) != 0 \
                        or req.migrations >= self.max_migrations:
                    continue
                if self.allowed is not None \
                        and lo not in self.allowed(req):
                    continue
                # don't overshoot: moving must not just swap the imbalance.
                # The request may cost differently on each side (mixed
                # fleets), so judge the destination with ITS cost model —
                # and from ZERO prefilled: detaching discards any local
                # prefix-cache hit, so the destination may pay full price
                est_dst = full_prefill_seconds(self.replicas[lo], req)
                if snaps[lo].backlog_s + est_dst >= snaps[hi].backlog_s:
                    continue
                est_src = prefill_seconds(src, [req])
                if not src.take_for_migration(req):
                    continue
                snaps[hi].backlog_s -= est_src
                snaps[hi].n_queued -= 1
                self._deliver(req, src, lo, t, "rebalance", snaps)
                self.report.rebalances += 1
                moved = True
                break
            if not moved:
                return

    def _migrate_live(self, t: float,
                      snaps: Sequence[ReplicaSnapshot]) -> None:
        """Live KV-transfer migration: move in-flight decode requests off
        KV-pressured replicas. The request's whole attention cache crosses
        the inter-replica link; it emits no tokens for exactly the modeled
        transfer time, then resumes decoding at the destination."""
        moved = 0
        for si, src in enumerate(self.replicas):
            if snaps[si].kv_util < self.kv_pressure:
                continue
            # longest contexts first: they free the most blocks per move
            for req in sorted(src.decode_queue, key=lambda r: -r.total_len):
                if snaps[si].kv_util < self.kv_pressure:
                    break   # source relieved by an earlier move
                if moved >= self.max_live_per_tick:
                    return
                if req.migrations >= self.max_migrations:
                    continue
                # destination: the most KV-relieved allowed peer (this
                # pass trades KV headroom, not backlog — the rebalance
                # pass already handles backlog)
                idxs = list(self.allowed(req)) if self.allowed is not None \
                    else range(len(self.replicas))
                idxs = [i for i in idxs if i != si]
                if not idxs:
                    continue
                di = min(idxs, key=lambda i: (snaps[i].kv_util, i))
                if snaps[di].kv_util > self.kv_relief:
                    continue
                dst = self.replicas[di]
                dst_cost = replica_cost(dst)
                if dst_cost is None:
                    continue
                nbytes = dst_cost.kv_transfer_bytes(req.total_len)
                pause = dst_cost.link_transfer_time(nbytes)
                # the pause stalls the victim's own token stream: cap it
                # by the flat limit AND, for interactive requests, by half
                # the per-token TBT budget so migration cannot itself
                # breach the SLO it is trying to protect
                limit = self.max_live_pause_s
                if req.qos.interactive and req.qos.tbt_slo is not None:
                    limit = min(limit, 0.5 * req.qos.tbt_slo)
                if pause > limit:
                    continue
                # destination must fit the context plus decode headroom
                need = blocks_for(req.total_len, dst.kv.block_size) + 4
                if dst.kv.free < need:
                    continue
                if not self._live_ok(src, dst, req):
                    continue
                tokens = self._detach_live(src, req)
                if tokens is None:
                    continue
                t_arr = max(t, src.now) + pause
                self._receive_live(dst, req, t_arr, tokens)
                # a live move shifts decode state, not prefill backlog
                self._record_move(req, src, di, t, "live", snaps,
                                  count_backlog=False, nbytes=nbytes,
                                  t_arr=t_arr)
                snaps[di].kv_util = dst.kv.utilization()
                snaps[si].kv_util = src.kv.utilization()
                self.report.live_migrations += 1
                self.report.kv_moved_bytes += nbytes
                moved += 1

    # ------------------------------------------------ telemetry
    def _observe(self, t_end: float,
                 snaps: Sequence[ReplicaSnapshot]) -> None:
        r = self.report
        backlogs = [s.backlog_s for s in snaps]
        r.peak_backlog_s = max(r.peak_backlog_s, max(backlogs))
        r.peak_kv_util = max(r.peak_kv_util, max(s.kv_util for s in snaps))
        r.backlog_imbalance_s = max(r.backlog_imbalance_s,
                                    max(backlogs) - min(backlogs))
        r.max_overshoot_s = max(r.max_overshoot_s,
                                max(s.now - t_end for s in snaps))
        r.peak_host_util = max(r.peak_host_util,
                               max(s.host_util for s in snaps))
        if self.registry is not None:
            # lazy import: the serving stack must not depend on
            # repro_torch.obs unless a registry is actually installed
            from repro_torch.obs.scrape import scrape_fleet
            scrape_fleet(self.registry, self)

    def _finalize(self) -> None:
        r = self.report
        r.iterations = sum(rep.iterations for rep in self.replicas)
        r.busy_time = sum(rep.busy_time for rep in self.replicas)
        if self.replicas:
            r.mean_kv_util = (sum(rep.kv.utilization()
                                  for rep in self.replicas)
                              / len(self.replicas))
            rates = [rep.kv.prefix_hit_rate() for rep in self.replicas
                     if hasattr(rep.kv, "prefix_hit_rate")]
            if rates:
                r.prefix_hit_rate = sum(rates) / len(rates)

    # ------------------------------------------------ results
    def finished(self) -> List[Request]:
        return [r for rep in self.replicas for r in rep.finished]

    def all_requests(self) -> List[Request]:
        """Every request the fleet was ever responsible for — finished or
        still stuck in any queue (including never-admitted intake)."""
        out: List[Request] = []
        for _, _, req in self._pending:
            out.append(req)
        for rep in self.replicas:
            out.extend(rep.all_requests())
        return out
