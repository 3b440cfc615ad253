"""SLO-violation attribution: fold a request's trace events into a
dominant-cause latency breakdown (docs/observability.md §Attribution).

Taxonomy — each second of a request's end-to-end latency lands in exactly
one bin, so the bins sum to ``finish - arrival`` by construction (the
property tests/test_obs.py locks down):

  queue_wait          waiting before its FIRST executed chunk
  chunk_contention    waiting between executions (other requests' chunks
                      and decode batches occupy the iterations)
  relegation_parking  parked in a relegated queue (relegate -> resume,
                      or -> migrate when the fleet re-homed it)
  migration_pause     in flight between replicas (decision -> delivery)
  backpressure_defer  re-queued by engine backpressure (the gap that
                      follows a ``defer`` event naming the request)
  service             predicted COMPUTE time of its iterations (from
                      ``BatchPlan.predicted_time`` minus the collective
                      term — an iteration is attributed whole to every
                      participant; batch sharing is documented, not
                      amortized)
  collective_overhead the tensor-parallel collective share of the
                      predicted iteration time (``comm_s`` in the
                      scheduler trace; 0.0 for single-device replicas)
  predictor_error     actual minus predicted iteration time, the
                      roofline model's miss (may be negative)

The dominant cause of a violated request is the largest of the seven
*cause* bins (``service`` is execution, not a pathology; a request whose
latency is all service is reported as dominant-cause ``service``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

#: the attributable causes (everything except inherent service time)
CAUSES = ("queue_wait", "chunk_contention", "relegation_parking",
          "migration_pause", "backpressure_defer", "predictor_error",
          "collective_overhead")

_EPS = 1e-9


class _ReqEvents:
    __slots__ = ("arrive", "enqueue", "service", "relegates", "resumes",
                 "migrates", "defers", "finish")

    def __init__(self):
        self.arrive: Optional[float] = None
        self.enqueue: Optional[float] = None
        self.service: List[tuple] = []     # (t0, t1, predicted, comm_s)
        self.relegates: List[float] = []
        self.resumes: List[float] = []
        self.migrates: List[tuple] = []    # (t, t_arr)
        self.defers: List[float] = []
        self.finish: Optional[float] = None


class Attribution:
    """Pre-indexed view over a recorder's events with a per-request
    ``explain(rid)`` API and an aggregate pass over violated requests."""

    def __init__(self, events):
        if hasattr(events, "events"):      # a TraceRecorder
            events = events.events()
        self._by_rid: Dict[int, _ReqEvents] = {}
        self._index(events)

    def _req(self, rid: int) -> _ReqEvents:
        r = self._by_rid.get(rid)
        if r is None:
            r = self._by_rid[rid] = _ReqEvents()
        return r

    def _index(self, events: Iterable[dict]) -> None:
        for ev in events:
            kind = ev["kind"]
            t = ev["t"]
            if kind == "iter":
                t0, t1 = ev["t0"], ev["t0"] + ev["elapsed"]
                pred = ev["predicted"]
                comm = float((ev.get("sched") or {}).get("comm_s") or 0.0)
                seen = set()
                for rid, _chunk in ev["prefill"]:
                    if rid not in seen:
                        seen.add(rid)
                        self._req(rid).service.append((t0, t1, pred, comm))
                for rid in ev["decode"]:
                    if rid not in seen:
                        seen.add(rid)
                        self._req(rid).service.append((t0, t1, pred, comm))
            elif kind == "arrive":
                r = self._req(ev["rid"])
                if r.arrive is None or t < r.arrive:
                    r.arrive = t
            elif kind == "enqueue":
                r = self._req(ev["rid"])
                if r.enqueue is None:
                    r.enqueue = t
            elif kind == "relegate":
                self._req(ev["rid"]).relegates.append(t)
            elif kind == "resume":
                self._req(ev["rid"]).resumes.append(t)
            elif kind == "migrate":
                self._req(ev["rid"]).migrates.append((t, ev["t_arr"]))
            elif kind == "defer":
                for rid in ev["rids"]:
                    self._req(rid).defers.append(t)
            elif kind in ("finish", "abort"):
                self._req(ev["rid"]).finish = t

    def known(self, rid: int) -> bool:
        return rid in self._by_rid

    # ------------------------------------------------ per-request
    def explain(self, rid: int) -> dict:
        """Latency breakdown for ``rid``. ``breakdown`` values sum to
        ``t1 - t0`` (end-to-end) within float tolerance; ``dominant`` is
        the largest cause bin, or "service" when no cause contributed."""
        r = self._by_rid.get(rid)
        zero = {c: 0.0 for c in CAUSES}
        zero["service"] = 0.0
        if r is None:
            return {"rid": rid, "t0": None, "t1": None, "e2e": 0.0,
                    "finished": False, "breakdown": zero, "dominant": None}
        events_max = max(
            [r.arrive or 0.0, r.enqueue or 0.0]
            + [t1 for _, t1, *_ in r.service] + r.relegates + r.resumes
            + [ta for _, ta in r.migrates] + r.defers
            + ([r.finish] if r.finish is not None else []))
        t0 = r.arrive if r.arrive is not None else (
            r.enqueue if r.enqueue is not None else events_max)
        t1 = r.finish if r.finish is not None else events_max
        bd = dict(zero)
        if t1 <= t0 + _EPS:
            return {"rid": rid, "t0": t0, "t1": t1, "e2e": max(t1 - t0, 0.0),
                    "finished": r.finish is not None,
                    "breakdown": bd, "dominant": None}

        # typed intervals: parks pair each relegate with the next
        # resume/migration-decision after it (else the end of the window)
        ivs: List[tuple] = [(s, e, "service", p, c)
                            for s, e, p, c in r.service]
        ends = sorted(r.resumes + [t for t, _ in r.migrates])
        for t_rel in r.relegates:
            t_res = next((x for x in ends if x >= t_rel - _EPS), t1)
            ivs.append((t_rel, t_res, "relegation_parking", 0.0, 0.0))
        for t_dec, t_arr in r.migrates:
            ivs.append((t_dec, t_arr, "migration_pause", 0.0, 0.0))
        ivs.sort(key=lambda iv: (iv[0], iv[1]))

        first_service = min((s for s, _, k, _, _ in ivs if k == "service"),
                            default=None)
        defers = sorted(r.defers)

        def classify(a: float, b: float) -> str:
            # a gap opened by an engine-backpressure deferral of THIS
            # request is backpressure; before first execution it is queue
            # wait; afterwards it is contention for iteration slots
            if any(a - _EPS <= d < b - _EPS for d in defers):
                return "backpressure_defer"
            if first_service is None or b <= first_service + _EPS:
                return "queue_wait"
            return "chunk_contention"

        cursor = t0
        service_actual = 0.0
        service_predicted = 0.0
        service_comm = 0.0
        for s, e, kindname, pred, comm in ivs:
            s = max(s, cursor, t0)
            e = min(e, t1)
            if e <= cursor + _EPS:
                continue
            if s > cursor:
                bd[classify(cursor, s)] += s - cursor
            dur = e - s
            if kindname == "service":
                service_actual += dur
                service_predicted += pred
                service_comm += comm
            else:
                bd[kindname] += dur
            cursor = e
        if t1 > cursor:
            bd[classify(cursor, t1)] += t1 - cursor
        # the TP collective share of predicted time is carved out of
        # service into its own cause bin, so the bins still sum to e2e
        bd["service"] = service_predicted - service_comm
        bd["collective_overhead"] = service_comm
        bd["predictor_error"] = service_actual - service_predicted

        best = max(CAUSES, key=lambda c: bd[c])
        dominant = best if bd[best] > _EPS else "service"
        return {"rid": rid, "t0": t0, "t1": t1, "e2e": t1 - t0,
                "finished": r.finish is not None,
                "breakdown": bd, "dominant": dominant}


def attribute(events, requests: Sequence) -> dict:
    """Aggregate attribution over ``requests`` (Request objects): for
    every SLO-violated request, find its dominant cause. Returns the
    attribution table the benches render and ``MetricsReport`` absorbs."""
    att = events if isinstance(events, Attribution) else Attribution(events)
    violated = [q for q in requests if q.violated()]
    causes: Dict[str, int] = {}
    by_rid: Dict[int, str] = {}
    sums: Dict[str, float] = {}
    n_attr = 0
    for q in violated:
        ex = att.explain(q.rid)
        dom = ex["dominant"]
        if dom is not None:
            n_attr += 1
            causes[dom] = causes.get(dom, 0) + 1
            by_rid[q.rid] = dom
            for k, v in ex["breakdown"].items():
                sums[k] = sums.get(k, 0.0) + v
    n_v = len(violated)
    mean_bd = {k: v / n_attr for k, v in sums.items()} if n_attr else {}
    return {"n_requests": len(requests), "n_violated": n_v,
            "n_attributed": n_attr,
            "coverage": n_attr / n_v if n_v else 1.0,
            "causes": dict(sorted(causes.items(),
                                  key=lambda kv: -kv[1])),
            "mean_breakdown": mean_bd, "by_rid": by_rid}


def render_attribution_table(summary: dict) -> str:
    """Human-readable dominant-cause table (serve.py / CI artifact)."""
    lines = [f"SLO-violation attribution: "
             f"{summary['n_attributed']}/{summary['n_violated']} violated "
             f"requests attributed "
             f"({summary['coverage']:.1%} coverage, "
             f"{summary['n_requests']} total)"]
    n = max(summary["n_attributed"], 1)
    lines.append(f"  {'dominant cause':<20} {'requests':>8} {'share':>7}")
    for cause, cnt in summary["causes"].items():
        lines.append(f"  {cause:<20} {cnt:>8} {cnt / n:>6.1%}")
    if summary["mean_breakdown"]:
        lines.append("  mean latency breakdown of a violated request:")
        for k, v in sorted(summary["mean_breakdown"].items(),
                           key=lambda kv: -abs(kv[1])):
            lines.append(f"    {k:<20} {v:>9.3f}s")
    return "\n".join(lines)


def annotate_report(report, summary: dict) -> None:
    """Fold an attribution summary into a ``MetricsReport``."""
    report.attributed_frac = float(summary["coverage"])
    report.violation_causes = {k: int(v)
                               for k, v in summary["causes"].items()}
