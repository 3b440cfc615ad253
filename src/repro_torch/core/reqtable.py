"""Array-backed request views — the scheduler hot path's working set.

Two columnar structures back the vectorized hot path (docs/perf.md):

``RequestTable``
    A per-``schedule()`` snapshot of the prefill candidate list. Built in
    queue order (so the prefill-estimate memo sees cache misses in exactly
    the order the scalar reference produced them — the memo's coarse-grid
    buckets are first-caller-wins), it carries the five columns priority
    keys, violation verdicts, and the backlog need:

      deadline_first  — arrival + TTFT/TTLT SLO (QoSSpec.deadline_first)
      work            — remaining-work estimate: T(prefill_rem) for
                        interactive, T(prefill_rem) + T(decode_rem_est)
                        for batch — the term both eq-4/5 keys and the
                        violation completion estimate share
      was_relegated / important — the relegation-policy partitions

    plus the backlog (sequential sum of prefill estimates) and the
    strictest interactive TTFT, folded into the same build pass. Every
    derived value replicates the scalar arithmetic operation-for-
    operation, so vectorized decisions are bit-identical to the
    per-Request reference (property-tested in tests/test_hotpath.py).

``DecodeTable``
    The *incrementally maintained* mirror of a replica's decode queue:
    appended on admit, shifted on finish/migrate, and bumped once per
    iteration when every batched decode gains a token — instead of being
    rebuilt from ``Request`` objects every scheduling call. Static key
    components (arrival + SLO deadline bases) are computed once on append.

The per-request ``_pf_est``/``_pf_full_est``/``_t1_est`` slots cache the
last (cost-model, args, value) estimate per request; they only bypass
memo lookups that would hit anyway, so values are unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .predictor import DecodeLengthEstimator, ModelCostModel
from .request import Phase, Request

_INF = float("inf")
_NAN = float("nan")

# columns carried through select()/extend(); reqs is handled alongside
# (est_prefill backs the backlog sum only and is not resliced)
_RT_COLS = ("deadline_first", "work", "was_relegated", "important")


def prefill_est_cached(cost: ModelCostModel, req: Request) -> float:
    """``cost.prefill_time_estimate(req.prefill_remaining, req.prefilled)``
    with a per-request fast path. Keyed on the model's ``cache_token``
    (distinct per model AND minted anew by ``calibrate()``) plus both
    args, so neither migrations between heterogeneous replicas nor
    post-calibration constants reuse a stale value."""
    pf = req.prefilled
    pl = req.prompt_len
    rem = pl - pf if pl > pf else 0
    c = req._pf_est
    if c is not None and c[0] is cost.cache_token and c[1] == rem \
            and c[2] == pf:
        return c[3]
    v = cost.prefill_time_estimate(rem, pf)
    req._pf_est = (cost.cache_token, rem, pf, v)
    return v


def full_prefill_est_cached(cost: ModelCostModel, req: Request) -> float:
    """``cost.prefill_time_estimate(req.prompt_len, 0)`` (the from-zero
    migration estimate), cached per request (same keying as above)."""
    pl = req.prompt_len
    c = req._pf_full_est
    if c is not None and c[0] is cost.cache_token and c[1] == pl:
        return c[2]
    v = cost.prefill_time_estimate(pl, 0)
    req._pf_full_est = (cost.cache_token, pl, v)
    return v


def decode_t1_cached(cost: ModelCostModel, req: Request) -> float:
    """Per-token decode time at this request's prompt context (the
    ``decode_time_estimate`` kernel), cached per request (same keying)."""
    pl = req.prompt_len
    c = req._t1_est
    if c is not None and c[0] is cost.cache_token and c[1] == pl:
        return c[2]
    # same arithmetic as decode_time_estimate's memoized t1
    v = cost.decode_time_estimate(1, pl)
    req._t1_est = (cost.cache_token, pl, v)
    return v


def _compute_row(r: Request, cost: ModelCostModel, token, e_ver: int,
                 inter: bool, slo: float, ecache: dict, eest) -> tuple:
    """The canonical per-request row: (token, prefilled, decoded,
    est-version-or-None, deadline_first, work, prefill_est, interactive,
    slo). Single definition shared by the per-call build and the
    persistent-table sync so the two paths cannot drift — the arithmetic
    here IS the scalar reference's (hybrid_key / check_* forms)."""
    t_p = prefill_est_cached(cost, r)
    if inter:
        w = t_p
    else:
        # scalar form: dec_rem = max(0.0, est(app) - decoded);
        # t_d = decode_time_estimate(int(dec_rem), prompt_len)
        ed = ecache.get(r.app_id)
        if ed is None:
            ed = eest(r.app_id)
        dr = ed - r.decoded
        nt = int(dr) if dr > 0.0 else 0
        w = t_p + (nt * decode_t1_cached(cost, r) if nt > 0 else 0.0)
    return (token, r.prefilled, r.decoded, None if inter else e_ver,
            r.arrival + slo, w, t_p, inter, slo)


class RequestTable:
    """Columnar view over one candidate list (one schedule() call).

    Rows are additionally memoized per request (``Request._row``): a row
    only recomputes when its inputs — prefilled tokens, decoded tokens, or
    (for batch requests) the decode-length estimator state — changed since
    the last build. Recomputation happens inside the build loop, i.e. in
    queue order, preserving the scalar reference's memo first-touch
    order."""

    __slots__ = ("n", "reqs", "backlog", "min_ttft", "est_prefill") \
        + _RT_COLS

    def __init__(self, reqs: Sequence[Request],
                 cost: Optional[ModelCostModel] = None,
                 est: Optional[DecodeLengthEstimator] = None,
                 _empty: bool = False):
        self.reqs = list(reqs)
        n = self.n = len(self.reqs)
        if _empty:
            return
        d_first: list = []
        work: list = []
        est_pf: list = []
        wrel: list = []
        imp: list = []
        ap_d = d_first.append
        ap_w = work.append
        ap_e = est_pf.append
        ap_r = wrel.append
        ap_i = imp.append
        backlog = 0
        min_ttft = _INF
        qos_cache: Dict[int, tuple] = {}
        ecache = est._est_cache if est is not None else {}
        eest = est.estimate if est is not None else None
        e_ver = est.version if est is not None else 0
        token = cost.cache_token if cost is not None else None
        for r in self.reqs:
            row = r._row
            if row is not None and row[0] is token \
                    and row[1] == r.prefilled and row[2] == r.decoded \
                    and (row[3] is None or row[3] == e_ver):
                d_f, w, t_p, inter, slo = row[4], row[5], row[6], \
                    row[7], row[8]
            else:
                q = r.qos
                cached = qos_cache.get(id(q))
                if cached is None:
                    cached = (q.interactive,
                              q.ttft_slo if q.interactive else q.ttlt_slo)
                    qos_cache[id(q)] = cached
                inter, slo = cached
                row = _compute_row(r, cost, token, e_ver, inter, slo,
                                   ecache, eest)
                r._row = row
                d_f, w, t_p = row[4], row[5], row[6]
            backlog += t_p
            if inter and slo < min_ttft:
                min_ttft = slo
            ap_e(t_p)
            ap_w(w)
            ap_d(d_f)
            ap_r(r.was_relegated)
            ap_i(r.important)
        self.backlog = backlog
        self.min_ttft = None if min_ttft == _INF else min_ttft
        self.deadline_first = np.asarray(d_first)
        self.work = np.asarray(work)
        self.est_prefill = np.asarray(est_pf)
        self.was_relegated = np.asarray(wrel, dtype=bool)
        self.important = np.asarray(imp, dtype=bool)

    # ---------------- restructuring ----------------
    def select(self, idx: np.ndarray) -> "RequestTable":
        out = RequestTable([self.reqs[i] for i in idx], _empty=True)
        for col in _RT_COLS:
            setattr(out, col, getattr(self, col)[idx])
        return out

    def extend(self, other: "RequestTable") -> "RequestTable":
        if other.n == 0:
            return self
        out = RequestTable(self.reqs + other.reqs, _empty=True)
        for col in _RT_COLS:
            setattr(out, col,
                    np.concatenate([getattr(self, col),
                                    getattr(other, col)]))
        return out


class PrefillTable:
    """Persistent columnar mirror of a replica's prefill queue.

    Row ``i`` describes the ``i``-th queue member. Columns are synced
    *lazily and in queue order* by :meth:`sync` — a row is rewritten only
    when its ``Request._row`` memo is stale (prefilled/decoded/estimator
    state changed) or was produced elsewhere (identity-tracked via
    ``_stamps``); recomputation therefore touches the prefill-estimate
    memo in exactly the order the per-call build (and the scalar
    reference) would. The per-row prefill estimates live in a Python
    list so the backlog remains the queue-order sequential float sum.
    Tier counts and the interactive-TTFT multiset are maintained on
    append/remove for O(1) snapshot reads."""

    __slots__ = ("n", "_cap", "d_first", "work", "est_pf", "wrel", "imp",
                 "inter", "slo", "_stamps", "ttft_counts", "tier_counts",
                 "_mut", "_dirty", "_view_cache")

    _NPCOLS = ("d_first", "work", "wrel", "imp", "inter", "slo")

    def __init__(self, cap: int = 64):
        self.n = 0
        self._cap = cap
        self.d_first = np.empty(cap)
        self.work = np.empty(cap)
        self.wrel = np.empty(cap, dtype=bool)
        self.imp = np.empty(cap, dtype=bool)
        self.inter = np.empty(cap, dtype=bool)
        self.slo = np.empty(cap)
        self.est_pf: list = []
        self._stamps: list = []
        self.ttft_counts: Dict[float, int] = {}
        self.tier_counts: Dict[str, int] = {}
        self._mut = 0          # membership changes
        self._dirty = 0        # row-content changes (chunks landed)
        self._view_cache = None  # (mut, dirty, est_version, cost, view)

    def _grow(self) -> None:
        self._cap *= 2
        for name in self._NPCOLS:
            old = getattr(self, name)
            new = np.empty(self._cap, dtype=old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def note_prefilled(self) -> None:
        """A member's prefilled count changed (chunk landed / swap state
        moved): row contents must be re-validated at the next sync."""
        self._dirty += 1

    def append(self, req: Request) -> None:
        """Register a new queue member. Row values are NOT computed here
        — the next sync() fills them in queue order, so memo first-touch
        order matches the per-call build."""
        if self.n == self._cap:
            self._grow()
        i = self.n
        q = req.qos
        self.wrel[i] = req.was_relegated
        self.imp[i] = req.important
        self.inter[i] = q.interactive
        self.slo[i] = q.ttft_slo if q.interactive else q.ttlt_slo
        if q.interactive:
            tc = self.ttft_counts
            tc[q.ttft_slo] = tc.get(q.ttft_slo, 0) + 1
        m = self.tier_counts
        m[q.name] = m.get(q.name, 0) + 1
        self.est_pf.append(0.0)
        self._stamps.append(None)
        self.n = i + 1
        self._mut += 1

    def remove_at(self, i: int, req: Request) -> None:
        n = self.n
        q = req.qos
        if q.interactive:
            tc = self.ttft_counts
            c = tc[q.ttft_slo] - 1
            if c:
                tc[q.ttft_slo] = c
            else:
                del tc[q.ttft_slo]
        m = self.tier_counts
        c = m[q.name] - 1
        if c:
            m[q.name] = c
        else:
            del m[q.name]
        for name in self._NPCOLS:
            col = getattr(self, name)
            col[i: n - 1] = col[i + 1: n]
        self.est_pf.pop(i)
        self._stamps.pop(i)
        self.n = n - 1
        self._mut += 1

    def rebuild(self, reqs: Sequence[Request]) -> None:
        self.n = 0
        self.est_pf.clear()
        self._stamps.clear()
        self.ttft_counts.clear()
        self.tier_counts.clear()
        self._mut += 1
        for r in reqs:
            self.append(r)

    def backlog_queued(self) -> float:
        """Queue-order sequential sum of prefill estimates (valid right
        after a sync())."""
        return sum(self.est_pf)

    def min_ttft(self) -> Optional[float]:
        return min(self.ttft_counts) if self.ttft_counts else None

    def sync(self, members: Sequence[Request],
             cost: ModelCostModel,
             est: DecodeLengthEstimator) -> Optional[RequestTable]:
        """Refresh stale rows (queue order) and return a RequestTable
        view over the live column slices. Returns None when a member is
        in an unexpected phase (caller falls back to the per-call build
        — queue membership normally implies QUEUED/PREFILL)."""
        c = self._view_cache
        e_ver0 = est.version
        token = cost.cache_token
        if c is not None and c[0] == self._mut and c[1] == self._dirty \
                and c[2] == e_ver0 and c[3] is token:
            # nothing changed since the last sync — including phases: any
            # phase transition of a member either removes it from the
            # queue (_mut) or lands a chunk (note_prefilled -> _dirty),
            # so the sweep's per-member phase guard has already run on
            # exactly this state
            return c[4]
        _q, _p = Phase.QUEUED, Phase.PREFILL
        n = self.n
        d_first = self.d_first
        work = self.work
        est_pf = self.est_pf
        stamps = self._stamps
        ecache = est._est_cache
        eest = est.estimate
        e_ver = est.version
        for i, r in enumerate(members):
            if r.phase is not _q and r.phase is not _p:
                return None
            row = r._row
            if row is not None and row[0] is token \
                    and row[1] == r.prefilled and row[2] == r.decoded \
                    and (row[3] is None or row[3] == e_ver):
                if stamps[i] is row:
                    continue
            else:
                row = _compute_row(r, cost, token, e_ver,
                                   bool(self.inter[i]), float(self.slo[i]),
                                   ecache, eest)
                r._row = row
            d_first[i] = row[4]
            work[i] = row[5]
            est_pf[i] = row[6]
            stamps[i] = row
        tab = RequestTable(members, _empty=True)
        tab.deadline_first = d_first[:n]
        tab.work = work[:n]
        tab.est_prefill = None
        tab.was_relegated = self.wrel[:n]
        tab.important = self.imp[:n]
        tab.backlog = sum(est_pf)
        tab.min_ttft = self.min_ttft()
        self._view_cache = (self._mut, self._dirty, e_ver0, token, tab)
        return tab


class DecodeTable:
    """Incrementally-maintained columns mirroring a decode queue.

    Row ``i`` always describes the ``i``-th request of the owning queue.
    ``base_next`` is the static part of the eq-2 next-token deadline
    (arrival + SLO_TTFT) and ``deadline_total`` the eq-3 total deadline —
    computed once on append, never re-derived."""

    __slots__ = ("n", "_cap", "_mut", "_bumps", "ctx", "decoded",
                 "base_next", "tbt", "deadline_total", "interactive",
                 "last_token", "apps", "_slack_cache", "_agg_cache")

    _COLS = ("ctx", "decoded", "base_next", "tbt", "deadline_total",
             "interactive", "last_token")

    def __init__(self, cap: int = 64):
        self.n = 0
        self._cap = cap
        self._mut = 0            # bumped on membership changes
        self._bumps = 0          # bumped once per token round
        self._slack_cache = None  # (mut, k, est_version, inter, any, ev)
        self._agg_cache = None    # (mut, bumps, k, (dec_f, dec_b))
        self.ctx = np.empty(cap, dtype=np.int64)
        self.decoded = np.empty(cap, dtype=np.int64)
        self.base_next = np.empty(cap)
        self.tbt = np.empty(cap)
        self.deadline_total = np.empty(cap)
        self.interactive = np.empty(cap, dtype=bool)
        self.last_token = np.empty(cap)
        self.apps: List[str] = []

    def _grow(self) -> None:
        self._cap *= 2
        for name in self._COLS:
            old = getattr(self, name)
            new = np.empty(self._cap, dtype=old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def append(self, req: Request) -> None:
        if self.n == self._cap:
            self._grow()
        i = self.n
        q = req.qos
        self.ctx[i] = req.prompt_len + req.decoded
        self.decoded[i] = req.decoded
        self.interactive[i] = q.interactive
        if q.interactive:
            self.base_next[i] = req.arrival + q.ttft_slo
            self.tbt[i] = q.tbt_slo
            self.deadline_total[i] = _INF
        else:
            self.base_next[i] = _NAN
            self.tbt[i] = _NAN
            self.deadline_total[i] = req.arrival + q.ttlt_slo
        self.last_token[i] = (req.token_times[-1] if req.token_times
                              else _NAN)
        self.apps.append(req.app_id)
        self.n = i + 1
        self._mut += 1

    def remove_at(self, i: int) -> None:
        n = self.n
        for name in self._COLS:
            col = getattr(self, name)
            col[i: n - 1] = col[i + 1: n]
        self.apps.pop(i)
        self.n = n - 1
        self._mut += 1

    def bump_tokens(self, k: int, t_end: float) -> None:
        """The first ``k`` rows (this iteration's decode batch) each
        emitted one token at ``t_end``."""
        self.ctx[:k] += 1
        self.decoded[:k] += 1
        self.last_token[:k] = t_end
        self._bumps += 1

    def decode_agg(self, cost: ModelCostModel, k: int):
        """(flops, bytes) decode-batch aggregate over the first ``k`` rows
        — ``cost.attn_decode_cost_batch(ctx[:k])`` computed once per token
        round. The aggregate depends only on the model *config*, so the
        scheduler's model, the chunk solver, and the sim oracle (same
        config, perturbed hardware) all share it."""
        c = self._agg_cache
        if c is not None and c[0] == self._mut and c[1] == self._bumps \
                and c[2] == k and c[3] is cost.cfg:
            return c[4]
        agg = cost.attn_decode_cost_batch(self.ctx[:k])
        self._agg_cache = (self._mut, self._bumps, k, cost.cfg, agg)
        return agg

    def rebuild(self, reqs: Sequence[Request]) -> None:
        self.n = 0
        self.apps.clear()
        self._mut += 1
        for r in reqs:
            self.append(r)

    def ctx_view(self, k: int) -> np.ndarray:
        return self.ctx[:k]

    def consistent_with(self, reqs: Sequence[Request]) -> bool:
        """Debug/test invariant: rows mirror the request objects."""
        if self.n != len(reqs):
            return False
        for i, r in enumerate(reqs):
            if (self.ctx[i] != r.prompt_len + r.decoded
                    or self.decoded[i] != r.decoded
                    or self.apps[i] != r.app_id):
                return False
            if r.token_times and self.last_token[i] != r.token_times[-1]:
                return False
        return True

    def _slack_columns(self, k: int, est: DecodeLengthEstimator):
        """(interactive mask, any_batch, per-app decode estimates) for the
        first ``k`` rows; the estimate column (NaN on interactive rows) is
        cached until queue membership or estimator state changes — both
        rare relative to iterations."""
        c = self._slack_cache
        if c is not None and c[0] == self._mut and c[1] == k \
                and c[2] == est.version:
            return c[3], c[4], c[5]
        inter = self.interactive[:k]
        any_batch = not inter.all()
        if any_batch:
            apps = self.apps
            ecache = est._est_cache
            eest = est.estimate
            ev = np.empty(k)
            for i in range(k):
                if inter[i]:
                    ev[i] = _NAN
                else:
                    a = apps[i]
                    v = ecache.get(a)
                    ev[i] = v if v is not None else eest(a)
        else:
            ev = None
        self._slack_cache = (self._mut, k, est.version, inter, any_batch,
                             ev)
        return inter, any_batch, ev


def min_decode_slack_table(tab: DecodeTable, k: int, now: float,
                           est: DecodeLengthEstimator,
                           floor: float = 1e-3,
                           tbt_floor: Optional[float] = None) -> float:
    """Vectorized ``chunking.min_decode_slack`` over the first ``k`` rows
    of a decode table — element-wise identical to the scalar
    ``decode_slack`` calls (same op order, same floors; clamping after the
    min equals min of per-row clamps since max(floor, .) is monotone)."""
    if k == 0:
        return _INF
    inter, any_batch, ev = tab._slack_columns(k, est)
    decoded = tab.decoded[:k]
    # interactive rows: eq-2 next-token deadline, with pacing fallback for
    # already-late streams (NaN rows are batch requests, masked below)
    tbt = tab.tbt[:k]
    sv = (tab.base_next[:k] + decoded * tbt) - now
    late = sv <= 0
    if late.any():
        lt = tab.last_token[:k]
        fix = late & ~np.isnan(lt)
        if fix.any():
            sv = np.where(fix, (lt + tbt) - now, sv)
    out = max(floor, float(np.where(inter, sv, _INF).min()))
    if any_batch:
        # batch rows: TTLT budget spread over estimated remaining tokens
        rem = np.maximum(1.0, ev - decoded)
        s_n = (tab.deadline_total[:k] - now) / rem
        out = min(out, max(floor, float(np.where(inter, _INF, s_n).min())))
    if tbt_floor is not None:
        out = max(out, tbt_floor)
    return out
