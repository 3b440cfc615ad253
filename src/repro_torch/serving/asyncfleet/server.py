"""Asyncio streaming front-end over a wall-mode ``AsyncFleet``.

Grown out of ``launch/serve.py``'s batch driver: instead of submitting a
whole trace and reading metrics at drain, callers ``submit()`` requests
as they arrive and consume per-token events (with wall timestamps) as the
engines produce them. The event loop never touches engine state — it only
reads the thread-safe stream queues the owning ``EngineWorker`` feeds.

Observability (docs/observability.md): the server keeps the per-token
wall timestamps it streams — ``wall_metrics()`` folds them into
wall-clock TTFT/TBT percentiles (the sim-time metrics pipeline cannot
see these) — and, given a ``metrics_port``, serves the fleet's metrics
registry as a Prometheus ``GET /metrics`` endpoint over a minimal
asyncio HTTP listener (zero new dependencies).
"""
from __future__ import annotations

import asyncio
import queue
from typing import AsyncIterator, Dict, List, NamedTuple, Optional

from repro_torch.core.request import Request

from .runtime import AsyncFleet


class TokenEvent(NamedTuple):
    index: int      # position in the request's output stream
    token: int      # token id (-1 from sim-backed replicas)
    t: float        # wall-clock emission time (fleet clock seconds)


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


class AsyncServer:
    """Thin asyncio adapter: ``submit`` registers a stream and hands the
    request to the fleet's streaming intake; ``stream`` yields its
    ``TokenEvent``s as they appear. The fleet must be in wall mode."""

    def __init__(self, fleet: AsyncFleet, poll_s: float = 0.01,
                 registry=None, metrics_port: Optional[int] = None):
        self.fleet = fleet
        self.poll_s = poll_s
        self.metrics_port = metrics_port
        if registry is None and metrics_port is not None:
            from repro_torch.obs import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        if registry is not None and getattr(fleet, "registry", None) is None:
            fleet.registry = registry   # barrier scrapes feed the endpoint
        self.metrics_addr: Optional[tuple] = None   # (host, port) once bound
        self._http_server: Optional[asyncio.AbstractServer] = None
        # per-request wall-time observations (streamed tokens only)
        self._rid_of_queue: Dict[int, int] = {}     # id(queue) -> rid
        self._submit_wall: Dict[int, float] = {}    # rid -> submit time
        self._token_walls: Dict[int, List[float]] = {}

    async def __aenter__(self) -> "AsyncServer":
        self.fleet.start()
        if self.metrics_port is not None:
            await self._start_metrics_server()
        return self

    async def __aexit__(self, *exc) -> None:
        if self._http_server is not None:
            self._http_server.close()
            await self._http_server.wait_closed()
            self._http_server = None
        self.fleet.stop()

    def submit(self, req: Request) -> "queue.Queue":
        """Register the token stream, then hand the request to intake
        (that order, so no token can be emitted unobserved)."""
        q = self.fleet.subscribe(req)
        self._rid_of_queue[id(q)] = req.rid
        self._submit_wall[req.rid] = float(self.fleet.clock.now())
        self.fleet.submit_now(req)
        return q

    async def stream(self, req: Request,
                     timeout: float = 120.0) -> AsyncIterator[TokenEvent]:
        """Submit ``req`` and yield its tokens as the engines emit them."""
        q = self.submit(req)
        async for ev in self.events(q, timeout=timeout):
            yield ev

    async def events(self, q: "queue.Queue",
                     timeout: float = 120.0) -> AsyncIterator[TokenEvent]:
        deadline = self.fleet.clock.now() + timeout
        rid = self._rid_of_queue.get(id(q))
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                if self.fleet.clock.now() > deadline:
                    raise TimeoutError("token stream stalled")
                self.fleet._check_errors()   # dead engine -> fail the stream
                await asyncio.sleep(self.poll_s)
                continue
            if item is None:        # end-of-stream sentinel
                return
            ev = TokenEvent(*item)
            if rid is not None:
                self._token_walls.setdefault(rid, []).append(ev.t)
            yield ev

    async def generate(self, req: Request,
                       timeout: float = 120.0) -> List[TokenEvent]:
        """Submit and collect the whole stream (convenience for tests)."""
        return [ev async for ev in self.stream(req, timeout=timeout)]

    # ------------------------------------------------ wall-clock metrics
    def wall_metrics(self) -> dict:
        """Wall-clock latency percentiles over every token streamed so
        far: TTFT (submit -> first token) and TBT (gap between streamed
        tokens of one request). This is the served-mode complement of the
        sim-time ``MetricsReport`` — PR-6 produced these timestamps and
        discarded them; here they become the serving SLO view."""
        ttfts: List[float] = []
        tbts: List[float] = []
        for rid, walls in self._token_walls.items():
            if not walls:
                continue
            t0 = self._submit_wall.get(rid)
            if t0 is not None:
                ttfts.append(walls[0] - t0)
            tbts.extend(b - a for a, b in zip(walls, walls[1:]))
        ttfts.sort()
        tbts.sort()
        return {
            "n_requests": len(self._token_walls),
            "n_tokens": sum(len(w) for w in self._token_walls.values()),
            "ttft_p50": _pct(ttfts, 50), "ttft_p95": _pct(ttfts, 95),
            "ttft_p99": _pct(ttfts, 99),
            "tbt_p50": _pct(tbts, 50), "tbt_p95": _pct(tbts, 95),
            "tbt_p99": _pct(tbts, 99),
            "tbt_mean": sum(tbts) / len(tbts) if tbts else 0.0,
        }

    def token_walls(self, rid: int) -> List[float]:
        """The wall timestamps streamed for ``rid`` (empty if none)."""
        return list(self._token_walls.get(rid, ()))

    # ------------------------------------------------ /metrics endpoint
    async def _start_metrics_server(self) -> None:
        self._http_server = await asyncio.start_server(
            self._handle_http, host="127.0.0.1", port=self.metrics_port)
        self.metrics_addr = self._http_server.sockets[0].getsockname()[:2]

    def _render_metrics(self) -> str:
        # scrape on demand so a request between barriers sees fresh
        # gauges; set_total keeps the counters monotonic regardless
        from repro_torch.obs.scrape import scrape_fleet
        scrape_fleet(self.registry, self.fleet)
        wm = self.wall_metrics()
        g = self.registry.gauge("repro_wall_latency_seconds",
                                "wall-clock latency percentiles over "
                                "streamed tokens", ("stat",))
        for k in ("ttft_p50", "ttft_p95", "ttft_p99",
                  "tbt_p50", "tbt_p95", "tbt_p99", "tbt_mean"):
            g.set(wm[k], stat=k)
        self.registry.counter(
            "repro_wall_tokens_streamed_total",
            "tokens streamed to subscribers").set_total(wm["n_tokens"])
        return self.registry.render()

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = line.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers (keep the read side clean before replying)
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if h in (b"\r\n", b"\n", b""):
                    break
            if path.startswith("/metrics"):
                body = self._render_metrics().encode()
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: text/plain; version=0.0.4; "
                        b"charset=utf-8\r\n")
            else:
                body = b"repro metrics endpoint: GET /metrics\n"
                head = (b"HTTP/1.1 404 Not Found\r\n"
                        b"Content-Type: text/plain\r\n")
            writer.write(head
                         + b"Content-Length: %d\r\n" % len(body)
                         + b"Connection: close\r\n\r\n" + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            writer.close()
