"""Async fleet runtime: N real engines behind a streaming front-end.

See docs/fleet.md §Async runtime. Public surface:

  AsyncFleet    — FleetController on worker threads; virtual-mode
                  equivalence oracle + wall-mode streaming serving with
                  real cross-replica KV transfer
  AsyncServer   — asyncio submit/stream front-end over a wall-mode fleet
  WallClock / VirtualClock — the injectable time source
  EngineWorker  — one thread per engine (thread-ownership contract)
"""
from .clock import VirtualClock, WallClock
from .runtime import AsyncFleet
from .server import AsyncServer, TokenEvent
from .worker import EngineWorker

__all__ = ["AsyncFleet", "AsyncServer", "TokenEvent", "EngineWorker",
           "VirtualClock", "WallClock"]
