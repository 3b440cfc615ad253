"""The worker ranks of a tensor-parallel ``TorchEngine``.

JAX serves a TP replica from one controller; ``torch.distributed`` runs
one process per rank. Rank 0 is the engine that the ``Replica`` calls,
in the caller's process. It starts ranks 1..N-1 here (``TPWorkers``),
each a process started with the ``spawn`` method (never ``fork``: CUDA
does not survive a fork, and the caller may run other threads) whose
entry point, ``main``, is this module, so that a rank imports
``repro_torch`` alone. Each rank builds a ``TorchEngine`` over its own
shard and then runs, in order, the calls that rank 0 sends it.

What rank 0 sends is the device work of each backend call, never the
scheduler's state: ``execute`` and ``warm`` send the host arrays of the
step they run (the packed rows and the block tables that rank 0 built
from its pool), the pool hooks send their block ids, a swap-resume the
slot it restores, ``import_swapped`` its payload; a call with no device
work (``preflight``, ``on_release``, a fresh ``on_admit``) sends
nothing. The messages go over one pipe per rank; the tensors of the
forward go over the group's collectives. Replies (a rank's page shards
for ``export_swapped``, its counters) come back over the pipe.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed.tp_serve import TIMEOUT_S, TPGroup
from repro_torch.models.config import ModelConfig

# seconds an idle rank waits between checks that its parent is alive
_POLL_S = 1.0
# seconds a rank told to close may take before it is terminated
_JOIN_S = 5.0


@dataclasses.dataclass
class RankSpec:
    """Everything rank ``rank`` needs to build its engine: the config,
    the engine's keyword arguments (``device`` a string), the rank's
    slices of the weights as numpy arrays keyed by ``state_dict`` name
    (``bridge.rank_params_to_numpy``; None: drawn from the engine's
    seed), the group's rendezvous and rank 0's thread count."""
    cfg: ModelConfig
    engine_kw: Dict[str, Any]
    params: Optional[Dict[str, Any]]
    rank: int
    tp: int
    backend: str
    store_path: str
    threads: int


def main(spec: RankSpec, conn) -> None:
    """A worker rank: join the group, build the engine's shard, report
    ready (with the top-level packages it has imported), then
    run rank 0's calls until ``close`` (or until rank 0's process is
    gone). An error in a call ends the process, so that the other ranks'
    next collective fails at once."""
    from repro_torch import bridge
    from repro_torch.engine.torch_backend import TorchEngine

    torch.set_num_threads(spec.threads)
    dev = torch.device(spec.engine_kw["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0 if dev.index is None else dev.index)
    conn.send("started")
    group = TPGroup(spec.rank, spec.tp, spec.backend, spec.store_path)
    params = None if spec.params is None else {
        k: bridge.tensor_from_numpy(v) for k, v in spec.params.items()}
    eng = TorchEngine(spec.cfg, tp=spec.tp, tp_group=group, params=params,
                      **spec.engine_kw)
    conn.send({"packages": sorted({m.split(".")[0] for m in sys.modules})})
    parent = mp.parent_process()
    while True:
        if not conn.poll(_POLL_S):
            if parent is not None and not parent.is_alive():
                break
            continue
        name, args, reply = conn.recv()
        if name == "close":
            break
        out = getattr(eng, name)(*args)
        if reply:
            conn.send(out)
    group.close()


class TPWorkers:
    """Rank 0's handle on ranks 1..N-1: starts them (``rank_params(rank)``
    gives each its slices of the weights, or None), joins rank 0 to their
    group (``join_group``), sends them calls and collects replies, and
    stops them (``close``; also at interpreter exit, as they are
    daemons)."""

    def __init__(self, cfg: ModelConfig, engine_kw: Dict[str, Any],
                 rank_params: Callable[[int], Optional[Dict[str, Any]]],
                 tp: int, backend: str):
        self.tp = tp
        self.backend = backend
        self.group: Optional[TPGroup] = None
        self._dir = tempfile.mkdtemp(prefix="repro-tp-")
        self._store = store = str(Path(self._dir) / "store")
        ctx = mp.get_context("spawn")
        self.procs: List[mp.Process] = []
        self.conns = []
        try:
            for rank in range(1, tp):
                kw = dict(engine_kw)
                if backend == "nccl":
                    kw["device"] = f"cuda:{rank}"
                ours, theirs = ctx.Pipe()
                spec = RankSpec(cfg, kw, rank_params(rank), rank, tp,
                                backend, store, torch.get_num_threads())
                p = ctx.Process(target=main, args=(spec, theirs),
                                name=f"tp-rank{rank}", daemon=True)
                p.start()
                theirs.close()
                self.procs.append(p)
                self.conns.append(ours)
        except BaseException:
            self.close()
            raise

    def join_group(self) -> TPGroup:
        """Rank 0's membership of the group, once every rank has joined.
        Each rank reports first that it started, so that one that fails
        to start (its pipe closes) fails this at once, not after the
        rendezvous' timeout."""
        for got in self._replies():
            if got != "started":
                raise RuntimeError(f"a tensor-parallel rank sent {got!r}")
        self.group = TPGroup(0, self.tp, self.backend, self._store)
        return self.group

    def wait_ready(self) -> None:
        """Block until every rank has built its shard; keep each rank's
        ready report (``rank_info``, ranks 1..N-1)."""
        self.rank_info = self._replies()

    def send(self, name: str, args: tuple = (), reply: bool = False) -> None:
        """Send the call ``name(*args)`` to every rank, in rank order."""
        for rank, conn in enumerate(self.conns, start=1):
            try:
                conn.send((name, args, reply))
            except (BrokenPipeError, ConnectionError, EOFError) as e:
                raise self._dead(rank, e) from e

    def ask(self, name: str, *args) -> list:
        """Run ``name(*args)`` on every other rank; their results in rank
        order."""
        self.send(name, args, reply=True)
        return self._replies()

    def _replies(self) -> list:
        out = []
        for rank, conn in enumerate(self.conns, start=1):
            try:
                if not conn.poll(TIMEOUT_S):
                    raise TimeoutError(f"no reply in {TIMEOUT_S:.0f} s")
                out.append(conn.recv())
            except (TimeoutError, EOFError, ConnectionError) as e:
                raise self._dead(rank, e) from e
        return out

    def _dead(self, rank: int, err: BaseException) -> RuntimeError:
        p = self.procs[rank - 1]
        p.join(0.1)
        return RuntimeError(
            f"tensor-parallel rank {rank} failed ({err}); its process "
            f"{'is alive' if p.is_alive() else f'exited with {p.exitcode}'}")

    def close(self) -> None:
        """Stop every rank and wait for it (a rank still running after
        ``_JOIN_S``, stuck in a collective, is terminated); idempotent."""
        for conn in self.conns:
            try:
                conn.send(("close", (), False))
            except (BrokenPipeError, ConnectionError, EOFError, OSError):
                pass
        for p in self.procs:
            p.join(_JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(TIMEOUT_S)
        for conn in self.conns:
            conn.close()
        self.procs, self.conns = [], []
        if self.group is not None:
            self.group.close()
        shutil.rmtree(self._dir, ignore_errors=True)
