"""Tensor-parallel serving over four ranks, and the ranks' lifetime: the
twins of tests/test_sharded_engine.py's TP = 4 tests (the three families
and dbrx-132b's geometry, paged, bit for bit in f32 against tp = 1, no
tolerance), then what the spawned ranks of ``TorchEngine(tp=N)`` may and
must do: import ``repro_torch`` alone (no JAX, no module of the JAX
package), leave no process behind after ``close()``, and fail the caller
within the engine's timeout when one of them dies mid-run.
"""
import multiprocessing as mp
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.scheduler import BatchPlan  # noqa: E402
from repro_torch.distributed.tp_serve import TIMEOUT_S  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402

from test_torch_tp import FAMILIES, _pair_streams, reduced  # noqa: E402

QOS = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp4_bit_identity_paged(arch):
    want, got, _, tp4 = _pair_streams(reduced(arch), 4, kv_layout="paged",
                                      block_size=32)
    assert got == want, f"{arch}: tp=4 diverged"
    assert tp4.tp == 4


def test_dbrx_geometry_end_to_end_under_tp4():
    """dbrx-132b reduced: 4 experts and 4 heads, one of each per rank;
    streams equal the tp = 1 engine's, bit for bit."""
    cfg = reduced("dbrx-132b")
    want, got, _, tp4 = _pair_streams(cfg, 4, kv_layout="paged",
                                      block_size=32)
    assert got == want
    assert all(toks for toks in got.values())
    assert tp4.tp_collective_bytes.keys() == {"heads", "experts", "logits"}


def _tp2():
    return TorchEngine(get_config("llama3.2-3b").reduced(num_layers=2,
                                                         d_model=64),
                       n_slots=2, max_len=128, quantum=16, seed=7, tp=2,
                       device="cpu")


def test_spawned_rank_imports_no_jax_and_no_repro():
    """This process has imported JAX and the JAX package; the spawned
    rank, started from ``repro_torch.distributed.worker``, has neither."""
    import jax  # noqa: F401  (present here, absent in the rank)

    eng = _tp2()
    try:
        info = eng._tp_workers.rank_info
        assert len(info) == 1
        pkgs = set(info[0]["packages"])
        assert "repro_torch" in pkgs and "torch" in pkgs
        assert "jax" not in pkgs and "repro" not in pkgs
        assert "jaxlib" not in pkgs
    finally:
        eng.close()


def test_close_leaves_no_process_behind():
    """``close()`` stops and joins every rank it started; a second close
    is a no-op, and an engine dropped without ``close()`` stops its
    ranks when it is collected."""
    import gc

    before = set(mp.active_children())
    eng = _tp2()
    procs = list(eng._tp_workers.procs)
    assert all(p.is_alive() for p in procs)
    eng.close()
    eng.close()
    assert not any(p.is_alive() for p in procs)
    assert set(mp.active_children()) == before
    eng = _tp2()
    procs = list(eng._tp_workers.procs)
    del eng
    gc.collect()
    assert not any(p.is_alive() for p in procs)
    assert set(mp.active_children()) == before


def test_dead_rank_fails_the_caller_within_its_timeout():
    """A rank killed between two iterations: rank 0's next call raises
    (naming the rank) well inside the engine's timeout, never hangs and
    never carries on alone."""
    eng = _tp2()
    try:
        r = Request(rid=0, arrival=0.0, prompt_len=20, decode_len=4,
                    qos=QOS)
        eng.on_admit(r)
        eng.execute(BatchPlan(prefill=[(r, 20)]), 0.0)
        r.prefilled = 20
        victim = eng._tp_workers.procs[0]
        victim.kill()
        victim.join(10)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="rank 1|closed|peer"):
            eng.execute(BatchPlan(decode=[r]), 0.0)
        assert time.perf_counter() - t0 < TIMEOUT_S
    finally:
        eng.close()
    assert not victim.is_alive()
