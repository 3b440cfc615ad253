"""The port's simulator backend, workloads, fleet controller and silos
decide exactly as the JAX package's.

These modules are framework-free copies (``data/workloads.py``, ``sim/``,
``serving/cluster.py``, ``serving/fleet/``, the sim factories of
``serving/schemes.py``), so every comparison here is exact: the same
seeds give request lists equal field for field, the BatchPlan traces of
the golden scenarios hash to the digests recorded in
``tests/data/golden_traces.json``, and fleet, silo and capacity reports
are equal to the last bit (floats compared through their JSON text, in
which NaN equals NaN).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.paper_models import LLAMA3_8B as J_LLAMA3_8B  # noqa: E402
from repro.data import workloads as jwl  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import schemes as jschemes  # noqa: E402
from repro.serving.kvcache import KVCacheConfig as JKVC  # noqa: E402
from repro.serving.metrics import compute_metrics as jmetrics  # noqa: E402
from repro.sim import trace as jtrace  # noqa: E402
from repro_torch.configs.paper_models import LLAMA3_8B  # noqa: E402
from repro_torch.data import workloads as twl  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import cluster as tcluster  # noqa: E402
from repro_torch.serving import schemes as tschemes  # noqa: E402
from repro_torch.serving.kvcache import KVCacheConfig as TKVC  # noqa: E402
from repro_torch.serving.metrics import compute_metrics as tmetrics  # noqa
from repro_torch.sim import trace as ttrace  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
# (package's workloads, schemes, cluster, trace, metrics, KVCacheConfig,
# the paper's llama3-8b config)
JAX = (jwl, jschemes, jcluster, jtrace, jmetrics, JKVC, J_LLAMA3_8B)
PORT = (twl, tschemes, tcluster, ttrace, tmetrics, TKVC, LLAMA3_8B)


def _text(x) -> str:
    """A value as JSON text (dataclasses as dicts, numpy scalars and
    arrays as lists, enums by name): equal text is equality to the bit,
    with NaN equal to NaN."""
    def conv(o):
        if dataclasses.is_dataclass(o):
            return {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
                    if not f.name.startswith("_")}
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
        if hasattr(o, "name"):
            return o.name
        raise TypeError(type(o))
    return json.dumps(x, default=conv, sort_keys=True)


# ------------------------------------------------------------ workloads

@pytest.mark.parametrize("name", sorted(jwl.DATASETS))
def test_workloads_equal_jax_field_for_field(name):
    """Every generator of ``data/workloads.py`` gives, for the same seed,
    the same arrivals and the same requests (every field, the QoS tier's
    included) as the JAX package's."""
    assert _text(twl.DATASETS[name]) == _text(jwl.DATASETS[name])
    out = {}
    for pkg, wl in (("jax", jwl), ("port", twl)):
        rng = np.random.default_rng(11)
        pois = wl.poisson_arrivals(rng, 3.0, 20.0)
        diur = wl.diurnal_arrivals(rng, 1.0, 6.0, period=5.0, duration=20.0)
        reqs = wl.make_requests(wl.DATASETS[name], diur, rng,
                                tier_probs=[0.5, 0.3, 0.2],
                                important_frac=0.6, rid_base=100)
        out[pkg] = (pois, diur, reqs,
                    wl.paper_workload(name, 2.0, 30.0, seed=4,
                                      important_frac=0.7),
                    wl.shared_prefix_workload(name, 2.0, 30.0, seed=5,
                                              n_tenants=4,
                                              tenant_skew=1.3))
    for a, b in zip(out["jax"], out["port"]):
        assert len(a) > 0
        assert _text(a) == _text(b)
    assert any(r.prefix_id is not None for r in out["port"][4])


# ------------------------------------------------------------ golden traces

def test_golden_fixture_equals_the_recorded_traces():
    """``repro_torch.sim.trace.golden_fixture()`` reproduces the JAX
    package's recorded fixture: the solo Niyama replica and both replicas
    of the two-replica fleet, plan for plan (sha256 of the canonical
    lines, plan counts, first and last lines)."""
    want = json.loads((DATA / "golden_traces.json").read_text())
    got = ttrace.golden_fixture()
    assert got == want
    assert [got[k]["n_plans"] for k in
            ("solo", "fleet_replica0", "fleet_replica1")] == [466, 850, 719]


# ------------------------------------------------------------ fleets

def _golden_requests(wl):
    rng = np.random.default_rng(3)
    arr = wl.diurnal_arrivals(rng, 4.0, 12.0, period=20.0, duration=40.0)
    return wl.make_requests(wl.DATASETS["azure_code"], arr, rng,
                            tier_probs=[0.6, 0.25, 0.15], important_frac=0.6)


def _traced_fleet(pkg, policy, live):
    """The golden fleet scenario on ``policy`` with offload and queued
    migration on (and, with ``live``, the KV hierarchy and live decode
    migration): each replica's plan digest, and the fleet's report."""
    wl, schemes, _, trace, _, kvc, llama = pkg
    kw = dict(live_migrate=True,
              kv_cfg=kvc(enable_prefix=True, enable_swap=True,
                         host_bytes=4e9)) if live else {}
    fleet = schemes.make_fleet(llama, 2, policy=policy, seed=3,
                               sim_noise=0.0, offload=True, migrate=True,
                               **kw)
    recs = []
    for rep in fleet.replicas:
        rec = trace.TraceRecorder(rep.scheduler)
        rep.scheduler = rec
        recs.append(rec)
    m = schemes.run_fleet_workload(fleet, _golden_requests(wl), until=200.0,
                                   duration=40.0)
    return [trace.trace_digest(r.lines) for r in recs], m


@pytest.mark.parametrize("policy,live", [("jsq", False), ("tier", False),
                                         ("slack", False), ("slack", True)])
def test_make_fleet_decides_as_jax(policy, live):
    """``make_fleet`` under each router policy, with relegation offload
    and queued-prefill migration on: every replica's BatchPlan digest,
    the ``FleetReport`` (counts, peaks, every migration event) and the
    ``MetricsReport`` equal JAX's."""
    jd, jm = _traced_fleet(JAX, policy, live)
    td, tm = _traced_fleet(PORT, policy, live)
    assert td == jd
    assert _text(tm.fleet) == _text(jm.fleet)
    assert _text(tm) == _text(jm)
    assert tm.fleet.migrations > 0
    if policy == "slack" and not live:
        fix = json.loads((DATA / "golden_traces.json").read_text())
        assert td == [fix["fleet_replica0"]["sha256"],
                      fix["fleet_replica1"]["sha256"]]


def _silo_at(pkg, qps):
    wl, schemes, cluster, _, metrics, _, llama = pkg
    reqs = wl.paper_workload("azure_conv", qps, 15.0, seed=2,
                             important_frac=0.8)
    silo = schemes.make_silo(llama, {"Q1": 1, "Q2": 1, "Q3": 1}, seed=2,
                             sim_noise=0.0)
    silo.dispatch(reqs)
    silo.run(until=300.0)
    return metrics(silo.finished(), 15.0)


def test_make_silo_and_find_capacity_equal_jax():
    """The siloed baseline (one Sarathi replica a tier) reports the same
    ``MetricsReport`` as JAX's, and ``find_capacity``'s bisection over it
    lands on the same QPS; ``run_workload`` over the shared cluster too."""
    for qps in (1.0, 3.0):
        assert _text(_silo_at(PORT, qps)) == _text(_silo_at(JAX, qps))
    caps = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        caps[name] = pkg[2].find_capacity(
            lambda q, pkg=pkg: _silo_at(pkg, q), lo=0.5, hi=2.0, iters=2,
            violation_budget=0.05, hi_max=4.0)
    assert caps["port"] == caps["jax"]
    shared = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        wl, schemes, cluster, _, _, _, llama = pkg
        shared[name] = cluster.run_workload(
            lambda i, s=schemes, c=llama: s.make_replica(
                "sarathi-edf", c, rid=i, seed=7, sim_noise=0.0),
            wl.paper_workload("sharegpt", 3.0, 15.0, seed=8), n_replicas=2,
            until=300.0)
    assert _text(shared["port"]) == _text(shared["jax"])
    assert tschemes.ALL_SHARED_SCHEMES == jschemes.ALL_SHARED_SCHEMES
    assert (tschemes.SHARED_CHUNK, tschemes.SILO_BATCH_CHUNK) == \
        (jschemes.SHARED_CHUNK, jschemes.SILO_BATCH_CHUNK)


# ------------------------------------------------------------ serve --backend sim

@pytest.mark.parametrize("argv", [
    ["--backend", "sim", "--duration", "20", "--qps", "3"],
    ["--backend", "sim", "--duration", "20", "--qps", "4", "--dataset",
     "sharegpt", "--scheme", "sarathi-fcfs", "--seed", "3"]])
def test_serve_sim_backend_equals_the_jax_driver(argv, capsys):
    """``repro_torch.launch.serve --backend sim`` serves the same
    requests with the same outcome as the JAX driver's ``--backend sim``,
    and prints the same report lines."""
    jrep = jserve.main(argv)
    jout = capsys.readouterr().out
    trep = tserve.main(argv)
    tout = capsys.readouterr().out
    dur = float(argv[argv.index("--duration") + 1])
    jm = jmetrics(jrep.all_requests(), dur)
    tm = tmetrics(trep.all_requests(), dur)
    assert tm.n > 0 and _text(tm) == _text(jm)
    assert trep.iterations == jrep.iterations
    assert tout == jout
