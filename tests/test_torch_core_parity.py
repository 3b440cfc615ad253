"""The port's copies of the scheduler stack decide as the JAX package's
originals do.

The same seeded request set goes through ``repro``'s Replica +
NiyamaScheduler + KVPool and through ``repro_torch``'s copies, both
driven by a stub backend that reports a constant iteration time. Every
iteration's BatchPlan — prefill (rid, chunk) items and decode rids — must
be identical, under the CPU demo hardware and under the port's H100 spec
(built on the JAX side from the same numbers). The MoE configs'
cost models (the grouped GEMM priced as the capacity path, and the
dropless sweep) price every plan with the same floats as the JAX ones,
and the scheduler on them makes the same plans.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import kvpool as jkv  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.core import qos as jqos  # noqa: E402
from repro.core import request as jreq  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.serving import replica as jrep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kvpool as tkv  # noqa: E402
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.core import qos as tqos  # noqa: E402
from repro_torch.core import request as treq  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.serving import replica as trep  # noqa: E402
from repro_torch.serving.schemes import CPU_HW  # noqa: E402

JAX_SIDE = (jkv, jpred, jqos, jreq, jsched, jrep, jax_get_config)
PORT_SIDE = (tkv, tpred, tqos, treq, tsched, trep, get_config)


class _StubBackend:
    """Executes nothing; records each plan and reports ``dt`` seconds."""

    def __init__(self, dt):
        self.dt = dt
        self.plans = []

    def execute(self, plan, now):
        self.plans.append((tuple((r.rid, c) for r, c in plan.prefill),
                           tuple(r.rid for r in plan.decode)))
        return self.dt

    def on_admit(self, req):
        pass

    def on_release(self, req):
        pass


def _hw(pred, name):
    h = tpred.H100 if name == "h100" else CPU_HW
    return pred.HardwareSpec(**{f: getattr(h, f) for f in (
        "name", "flops_peak", "hbm_bw", "hbm_size", "link_bw", "pcie_bw",
        "mfu", "overhead_s", "ici_bw")})


def _serve(side, hw_name, dt, seed=0, n=40, arch="llama3.2-3b"):
    kv, pred, qos, req, sched, rep, get_cfg = side
    cfg = get_cfg(arch)
    hw = _hw(pred, hw_name)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(0.08, n))
    reqs = [req.Request(rid=i, arrival=float(arrivals[i]),
                        prompt_len=int(rng.integers(50, 6000)),
                        decode_len=int(rng.integers(10, 200)),
                        qos=qos.PAPER_TIERS[i % 3], app_id=f"a{i % 3}",
                        important=bool(rng.random() < 0.7))
            for i in range(n)]
    backend = _StubBackend(dt)
    r = rep.Replica(
        scheduler=sched.NiyamaScheduler(pred.ModelCostModel(cfg, hw),
                                        cfg=sched.NiyamaConfig()),
        backend=backend, kv=kv.KVPool(num_blocks=300, block_size=256))
    r.submit_all(reqs)
    r.run()
    outcome = sorted((q.rid, q.decoded, q.was_relegated, q.ttft())
                     for q in r.all_requests())
    return backend.plans, len(r.finished), outcome


@pytest.mark.parametrize("hw_name,dt", [("cpu", 0.05), ("h100", 0.03)])
def test_copied_scheduler_makes_identical_plans(hw_name, dt):
    want, n_want, out_want = _serve(JAX_SIDE, hw_name, dt)
    got, n_got, out_got = _serve(PORT_SIDE, hw_name, dt)
    assert n_got == n_want == 40
    assert len(got) > 100
    assert got == want
    assert out_got == out_want


def test_h100_spec_is_the_data_sheet():
    h = tpred.H100
    assert (h.name, h.flops_peak, h.hbm_bw, h.hbm_size, h.link_bw) == \
        ("h100", 989e12, 3.35e12, 80e9, 450e9)


MOE_ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]


@pytest.mark.parametrize("sweep", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cost_model_prices_as_jax(arch, sweep):
    rng = np.random.default_rng(1)
    plans = [([(int(rng.integers(1, 4096)), int(rng.integers(0, 8192)))
               for _ in range(int(rng.integers(0, 3)))],
              rng.integers(1, 16384, int(rng.integers(0, 40))).tolist(),
              float(rng.integers(0, 2)) * 3e6)
             for _ in range(40)]
    for hw_name in ("cpu", "h100"):
        j = jpred.ModelCostModel(jax_get_config(arch), _hw(jpred, hw_name),
                                 moe_dropless_sweep=sweep)
        t = tpred.ModelCostModel(get_config(arch), _hw(tpred, hw_name),
                                 moe_dropless_sweep=sweep)
        assert t._w_expert_bytes == j._w_expert_bytes > 0
        for pre, dec, swap in plans:
            assert t.iteration_time(tpred.BatchPlanCost(pre, dec, swap)) \
                == j.iteration_time(jpred.BatchPlanCost(pre, dec, swap))
            assert t.weight_read_bytes(len(dec)) == \
                j.weight_read_bytes(len(dec))
        for rem, prefix in ((100, 0), (5000, 300), (30000, 2048)):
            assert t.prefill_time_estimate(rem, prefix) == \
                j.prefill_time_estimate(rem, prefix)
            assert t.decode_time_estimate(rem, prefix) == \
                j.decode_time_estimate(rem, prefix)
        for slack in (0.01, 0.05, 0.3):
            assert t.solve_max_chunk(slack, 512, [700, 1500]) == \
                j.solve_max_chunk(slack, 512, [700, 1500])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_copied_scheduler_makes_identical_plans_on_moe(arch):
    want, n_want, out_want = _serve(JAX_SIDE, "h100", 0.03, arch=arch)
    got, n_got, out_got = _serve(PORT_SIDE, "h100", 0.03, arch=arch)
    assert n_got == n_want == 40
    assert got == want
    assert out_got == out_want
