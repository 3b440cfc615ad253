"""Quickstart: the Niyama public API of the PyTorch port in ~60 lines.

The twin of ``examples/quickstart.py`` on ``repro_torch``: the same
replica on the simulator backend, the same requests and metrics.

1. Pick an architecture config and a QoS mix.
2. Build a Niyama replica (scheduler + backend + KV pool).
3. Submit requests with per-application SLOs; run; read the metrics.

  PYTHONPATH=src python examples/torch/quickstart.py
"""
from repro_torch.configs.paper_models import LLAMA3_8B
from repro_torch.core import (A100, ModelCostModel, NiyamaConfig,
                              NiyamaScheduler, QoSSpec, Request)
from repro_torch.core.kvpool import KVPool
from repro_torch.serving.metrics import compute_metrics
from repro_torch.serving.replica import Replica
from repro_torch.sim.backend import SimBackend

# ---- 1. model + hardware -> analytical cost model (the predictor) -------
cost = ModelCostModel(LLAMA3_8B, A100)

# ---- 2. QoS classes: an interactive chat app and a batch summarizer -----
CHAT = QoSSpec("chat", interactive=True, ttft_slo=3.0, tbt_slo=0.050)
BATCH = QoSSpec("summarize", interactive=False, ttlt_slo=300.0)

# ---- 3. a Niyama replica -------------------------------------------------
replica = Replica(
    scheduler=NiyamaScheduler(cost, cfg=NiyamaConfig(alpha=0.5)),
    backend=SimBackend.perturbed(cost, seed=0),
    kv=KVPool.from_memory(LLAMA3_8B, A100.hbm_size),
)

# ---- 4. submit a mixed workload ------------------------------------------
for i in range(40):
    interactive = i % 2 == 0
    replica.submit(Request(
        rid=i,
        arrival=i * 0.25,                      # 4 QPS
        prompt_len=1500 if interactive else 6000,
        decode_len=100 if interactive else 400,
        qos=CHAT if interactive else BATCH,
        app_id="chat" if interactive else "summarize",
        important=(i % 5 != 0),                # 20% free tier
    ))

replica.run()

# ---- 5. metrics -----------------------------------------------------------
m = compute_metrics(replica.finished, duration=replica.now)
print(f"served {m.n} requests in {replica.now:.1f}s "
      f"({replica.iterations} scheduler iterations)")
print(f"TTFT p50/p99:   {m.ttft_p50:.2f} / {m.ttft_p99:.2f} s")
print(f"TBT p99:        {m.tbt_p99*1e3:.1f} ms")
print(f"SLO violations: {m.violation_frac:.1%} by tier "
      f"{m.violation_by_tier}")
print(f"goodput:        {m.goodput:.2f} req/s within SLO")
assert m.violation_frac <= 0.05, "quickstart should comfortably meet SLOs"
print("OK")
