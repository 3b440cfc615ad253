"""Event-driven simulation backend.

Plays the role Vidur plays for the paper (§3.6): a virtual-clock execution
oracle for paper-scale experiments (A100 replicas, multi-hour traces) on this
CPU-only container. The oracle is a *separately perturbed* copy of the
scheduler's analytical cost model plus optional multiplicative noise, so the
scheduler's latency predictions are imperfect in the same way a trained
random-forest's would be.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.predictor import HardwareSpec, ModelCostModel
from repro_torch.core.request import Request
from repro_torch.core.scheduler import BatchPlan


class SimBackend:
    def __init__(self, oracle: ModelCostModel, noise: float = 0.03,
                 seed: int = 0):
        self.oracle = oracle
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    @classmethod
    def perturbed(cls, scheduler_model: ModelCostModel,
                  mfu_error: float = 0.07, overhead_error: float = 0.25,
                  noise: float = 0.03, seed: int = 0) -> "SimBackend":
        """Ground-truth oracle whose constants differ from what the
        scheduler believes (prediction error is structural, not just
        iid noise)."""
        rng = np.random.default_rng(seed + 1)
        hw = scheduler_model.hw
        true_hw = dataclasses.replace(
            hw,
            mfu=hw.mfu * float(1 + rng.uniform(-mfu_error, mfu_error)),
            overhead_s=hw.overhead_s
            * float(1 + rng.uniform(-overhead_error, overhead_error)))
        oracle = ModelCostModel(scheduler_model.cfg, true_hw,
                                tp=scheduler_model.tp)
        return cls(oracle, noise=noise, seed=seed)

    def execute(self, plan: BatchPlan, now: float) -> float:
        t = self.oracle.iteration_time(plan.cost())
        if self.noise > 0:
            # scalar clamp == np.clip(x, 0.7, 1.5) at a fraction of the cost
            x = float(self.rng.normal(1.0, self.noise))
            t *= 0.7 if x < 0.7 else (1.5 if x > 1.5 else x)
        return max(1e-5, t)

    def on_admit(self, req: Request) -> None:
        pass

    def on_release(self, req: Request) -> None:
        pass
