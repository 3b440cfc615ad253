"""Niyama core: QoS-driven scheduling (the paper's primary contribution).

Dynamic chunking (chunking.py), hybrid prioritization (priority.py), eager
relegation (relegation.py), selective preemption (scheduler.py), the
analytical batch-latency predictor (predictor.py), and the Sarathi-style
baselines used throughout the paper's evaluation.
"""
from .kvpool import KVPool
from .predictor import (A100, H100, TPU_V5E, BatchPlanCost,
                        DecodeLengthEstimator, HardwareSpec, ModelCostModel)
from .qos import (PAPER_TIERS, Q1_INTERACTIVE, Q2_BATCH, Q3_BATCH, QoSSpec)
from .request import Phase, Request
from .scheduler import (BatchPlan, NiyamaConfig, NiyamaScheduler,
                        SarathiScheduler, Scheduler, SchedulerView)

__all__ = [
    "KVPool", "A100", "H100", "TPU_V5E", "BatchPlanCost",
    "DecodeLengthEstimator",
    "HardwareSpec", "ModelCostModel", "PAPER_TIERS", "Q1_INTERACTIVE",
    "Q2_BATCH", "Q3_BATCH", "QoSSpec", "Phase", "Request", "BatchPlan",
    "NiyamaConfig", "NiyamaScheduler", "SarathiScheduler", "Scheduler",
    "SchedulerView",
]
