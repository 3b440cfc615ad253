"""Tests of the benchmark's own code, on the CPU at tiny sizes. The
``tiny_root`` fixture writes a checkout of its own in a temporary
directory: a ``BENCHMARK.json`` whose cells (``tiny.dense`` and
``tiny.moe``) are defined only there, their configuration and traffic
files, and the benchmark's readers, so every run here also shows that a
cell is added by data alone."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny runs are timed on the wall clock: one thread keeps a step's
# time from swinging with the host's other load
torch.set_num_threads(1)

TIERS = [{"name": "Q1", "interactive": True, "ttft_slo": 6.0,
          "tbt_slo": 0.05},
         {"name": "Q2", "interactive": False, "ttlt_slo": 600.0},
         {"name": "Q3", "interactive": False, "ttlt_slo": 1800.0}]


def tiny_config(name: str, moe: bool, limit: float) -> dict:
    model = {"family": "decoder", "num_layers": 2, "d_model": 64,
             "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
             "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-6}
    replace = {k: model[k] for k in ("num_layers", "d_model", "num_heads",
                                     "num_kv_heads", "head_dim",
                                     "vocab_size", "norm_eps")}
    if moe:
        model["rope_theta"] = 1000000.0
        model["moe"] = {"num_experts": 8, "top_k": 2, "d_ff_expert": 32}
        replace["moe"] = dict(model["moe"])
        replace["d_ff"] = 32
        port = "repro_torch.configs.qwen3_moe_30b_a3b:CONFIG"
    else:
        model["d_ff"] = 128
        replace["d_ff"] = 128
        port = "repro_torch.configs.paper_models:QWEN_7B"
    return {"name": name, "source": "tiny", "reduced": [],
            "port": {"config": port, "replace": replace}, "model": model,
            "serve": {"dtype": "float32", "n_slots": 4, "block_size": 16,
                      "max_len": 256, "quantum": 16, "kv_blocks": 48},
            # as the cells' configurations: the widest gap on the dense
            # model, the mean gaps on the routed one
            "check": ({"mean_logit_gap": limit, "request_mean_gap": limit}
                      if moe else {"max_logit_gap": limit})}


def tiny_mix(name: str) -> dict:
    return {"name": name, "prompt": {"p50_p90": [40, 120], "clip": [8, 200]},
            "output": {"p50_p90": [6, 16], "clip": [1, 40]},
            "max_len": 256, "tiers": TIERS,
            "tier_shares": [1 / 3, 1 / 3, 1 / 3],
            "arrivals": {"process": "poisson", "rate_per_s": 12.0},
            "ramp_s": 0.5, "set_seed": 7}


def write_root(tmp: Path, limit: float = 1e-3) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir()
    shutil.copytree(BENCH / "metrics", tmp / "bench" / "metrics")
    bench["configs"], bench["workloads"] = [], []
    for cell, moe in (("tiny.dense", False), ("tiny.moe", True)):
        cname = f"tiny-{'moe' if moe else 'dense'}"
        f = f"bench/configs/{cname}.json"
        (tmp / f).write_text(json.dumps(tiny_config(cname, moe, limit)))
        (tmp / "bench" / "traffic" / f"{cell}.json").write_text(
            json.dumps(tiny_mix(cell)))
        bench["configs"].append({"name": cname, "source": "tiny", "file": f,
                                 "reduced": [], "why": "tests"})
        bench["workloads"].append({"name": cell, "config": cname,
                                   "traffic": cell, "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path)
