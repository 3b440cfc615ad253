"""Tests of the benchmark's own code, on the CPU at tiny sizes. The
``tiny_root`` fixture writes a checkout of its own in a temporary
directory: a ``BENCHMARK.json`` whose cells (``tiny.dense``,
``tiny.moe`` and ``tiny.hybrid``) are defined only there, their
configuration and traffic files, the benchmark's readers and family
modules, and one family module more, ``tiny_hybrid`` (from
``families/``), so every run here also shows that a cell, and a family,
is added by files alone."""
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


FAMILIES = BENCH / "tests" / "families"
# every mixer and FFN kind the program pairs: mamba / attn x moe / dense /
# none
HYBRID_LAYERS = [["mamba", "moe"], ["attn", "dense"], ["mamba", "none"],
                 ["attn", "moe"], ["mamba", "dense"], ["attn", "none"]]
HYBRID_SSM = {"d_state": 16, "d_conv": 4, "expand": 2, "headdim": 16,
              "chunk": 32}


def tiny_hybrid_config(name: str, limit: float) -> dict:
    """The port's jamba config cut to the tiny widths, with the layers
    and the SSM given in ``port.replace`` and compared in ``model``."""
    model = {"family": "tiny_hybrid", "num_layers": len(HYBRID_LAYERS),
             "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
             "head_dim": 16, "vocab_size": 512, "rope_theta": 10000.0,
             "norm_eps": 1e-6, "d_ff": 128,
             "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32},
             "ssm": dict(HYBRID_SSM), "layers": HYBRID_LAYERS}
    replace = {k: model[k] for k in ("num_layers", "d_model", "num_heads",
                                     "num_kv_heads", "head_dim",
                                     "vocab_size", "norm_eps", "d_ff",
                                     "moe", "ssm", "layers")}
    return {"name": name, "source": "tiny", "reduced": [],
            "port": {"config": "repro_torch.configs.jamba_v0_1_52b:CONFIG",
                     "replace": replace}, "model": model,
            "serve": {"dtype": "float32", "n_slots": 4, "block_size": 16,
                      "max_len": 256, "quantum": 16, "kv_blocks": 48},
            "check": {"max_logit_gap": limit}}


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
    shutil.copytree(BENCH / "reference", tmp / "bench" / "reference",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(FAMILIES / "tiny_hybrid.py", tmp / "bench" / "reference")
    bench["configs"], bench["workloads"] = [], []
    for cell, kind in (("tiny.dense", "dense"), ("tiny.moe", "moe"),
                       ("tiny.hybrid", "hybrid")):
        cname = f"tiny-{kind}"
        f = f"bench/configs/{cname}.json"
        conf = tiny_hybrid_config(cname, limit) if kind == "hybrid" \
            else tiny_config(cname, kind == "moe", limit)
        (tmp / f).write_text(json.dumps(conf))
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
