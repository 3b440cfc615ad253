"""The port's dry-run (``repro_torch.launch.dryrun``) on the 16x16 fake
mesh, in a subprocess of its own (torch's fake process group is
process-global; ``lower_pair`` makes and destroys it):

- ``lower_pair`` for mamba2-370m x decode_32k and llama3.2-3b x
  train_4k (its first 4 of 28 layers, widths whole, to keep the file
  short): ``ok``, every key of the JAX dry-run's report, and
  ``flops_per_dev`` x 256 within 5% of the flops of the same step traced
  unsharded on one device (plain meta tensors);
- the argument bytes per device equal to the local-shard bytes computed
  from the specs;
- a sharded [B, S, d] x [d, f] product counts 1/256 of its global flops
  (a mode above DTensor would count the global product);
- ``roofline.main`` prints a row from a results directory.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PAIRS = (("mamba2-370m", "decode_32k"), ("llama3.2-3b", "train_4k"))
DEPTH = {"llama3.2-3b": 4}

_SCRIPT = r'''
import dataclasses, json, sys
import torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import torch_api as ta
from repro_torch.engine.optim import init_adamw
from repro_torch.engine.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import batch_shapes, cache_template, input_specs
from repro_torch.models.transformer import Transformer

out = {}


def local_bytes(shape, spec, itemsize, mesh):
    n = 1
    for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n *= d // SH._axsize(mesh, ax) if ax is not None else d
    return n * itemsize


for arch, sname, depth in json.loads(sys.argv[1]):
    shape = SHAPES[sname]
    cfg = get_config(arch, shape)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth,
                                  layers=cfg.layers[:depth])
    rep, _ = D.lower_pair(arch, sname, depth=depth)
    # the same step unsharded on one device, on plain meta tensors
    with ops.plain_versions():
        params = Transformer(cfg, "meta", torch.bfloat16)
        batch = input_specs(cfg, shape)
        if shape.kind == "train":
            args = (params, init_adamw(params), batch)
            fn = make_train_step(cfg)
        else:
            cache = cache_template(cfg, shape)
            args = (params, cache, batch["tokens"])
            fn = make_serve_step(cfg) if shape.kind == "decode" else \
                make_prefill_step(cfg)
            if shape.kind == "prefill":
                args = (params, cache, batch)
        meter = D._Meter()
        with meter:
            fn(*args)
    # the argument bytes from the specs, on a shape-only mesh
    m = type("M", (), {"axis_names": ("data", "model"),
                       "shape": {"data": 16, "model": 16}})
    rules = SH.ShardingRules(cfg, m, train=shape.kind == "train")
    params = Transformer(cfg, "meta", torch.bfloat16)
    specs = rules.param_specs(params)
    want = sum(local_bytes(p.shape, specs[n], 2, m)
               for n, p in params.named_parameters())
    if shape.kind == "train":
        want += 2 * sum(local_bytes(p.shape, specs[n], 4, m)
                        for n, p in params.named_parameters()) + 4
    else:
        cache = cache_template(cfg, shape)
        cspecs = rules.cache_specs(cache, shape.global_batch, False)
        for c, sp in zip(cache["layers"], cspecs["layers"]):
            for t, s in zip(c, sp):
                want += local_bytes((shape.global_batch,) + tuple(t.shape[1:]),
                                    s, t.element_size(), m)
        want += local_bytes(cache["len"].shape, cspecs["len"], 4, m)
    dspecs = rules.data_specs(batch_shapes(cfg, shape))
    want += sum(local_bytes(v, dspecs[k], 4 if k in ("tokens", "labels")
                            else 2, m)
                for k, v in batch_shapes(cfg, shape).items()
                if shape.kind != "decode" or k == "tokens")
    out[f"{arch}/{sname}"] = {"report": rep, "global_flops": meter.flops,
                              "arg_bytes_from_specs": want}

# a sharded product: 1/256 of its global flops on each device
ta.init_fake_group(256)
try:
    mesh = make_production_mesh()
    B, S, d, f = 256, 4096, 3072, 8192
    x = ta.distribute(torch.empty(B, S, d, device="meta",
                                  dtype=torch.bfloat16), mesh,
                      SH.placements(SH.P("data", "model", None), mesh))
    w = ta.distribute(torch.empty(d, f, device="meta", dtype=torch.bfloat16),
                      mesh, SH.placements(SH.P(None, None), mesh))
    meter = D._Meter()
    with meter:
        y = ta.einsum("bsd,df->bsf", x, w)
    out["product"] = {"flops": meter.flops, "global": 2.0 * B * S * d * f,
                      "local_shape": list(y.to_local().shape)}
finally:
    ta.destroy_group()
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def traced():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT,
         json.dumps([(a, s, DEPTH.get(a)) for a, s in PAIRS])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**__import__("os").environ,
             "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _jax_report_keys():
    """The keys of the JAX dry-run's report, read from its source (the
    module itself sets XLA_FLAGS when imported)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    block = src[src.index("report = {"):]
    block = block[:block.index("}\n")]
    # less the keys of each ``collective_ops`` entry
    return set(re.findall(r'"(\w+)":', block)) - {"n", "bytes"}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_lower_pair_reports_jax_keys_and_per_device_flops(traced, arch,
                                                          shape):
    r = traced[f"{arch}/{shape}"]
    rep = r["report"]
    assert rep["ok"] and rep["mesh"] == "16x16" and rep["n_chips"] == 256
    keys = _jax_report_keys()
    assert "flops_per_dev" in keys and keys <= set(rep), keys - set(rep)
    per_dev = rep["flops_per_dev"]
    assert per_dev * 256 == pytest.approx(r["global_flops"], rel=0.05)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert rep[k] > 0
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["peak_bytes_per_dev"] == rep["argument_bytes_per_dev"] + \
        rep["output_bytes_per_dev"] + rep["temp_bytes_per_dev"]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_argument_bytes_are_the_local_shards(traced, arch, shape):
    r = traced[f"{arch}/{shape}"]
    assert r["report"]["argument_bytes_per_dev"] == \
        r["arg_bytes_from_specs"]


def test_sharded_product_counts_its_local_flops(traced):
    p = traced["product"]
    assert p["local_shape"] == [16, 256, 8192]
    assert p["flops"] == p["global"] / 256


def test_roofline_prints_a_row(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import roofline
    rep = {"arch": "llama3.2-3b", "shape": "decode_32k", "mesh": "16x16",
           "ok": True, "attn_variant": "native", "t_compute_s": 1e-5,
           "t_memory_s": 2e-3, "t_collective_s": 1e-4, "dominant": "memory",
           "useful_flops_ratio": 0.5, "peak_bytes_per_dev": 3 * 2 ** 30}
    (tmp_path / "llama3.2-3b__decode_32k__16x16.json").write_text(
        json.dumps(rep))
    monkeypatch.setattr(roofline, "RESULTS_DIR", tmp_path)
    roofline.main([])
    out = capsys.readouterr().out
    row = [l for l in out.splitlines() if l.startswith("| llama3.2-3b ")]
    assert row and "| memory |" in row[0] and "| 3.0 |" in row[0]
    assert "quantize KV" in row[0] and "1 ok, 0 failed" in out
