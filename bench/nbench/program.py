"""The one module of the benchmark that imports the system under test,
``repro_torch``: its configuration, its replica (``NiyamaScheduler`` over
the fused ``TorchEngine`` with paged KV), its requests and what the
engine served. Nothing here reads or times anything.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Mapping

import numpy as np

from nbench.traffic import Item, Tier


def port_config(cfg_file: dict):
    """The program's ``ModelConfig`` named by the file's ``port.config``
    (``module:attribute``), with ``port.replace`` applied (``moe`` and
    ``ssm`` as dicts of their fields; ``layers`` as a list of ``[mixer,
    ffn]`` or ``[mixer, ffn, window]``; ``num_layers`` without
    ``layers`` repeats the first layer's kind); raises unless its sizes
    are the file's ``model``. Where ``model`` gives ``layers``, ``ssm``
    or, beside ``moe``, ``d_ff``, they are compared too (``moe`` and
    ``ssm`` by the fields the file names)."""
    from repro_torch.models.config import LayerSpec

    mod, attr = cfg_file["port"]["config"].split(":")
    base = getattr(importlib.import_module(mod), attr)
    rep = dict(cfg_file["port"].get("replace", {}))
    for group in ("moe", "ssm"):
        if group in rep:
            rep[group] = dataclasses.replace(getattr(base, group),
                                             **rep[group])
    if "layers" in rep:
        rep["layers"] = tuple(LayerSpec(*s) for s in rep["layers"])
    elif "num_layers" in rep:
        # a uniform stack: the base's first layer kind, repeated
        rep["layers"] = base.layers[:1] * rep["num_layers"]
    cfg = dataclasses.replace(base, **rep)
    m = cfg_file["model"]
    got = dict(num_layers=cfg.num_layers, d_model=cfg.d_model,
               num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim, vocab_size=cfg.vocab_size,
               rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    if cfg.moe is not None:
        got["moe"] = {k: getattr(cfg.moe, k, None)
                      for k in m.get("moe", {})}
    if cfg.moe is None or "d_ff" in m:
        got["d_ff"] = cfg.d_ff
    if "ssm" in m:
        got["ssm"] = {k: getattr(cfg.ssm, k, None) for k in m["ssm"]} \
            if cfg.ssm is not None else None
    if "layers" in m:
        got["layers"] = [[s.mixer, s.ffn]
                         + ([s.window] if s.window is not None else [])
                         for s in cfg.layers]
    want = {k: m.get(k) for k in got}
    if got != want:
        raise ValueError(f"{cfg.name}: the program's config {got} is not "
                         f"the file's {want}")
    if len(cfg.layers) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(cfg.layers)} layer specs for "
                         f"{cfg.num_layers} layers")
    return cfg


def build_replica(cfg, serve: dict, weights: Mapping, device):
    """``make_torch_replica("niyama", ...)`` on the H100 cost model, with
    the run's weights; ``serve["max_chunk"]``, where given, bounds the
    prefill tokens a step takes. Returns (replica, engine)."""
    import torch

    from repro_torch.core.predictor import H100
    from repro_torch.serving.schemes import make_torch_replica

    rep = make_torch_replica(
        "niyama", cfg, engine="fused", kv_layout="paged",
        n_slots=serve["n_slots"], max_len=serve["max_len"],
        block_size=serve["block_size"], kv_blocks=serve["kv_blocks"],
        quantum=serve["quantum"], hw=H100, device=device,
        dtype=getattr(torch, serve["dtype"]), params=weights)
    if "max_chunk" in serve:
        # NiyamaConfig's bound on the prefill tokens of one step, which
        # the factory sets to max_len
        rep.scheduler.cfg.max_chunk = serve["max_chunk"]
    return rep, rep.backend


def make_request(it: Item, tier: Tier):
    from repro_torch.core.qos import QoSSpec
    from repro_torch.core.request import Request

    q = QoSSpec(tier.name, interactive=tier.interactive,
                ttft_slo=tier.ttft_slo, tbt_slo=tier.tbt_slo,
                ttlt_slo=tier.ttlt_slo)
    return Request(rid=it.rid, arrival=0.0, prompt_len=it.prompt_len,
                   decode_len=it.decode_len, qos=q,
                   app_id=f"bench/{tier.name}")


def give_prompt(engine, rid: int, tokens: np.ndarray) -> None:
    """The prompt's ids, handed to the engine before admission (its own
    synthetic prompts are then never drawn)."""
    engine.tokens[rid] = tokens
    engine.generated[rid] = []


def served(engine, rid: int) -> list:
    return list(engine.generated.get(rid, []))


def forget(rep) -> None:
    """Drop the replica's engine state so its memory can be freed."""
    eng = rep.backend
    for name in ("params", "cache"):
        if hasattr(eng, name):
            setattr(eng, name, None)
