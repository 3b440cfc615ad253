"""Dry-run of the sharded steps on the production mesh: trace every
(architecture x input shape) pair as one rank of a 16x16 (or 2x16x16)
mesh runs it, and read the roofline terms from that trace. The
counterpart of the JAX package's ``launch/dryrun.py``, with the same
flags and report keys.

  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # 16x16
  python -m repro_torch.launch.dryrun --all --multi-pod     # 2x16x16

Where JAX lowers and compiles one SPMD program over 512 placeholder
devices and reads XLA's per-device cost analysis, this traces rank 0 of
torch's fake process group (collectives return at once with outputs of
the right shape): the parameters, the AdamW state, the batch and the
cache are DTensors placed by ``ShardingRules``, their local shards on
the meta device (shapes, no data), and the step that ``make_*_step``
returns runs on them eagerly, with the kernels' plain versions
(``kernels.ops.plain_versions``). DTensor inserts the collectives. A
dispatch mode (``_Meter``) sees every op that runs on a local shard and
counts, per device:

- ``flops_per_dev``: matrix products by torch's flop formulas
  (``torch.utils.flop_counter``), one flop per output element of an
  elementwise op and per input element of a reduction, on the local
  shapes. A mode above DTensor would see the global shapes: the meter
  lets DTensor run first and counts the local ops it runs.
- ``bytes_per_dev``: the bytes every local op other than a view reads
  and writes. These are unfused eager ops, so this is an upper bound of
  XLA's fused "bytes accessed", not the same quantity.
- ``collective_bytes_per_dev`` and ``collective_ops``: the result bytes
  of each functional collective (all-gather, all-reduce, reduce-scatter,
  all-to-all), as the JAX dry-run sums the result shapes in the HLO.
- ``argument_bytes_per_dev``: the local shards of the parameters,
  optimiser state, cache and batch. ``output_bytes_per_dev``: the
  returned tensors that are not arguments (the train step and the cache
  update in place). ``temp_bytes_per_dev``: the high-water mark of the
  bytes of every local tensor an op made, from its creation until its
  Python object is freed, less the outputs. ``peak_bytes_per_dev`` is
  their sum.

The local shards live on the meta device rather than under
``FakeTensorMode``: DTensor computes a strided shard's offsets with
``arange(...).tolist()``, which a fake tensor refuses as data-dependent
(the seq-sharded residual of the train step reshaped into a product
makes one).

The three terms use the H100 SXM5's datasheet constants, never measured
times. Results go to ``experiments/dryrun_torch/`` (one JSON file a
pair); ``run_one(..., save=False)`` writes nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, SKIPS, all_pairs, get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.distributed.sharding import (ShardingRules, place_batch,
                                              place_cache, place_params)
from repro_torch.distributed.torch_api import (DTensor, destroy_group,
                                               init_fake_group)
from repro_torch.engine.optim import init_adamw
from repro_torch.engine.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import RESULTS_DIR
from repro_torch.launch.specs import (batch_shapes, cache_template,
                                      input_specs)
from repro_torch.models.transformer import Transformer

# NVIDIA H100 SXM5 datasheet: dense bf16 tensor-core peak, HBM3 bandwidth
# and capacity. LINK_BW: a 16-wide mesh axis over 8-GPU nodes crosses the
# nodes' InfiniBand, 400 Gb/s NDR per GPU = 50e9 bytes/s, the slowest
# link on its path (NVLink 4 inside a node: 450e9 bytes/s per direction).
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 50e9               # bytes/s per GPU (NDR IB; NVLink 450e9)
HBM_BYTES = 80e9             # bytes per GPU

# the functional collectives, by the names the JAX dry-run gives the ops
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}
_aten = torch.ops.aten
# ops that count one flop per element of their first input
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max,
               _aten.min, _aten.prod, _aten.logsumexp, _aten.cumsum,
               _aten.var, _aten.std, _aten._softmax, _aten._log_softmax,
               _aten.linalg_vector_norm, _aten.norm, _aten.argmax,
               _aten.argmin, _aten.sort, _aten.topk, _aten.all, _aten.any}
# the methods of DTensor's sharding propagation (run on global-shape meta
# tensors), during which the meter counts nothing
PROPAGATION = ("propagate", "propagate_op_sharding_non_cached",
               "_propagate_tensor_meta_non_cached")
# ops that move no bytes
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.detach, _aten.alias, _aten.lift_fresh}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """Counts the ops that run on local shards (meta tensors) while it
    is on: flops, bytes, collectives and the high-water mark of live
    bytes. An op with a DTensor argument is handed back to DTensor
    (``NotImplemented``), which then runs its local ops and collectives
    under this mode. Not counted: ops on real tensors and the ops
    DTensor's sharding propagation runs on global-shape meta tensors to
    learn an output's shape (the meter pauses while
    ``ShardingPropagator``'s methods run: ``PROPAGATION``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        self.live = 0
        self.high = 0
        self.paused = 0
        self._saved = []
        self._depth = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        self._depth += 1              # re-entered for a decomposition
        if self._depth == 1:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            for name in PROPAGATION:
                orig = getattr(ShardingPropagator, name, None)
                if orig is None:
                    continue

                def paused(sp, *a, _orig=orig, **k):
                    self.paused += 1
                    try:
                        return _orig(sp, *a, **k)
                    finally:
                        self.paused -= 1
                self._saved.append((name, orig))
                setattr(ShardingPropagator, name, paused)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            while self._saved:
                setattr(ShardingPropagator, *self._saved.pop())
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if not self.paused and func._overloadpacket not in flop_registry:
            # a composite op (``matmul`` reaches a mode whole in inference
            # mode) is counted as the ops it decomposes into, which run
            # under this mode again
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.device.type == "meta" for t in ins + outs):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            if name in _COLLECTIVES:
                c = self.coll[_COLLECTIVES[name]]
                c[0] += 1
                c[1] += sum(_nbytes(t) for t in outs)
            return out
        schema = func._schema
        fresh = [r.alias_info is None for r in schema.returns]
        if func._overloadpacket in _NO_BYTES or (
                not any(fresh) and not schema.is_mutable):
            return out                # a view: no bytes move
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif func._overloadpacket in _REDUCTIONS and ins:
            self.flops += ins[0].numel()
        if all(fresh):                # no return aliases an input
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.high = max(self.high, self.live)
        return out


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (dicts,
    lists, named tuples, modules)."""
    leaves = [x for t in tree_leaves(tree) for x in (
        t.parameters() if isinstance(t, torch.nn.Module) else (t,))]
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves if isinstance(t, torch.Tensor))


def model_flops(cfg, shape: InputShape) -> float:
    """Useful-work floor: 6*N*D (train) / 2*N*D (inference forward),
    N = active params for MoE."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # one token per request


# Grad-accumulation depth for train_4k. The sweep's baseline uses 1;
# microbatching is the hillclimb's first lever (--microbatches there).
TRAIN_MICROBATCHES = 1


def measure_step(cfg, shape: InputShape, mesh, dtype=torch.bfloat16,
                 sharding_overrides=None, microbatches: Optional[int] = None,
                 kv_quant: bool = False):
    """Build the step's arguments for ``shape`` as DTensors on ``mesh``
    (any ``DeviceMesh``: the production mesh, or a small real one), run
    the step once and return (the counts as the report's fields, the
    ``_Meter``)."""
    rules = ShardingRules(cfg, mesh, train=(shape.kind == "train"))
    if sharding_overrides:
        sharding_overrides(rules)
    shard = rules.shard_fn()
    with ops.plain_versions():
        params = Transformer(cfg, "meta", dtype)
        pls = place_params(params, rules.param_specs(params), mesh)
        batch = place_batch(input_specs(cfg, shape, dtype),
                            rules.data_specs(batch_shapes(cfg, shape)),
                            mesh)
        if shape.kind == "train":
            opt = init_adamw(params)
            mb = TRAIN_MICROBATCHES if microbatches is None \
                else microbatches
            fn = make_train_step(cfg, shard=shard, microbatches=mb,
                                 grad_shardings=pls)
            args = (params, opt, batch)
        else:
            cache = cache_template(cfg, shape, dtype, kv_quant=kv_quant)
            specs = rules.cache_specs(
                cache, shape.global_batch,
                long_context=(shape.name == "long_500k"))
            cache = place_cache(cache, specs, mesh, shape.global_batch)
            if shape.kind == "prefill":
                fn = make_prefill_step(cfg, shard=shard)
                args = (params, cache, batch)
            else:
                fn = make_serve_step(cfg, shard=shard)
                args = (params, cache, batch["tokens"])
        arg_bytes = _local_bytes(args)
        meter = _Meter()
        t0 = time.time()
        with meter:
            out = fn(*args)
        t_trace = time.time() - t0
    arg_ids = {id(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(args)}
    out_bytes = sum(_nbytes(t) for t in (
        x.to_local() if isinstance(x, DTensor) else x
        for x in _tensors(out)) if id(t) not in arg_ids)
    coll_bytes = sum(c[1] for c in meter.coll.values())
    temp = max(0, meter.high - out_bytes)
    fields = {
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "flops_per_dev": float(meter.flops),
        "bytes_per_dev": float(meter.bytes),
        "collective_bytes_per_dev": float(coll_bytes),
        "collective_ops": {k: {"n": v[0], "bytes": v[1]}
                           for k, v in sorted(meter.coll.items())},
        "argument_bytes_per_dev": arg_bytes,
        "output_bytes_per_dev": out_bytes,
        "temp_bytes_per_dev": temp,
        "peak_bytes_per_dev": arg_bytes + out_bytes + temp,
    }
    return fields, meter


def lower_pair(arch: str, shape_name: str, multi_pod: bool = False,
               dtype=torch.bfloat16, sharding_overrides=None,
               microbatches: Optional[int] = None, kv_quant: bool = False,
               depth: Optional[int] = None):
    """Trace one pair on the production mesh over a fake group of 256
    (512) ranks, made here and destroyed before returning. ``depth``
    keeps the model's first ``depth`` layers (widths whole). Returns
    (report, meter)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch, shape)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth,
                                  layers=cfg.layers[:depth])
    n_chips = 512 if multi_pod else 256
    init_fake_group(n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        fields, meter = measure_step(cfg, shape, mesh, dtype,
                                     sharding_overrides, microbatches,
                                     kv_quant)
    finally:
        destroy_group()
    t_comp = fields["flops_per_dev"] / PEAK_FLOPS
    t_mem = fields["bytes_per_dev"] / HBM_BW
    t_coll = fields["collective_bytes_per_dev"] / LINK_BW
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(cfg, shape)
    report = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "attn_variant": cfg.attn_variant,
        "ok": True,
        **fields,
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(1.0, fields["flops_per_dev"]
                                       * n_chips),
        "torch": torch.__version__,
    }
    return report, meter


def run_one(arch: str, shape_name: str, multi_pod: bool,
            save: bool = True) -> dict:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if (arch, shape_name) in SKIPS:
        rep = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "ok": True, "skipped": SKIPS[(arch, shape_name)]}
    else:
        try:
            rep, _ = lower_pair(arch, shape_name, multi_pod)
        except Exception as e:
            rep = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "ok": False, "error": repr(e),
                   "traceback": traceback.format_exc()[-4000:]}
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape_name}__{rep['mesh']}".replace("/", "_")
        (RESULTS_DIR / f"{tag}.json").write_text(json.dumps(rep, indent=1))
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume a sweep: skip pairs with saved OK results")
    args = ap.parse_args(argv)

    pairs = (all_pairs() if args.all
             else [(args.arch, SHAPES[args.shape])])
    n_fail = 0
    for arch, shape in pairs:
        sname = shape.name if isinstance(shape, InputShape) else shape
        if args.skip_existing:
            mesh_tag = "2x16x16" if args.multi_pod else "16x16"
            f = RESULTS_DIR / f"{arch}__{sname}__{mesh_tag}.json"
            if f.exists() and json.loads(f.read_text()).get("ok"):
                print(f"SKIP(cached) {arch} {sname}")
                continue
        rep = run_one(arch, sname, args.multi_pod)
        if rep.get("skipped"):
            print(f"SKIP  {arch:18s} {sname:12s} {rep['skipped'][:60]}")
            continue
        if rep["ok"]:
            print(f"OK    {arch:18s} {sname:12s} mesh={rep['mesh']} "
                  f"trace={rep['lower_s']:6.1f}s "
                  f"dom={rep['dominant']:10s} "
                  f"peak={rep['peak_bytes_per_dev']/2**30:6.2f}GiB "
                  f"t=({rep['t_compute_s']:.2e},{rep['t_memory_s']:.2e},"
                  f"{rep['t_collective_s']:.2e})", flush=True)
            if rep["peak_bytes_per_dev"] > HBM_BYTES:
                print("  WARN: exceeds the H100's 80 GB of HBM")
        else:
            n_fail += 1
            print(f"FAIL  {arch:18s} {sname:12s}: {rep['error']}",
                  flush=True)
    print(f"\n{'ALL OK' if n_fail == 0 else f'{n_fail} FAILURES'}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
