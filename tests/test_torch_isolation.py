"""The port stands alone: importing all of ``repro_torch`` (and
``chip_smoke.py``) loads neither JAX nor any module of the JAX package
``repro``, and no source of either, nor any example twin under
``examples/torch/``, names them in an import. Its entry points run on the
card unless asked for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


EXAMPLES = ROOT / "examples" / "torch"


def _sources() -> list:
    """Every source of the port: the package, ``chip_smoke.py`` and the
    example twins."""
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted(EXAMPLES.glob("*.py")))


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") \
        or name == "repro" or name.startswith("repro.")


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout.split()
    n_modules, bad = int(out[0]), " ".join(out[1:])
    assert n_modules >= 20
    assert bad == "[]"


def test_no_source_imports_jax_or_repro():
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_no_source_imports_ml_dtypes():
    """JAX's bf16 arrays cross through ``bridge`` as int16 views: the
    port needs no ``ml_dtypes``, which the card's machine lacks."""
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), \
                (path, names)


def test_the_probe_walks_the_new_modules():
    """The import probe above walks every module of the package, the
    Mamba2 slice's, the int8 / KV-hierarchy slice's, the MoE slice's and
    the sliding-window slice's among them."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.models.mamba2", "repro_torch.kernels.ssd_scan",
            "repro_torch.kernels.rmsnorm",
            "repro_torch.configs.mamba2_370m",
            "repro_torch.kernels.paged_attention_int8",
            "repro_torch.serving.kvcache.hierarchy",
            "repro_torch.serving.kvcache.prefix",
            "repro_torch.serving.kvcache.swap",
            "repro_torch.models.moe",
            "repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.dbrx_132b",
            "repro_torch.configs.jamba_v0_1_52b",
            "repro_torch.configs.granite_8b",
            "repro_torch.configs.starcoder2_15b",
            "repro_torch.configs.paper_models",
            "repro_torch.configs.gemma3_4b"} <= names


def test_the_sources_cover_the_obs_slice():
    """The import probe walks the observability plane's modules, and the
    source scans read the five example twins."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.obs.registry", "repro_torch.obs.attribution",
            "repro_torch.obs.scrape"} <= names
    examples = {p.name for p in _sources() if p.parent == EXAMPLES}
    assert examples == {"quickstart.py", "capacity_planning.py",
                        "overload_degradation.py", "fleet_serving.py",
                        "multi_qos_serving.py"}


def test_the_probe_walks_the_reference_slice():
    """The probe walks the configs of the encoder-decoder and vision
    families, and the engine module holds both engines and the
    factory."""
    import pkgutil

    import repro_torch
    from repro_torch.engine import torch_backend
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.configs.whisper_medium",
            "repro_torch.configs.internvl2_76b"} <= names
    assert set(torch_backend.ENGINES) == {"fused", "reference"}
    assert torch_backend.ENGINES["reference"] is \
        torch_backend.ReferenceTorchEngine


def test_reference_entry_points_default_to_the_card():
    """Without a card and without device="cpu", the reference engine,
    the dense engine, the slot cache, the replica factory and the serve
    script with ``--engine reference`` raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.engine.torch_backend import (ReferenceTorchEngine,
                                                  TorchEngine)
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_cache
    from repro_torch.serving.schemes import make_torch_replica
    cfg = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    whisper = get_config("whisper-medium").reduced(num_layers=2,
                                                   d_model=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReferenceTorchEngine(whisper)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(cfg, kv_layout="dense")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(whisper, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_torch_replica("niyama", whisper, engine="reference")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--arch", "whisper-medium", "--engine",
                    "reference"])


def test_entry_points_default_to_the_card():
    """Without a card and without device="cpu", the engine, the model
    init, the paged cache (made or bridged), the replica factory and the
    serve script raise, for the dense, Mamba2 and MoE families; so do
    the training state, the bridged AdamW state and the train script."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.engine.torch_backend import TorchEngine
    from repro_torch.launch import serve
    from repro_torch.models.mamba2 import init_mamba_state
    from repro_torch.models.transformer import init_paged_cache, init_params
    from repro_torch.serving.schemes import make_torch_replica
    cfg = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(cfg, 2, 4, 16)
    page = np.zeros((4, 16, cfg.num_kv_heads, cfg.head_dim), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.paged_cache_from_numpy({"layers": [(page, page)]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_torch_replica("niyama", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    from repro_torch.engine.steps import init_train_state
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.adamw_from_numpy({"step": np.int32(0), "mu": {}, "nu": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    mamba = get_config("mamba2-370m").reduced(num_layers=2, d_model=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(mamba)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(mamba, 2, 4, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mamba_state(2, mamba)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_torch_replica("niyama", mamba)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--arch", "mamba2-370m"])
    moe = get_config("qwen3-moe-30b-a3b").reduced(num_layers=2, d_model=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(moe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(moe, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_torch_replica("niyama", moe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--arch", "qwen3-moe-30b-a3b"])
    gemma = get_config("gemma3-4b").reduced(num_layers=2, d_model=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(gemma)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--arch", "gemma3-4b"])


def test_unported_families_raise():
    """No family is left waiting: ``NOT_PORTED`` is empty and
    ``get_config`` gives the JAX registry's whisper-medium and
    internvl2-76b field for field. The fused engine refuses an
    encoder-decoder model, naming the reference engine, as ``JaxEngine``
    does, and serves a vision frontend; the sliding-window families
    (gemma3-4b, and every layer sliding) construct, and the
    ``long_500k`` variant gives the JAX registry's layer lists."""
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import NOT_PORTED, SWA_500K_ARCHS, get_config
    from repro_torch.engine.torch_backend import TorchEngine
    from repro_torch.models.config import (SWA, EncoderConfig, FrontendStub,
                                           LayerSpec)
    for arch in ("internvl2-76b", "whisper-medium"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
    base = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    with pytest.raises(NotImplementedError, match="ReferenceTorchEngine"):
        TorchEngine(dataclasses.replace(
            base, encoder=EncoderConfig(num_layers=1)), device="cpu")
    vision = dataclasses.replace(
        base, frontend=FrontendStub(kind="vision", num_tokens=8))
    assert TorchEngine(vision, device="cpu").cfg.frontend.num_tokens == 8
    assert NOT_PORTED == {}
    for arch in ("qwen3-moe-30b-a3b", "dbrx-132b", "jamba-v0.1-52b",
                 "granite-8b", "starcoder2-15b", "gemma3-4b"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-model")
    gemma = TorchEngine(get_config("gemma3-4b").reduced(
        num_layers=2, d_model=128), device="cpu")
    assert {l.mixer for l in gemma.cfg.layers} == {"attn", SWA}
    assert gemma._swa_reclaim_window is None
    swa = dataclasses.replace(
        get_config("llama3.2-3b").reduced(num_layers=2, d_model=128),
        layers=(LayerSpec(SWA, "dense", 64),) * 2)
    assert TorchEngine(swa, device="cpu")._swa_reclaim_window == 64
    for arch in sorted(SWA_500K_ARCHS - set(NOT_PORTED)):
        got = get_config(arch, "long_500k")
        want = jax_get_config(arch, "long_500k")
        assert [dataclasses.asdict(l) for l in got.layers] == \
            [dataclasses.asdict(l) for l in want.layers]
        assert {l.window for l in got.layers if l.mixer == SWA} == {8192}
