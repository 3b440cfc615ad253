"""The example twins under ``examples/torch/`` run on the CPU at their
smallest size and exit 0. The four on the simulator print what the JAX
examples print for the same arguments and seeds, compared line for line;
the overload example takes no arguments, so both it and its JAX original
are imported and run with the same shortened ``DURATION`` and ``PERIOD``.
``multi_qos_serving.py`` serves the reduced model with ``--device cpu``
and asserts its generations equal offline greedy decoding, and without
``--device`` it asks for the card.
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# (file, arguments at the smallest size, whether the JAX example takes
# the same arguments, module constants set before an in-process run)
CASES = [
    ("quickstart.py", [], True, None),
    ("capacity_planning.py", ["--duration", "10"], True, None),
    ("fleet_serving.py", ["--replicas", "2", "--qps", "4", "--duration",
                          "20"], True, None),
    # a 200 s demo with the burst period a quarter of it, as the 1800 s
    # default has
    ("overload_degradation.py", [], True,
     {"DURATION": 200.0, "PERIOD": 50.0}),
    ("multi_qos_serving.py", ["--device", "cpu", "--n-requests", "4",
                              "--slots", "2"], False, None),
]


def _run(path: Path, args, pythonpath: str):
    env = dict(os.environ, PYTHONPATH=pythonpath, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(path), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _run_patched(path: Path, patch: dict, monkeypatch) -> str:
    """Import the example at ``path`` as a module of its own, set
    ``patch`` on it and return what its ``main()`` prints."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in patch.items():
        monkeypatch.setattr(mod, k, v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


@pytest.mark.parametrize("name,args,same_as_jax,patch", CASES,
                         ids=[c[0] for c in CASES])
def test_example_twin_runs(name, args, same_as_jax, patch, monkeypatch):
    if patch is not None:
        got = _run_patched(ROOT / "examples" / "torch" / name, patch,
                           monkeypatch)
        assert got.strip()
        assert got == _run_patched(ROOT / "examples" / name, patch,
                                   monkeypatch)
        return
    got = _run(ROOT / "examples" / "torch" / name, args, str(ROOT / "src"))
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip()
    if same_as_jax:
        # the JAX capacity example imports the benchmark helpers: the
        # repo root goes on its path
        want = _run(ROOT / "examples" / name, args,
                    os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
        assert want.returncode == 0, want.stderr[-2000:]
        assert got.stdout == want.stdout
    if name == "multi_qos_serving.py":
        assert got.stdout.count("... OK") == 4
        assert "all verified" in got.stdout


def test_multi_qos_twin_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    got = _run(ROOT / "examples" / "torch" / "multi_qos_serving.py", [],
               str(ROOT / "src"))
    assert got.returncode != 0
    assert "no CUDA device" in got.stderr
