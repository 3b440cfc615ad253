"""Whole runs of cells defined only in a temporary checkout (the
``tiny_root`` fixture), on the CPU at tiny sizes: the metrics come out
by name, the served tokens pass the check, and the check fails when a
served token is altered where the engine produces it, or when the fp8
control stands in for the program. ``tiny.hybrid``'s family module, too,
exists only in that checkout."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT
from nbench import check, harness, spec

SEED = 2 ** 31 + 11
CELLS = ["tiny.dense", "tiny.moe", "tiny.hybrid"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_defined_by_data_alone_runs_and_is_correct(tiny_root, cell):
    c = spec.load(tiny_root, cell)
    assert c.config["name"].startswith("tiny")
    res = harness.run_cell(tiny_root, cell, SEED, 2.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"tokens_s", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["tokens_checked"]["value"] >= check.MIN_TOKENS


def test_the_traced_run_reports_the_per_layer_metrics(tiny_root):
    res = harness.run_cell(tiny_root, "tiny.dense", SEED, 2.0, True, "cpu")
    assert res["correct"]
    got = set(res["metrics"])
    assert {"sched_ms", "predictor_error_ms", "kv_used_pct",
            "engine_ms.tbt", "tbt_p95_ms.host", "mfu.tokens",
            "device_idle_pct"} <= got
    # no kernel runs on the CPU: the kernels' shares find nothing to read
    assert "decode_attn_roofline" not in got
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_token_fails_the_check(tiny_root, cell, monkeypatch):
    """A fault where tokens are produced: every sampled id of one step in
    five is moved to its neighbour."""
    from repro_torch.engine import torch_backend

    real = torch_backend.fused_serve_forward
    calls = []

    def altered(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        if len(calls) % 5 == 0:
            out = (out + 1) % a[1].vocab_size
        return out
    monkeypatch.setattr(torch_backend, "fused_serve_forward", altered)
    res = harness.run_cell(tiny_root, cell, SEED, 2.0, False, "cpu")
    assert not res["correct"]
    for k, c in res["checks"].items():
        if k != "tokens_checked":
            assert c["value"] > c["limit"], k
    assert res["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_fails_the_limit(tiny_root, cell):
    """The control: the reference with fp8 operands at the same positions
    reads a gap far above the program's and above the limit."""
    res = harness.run_cell(tiny_root, cell, SEED + 1, 2.0, False, "cpu",
                           control=True)
    for key in [k for k in res["checks"] if k != "tokens_checked"]:
        limit = res["checks"][key]["limit"]
        assert res["checks"][key]["value"] <= limit
        assert res["control"][key] > 10 * limit, key


def test_no_forbidden_module_and_no_reading_of_benchmarks(tiny_root):
    """A run loads no module whose top-level name is jax, jaxlib, flax or
    repro (compared whole: repro_torch is the program), and no file of
    the benchmark names the JAX package's benchmark folder."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from nbench import harness\n"
        "harness.run_cell(%r, 'tiny.moe', 5, 0.5, True, 'cpu')\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        % (str(BENCH), str(ROOT / "src"), str(tiny_root)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tiny_root)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    run_files = [BENCH / "run.py", BENCH / "sweep.py",
                 BENCH / "calibrate.py"]
    for d in ("nbench", "reference", "metrics"):
        run_files += sorted((BENCH / d).rglob("*.py"))
    for f in run_files:
        text = f.read_text()
        assert "benchmarks" not in text, f
        assert "import jax" not in text and "from repro " not in text \
            and "from repro." not in text, f


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchy", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro.core"]


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"),
                        "--workload", "qwen7b.code", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path)
    assert p.returncode != 0
    assert "correct" not in p.stdout
