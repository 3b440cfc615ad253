"""Families (``nbench/family.py``): the decoder family gives the cells'
two configurations the very leaves, draws, logits, FLOP counts and
memory arithmetic that the harness computed before it went through a
family module (frozen copies of that code below); a family is found by
the file's ``model.family`` in the checkout, and a missing one fails at
set-up naming its path; no family module loads the program, the JAX
package or JAX; ``port_config`` holds the program's layer pattern and
SSM to the file's."""
import json
import subprocess
import sys
from typing import Dict, List, Tuple

import pytest
import torch

from conftest import (BENCH, FAMILIES, ROOT, tiny_config,
                      tiny_hybrid_config)
from nbench import check, family, harness, program, weights
from nbench.records import StepRec
from nbench.traffic import seed_words

CONFIGS = sorted((BENCH / "configs").glob("*.json"))


def _file(path) -> dict:
    return json.loads(path.read_text())


# ---- frozen copies of the harness's decoder arithmetic before families

def frozen_layer_leaves(m: dict, li: int) -> List[Tuple[str, tuple, float]]:
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    p = f"layers.{li}."
    out = [(p + "norm1", (d,), 0.0),
           (p + "attn.wq", (d, H, hd), d ** -0.5),
           (p + "attn.wk", (d, KV, hd), d ** -0.5),
           (p + "attn.wv", (d, KV, hd), d ** -0.5),
           (p + "attn.wo", (H, hd, d), (H * hd) ** -0.5),
           (p + "norm2", (d,), 0.0)]
    moe = m.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        out += [(p + "moe.router", (d, E), d ** -0.5),
                (p + "moe.w_gate", (E, d, f), d ** -0.5),
                (p + "moe.w_up", (E, d, f), d ** -0.5),
                (p + "moe.w_down", (E, f, d), f ** -0.5)]
    else:
        f = m["d_ff"]
        out += [(p + "ffn.w_gate", (d, f), d ** -0.5),
                (p + "ffn.w_up", (d, f), d ** -0.5),
                (p + "ffn.w_down", (f, d), f ** -0.5)]
    return out


def frozen_groups(m: dict):
    d, L = m["d_model"], m["num_layers"]
    vp = -(-m["vocab_size"] // 256) * 256
    out = [(0, [("embed", (vp, d), 0.02)])]
    out += [(1 + li, frozen_layer_leaves(m, li)) for li in range(L)]
    out.append((1 + L, [("final_norm", (d,), 0.0)]))
    out.append((2 + L, [("lm_head", (d, vp), 0.02)]))
    return out


def frozen_draw(seed: int, stream: int, leaves) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device="cpu")
    lo, hi = seed_words(seed)
    gen.manual_seed(((hi * 1000003 + lo) * 4099 + stream) % (1 << 63))
    total = sum(torch.Size(s).numel() for _, s, _ in leaves)
    flat = torch.randn(total, generator=gen, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, std in leaves:
        n = torch.Size(shape).numel()
        t = flat[at:at + n].view(shape)
        t.mul_(std if std else 0.1)
        out[name] = t
        at += n
    return out


def frozen_step_flops(m: dict, chunks, ctxs, sampled: int) -> float:
    d, H, KV, hd, L = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["num_layers"])
    proj = 2.0 * (2 * d * H * hd + 2 * d * KV * hd)
    moe = m.get("moe")
    if moe:
        ffn = 2.0 * d * moe["num_experts"] \
            + moe["top_k"] * 6.0 * d * moe["d_ff_expert"]
    else:
        ffn = 6.0 * d * m["d_ff"]
    chunks, ctxs = list(chunks), list(ctxs)
    tokens = sum(r for _, r in chunks) + len(ctxs)
    pairs = sum(r * s + r * (r + 1) // 2 for s, r in chunks) + sum(ctxs)
    return L * (tokens * (proj + ffn) + 4.0 * H * hd * pairs) \
        + sampled * 2.0 * d * m["vocab_size"]


def frozen_block_bytes(cfg_file: dict) -> int:
    m, serve = cfg_file["model"], cfg_file["serve"]
    return (2 * m["num_layers"] * m["num_kv_heads"] * m["head_dim"]
            * getattr(torch, serve["dtype"]).itemsize * serve["block_size"])


# ---- the decoder family against them

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_decoder_family_leaves_and_groups_are_the_frozen_ones(path):
    m = _file(path)["model"]
    fam = family.load(ROOT, m)
    assert fam.__file__ == str((BENCH / "reference" / "decoder.py"))
    for li in range(m["num_layers"]):
        assert fam.layer_leaves(m, li) == frozen_layer_leaves(m, li)
    assert weights.groups(fam, m) == frozen_groups(m)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_decoder_family_draws_are_bit_identical(moe):
    m = tiny_config("tiny", moe, 1e-3)["model"]
    fam = family.load(ROOT, m)
    seed = 2 ** 31 + 77
    w = weights.SeededWeights(fam, m, seed, torch.device("cpu"),
                              torch.float32)
    for stream, leaves in frozen_groups(m):
        want = frozen_draw(seed, stream, leaves)
        got = w.group(stream)
        assert list(got) == list(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
            assert torch.equal(w[name], want[name]), name


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_decoder_family_reference_logits_are_bit_identical(moe):
    """``check._logits`` through the family against the decoder
    reference called directly, as the harness called it before."""
    from reference import decoder
    m = tiny_config("tiny", moe, 1e-3)["model"]
    fam = family.load(ROOT, m)
    w = weights.SeededWeights(fam, m, 5, torch.device("cpu"),
                              torch.float32)
    g = torch.Generator().manual_seed(3)
    seqs = [torch.randint(0, m["vocab_size"], (n,), generator=g)
            for n in (40, 17)]
    keep = [torch.arange(30, 40), torch.arange(0, 17)]
    for precision in ("fp32", "fp8"):
        got = check._logits(fam, m, w, seqs, keep, precision)
        hid = decoder.final_hidden(m, w.group, seqs, keep, precision)
        head = w.group(m["num_layers"] + 2)["lm_head"]
        want = [decoder.logits(m, head, h, precision) for h in hid]
        assert all(torch.equal(a, b) for a, b in zip(got, want))


MIXES = [([], [], 0), ([(0, 512)], [], 1), ([(0, 37), (1024, 256)],
                                              [5, 900, 4097], 4),
         ([], [1] * 64, 64), ([(8000, 192)], list(range(1, 200, 7)), 29)]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_decoder_family_flops_and_memory_are_the_frozen_ones(path):
    cfg_file = _file(path)
    m = cfg_file["model"]
    fam = family.load(ROOT, m)
    for chunks, ctxs, sampled in MIXES:
        assert fam.step_flops(m, chunks, ctxs, sampled) == \
            frozen_step_flops(m, chunks, ctxs, sampled)
    steps = [StepRec(0.0, kv_used=u, kv_total=cfg_file["serve"]
                     ["kv_blocks"]) for u in (3, 97, 41)]
    peak = 71_234_567_890
    got = harness._held(steps, cfg_file, peak, fam)
    block = frozen_block_bytes(cfg_file)
    assert got["held_bytes"] == int(peak - (steps[-1].kv_total - 97)
                                    * block)
    assert got["kv_peak_used_blocks"] == 97


def test_kv_layers_count_the_attention_layers_of_a_hybrid(tiny_root):
    m = tiny_hybrid_config("tiny", 1e-3)["model"]
    assert family.load(tiny_root, m).kv_layers(m) == 3
    dense = tiny_config("tiny", False, 1e-3)["model"]
    assert family.load(tiny_root, dense).kv_layers(dense) == 2


# ---- finding a family

def test_a_family_is_loaded_from_its_checkout_once(tiny_root):
    m = tiny_hybrid_config("tiny", 1e-3)["model"]
    a = family.load(tiny_root, m)
    assert a is family.load(tiny_root, m)
    assert a.__file__ == str((tiny_root / "bench" / "reference"
                              / "tiny_hybrid.py").resolve())
    # the repo's own checkout has no such family
    with pytest.raises(FileNotFoundError, match="tiny_hybrid.py"):
        family.load(ROOT, m)


def test_an_unknown_family_fails_at_set_up_naming_its_file(tiny_root):
    f = tiny_root / "bench" / "configs" / "tiny-dense.json"
    conf = json.loads(f.read_text())
    conf["model"]["family"] = "no_such_family"
    f.write_text(json.dumps(conf))
    want = str(tiny_root / "bench" / "reference" / "no_such_family.py")
    with pytest.raises(FileNotFoundError) as e:
        harness.run_cell(tiny_root, "tiny.dense", 1, 0.5, False, "cpu")
    assert want in str(e.value)
    for bad in ("../decoder", "", None):
        with pytest.raises(ValueError, match="model.family"):
            family.load(tiny_root, dict(conf["model"], family=bad))


def test_no_family_module_loads_the_program_or_jax(tiny_root):
    """Each module under ``bench/reference/`` and the tests' families,
    loaded by path in a fresh interpreter, loads no module whose
    top-level name is repro_torch, repro, jax, jaxlib or flax."""
    paths = [p for p in sorted((BENCH / "reference").glob("*.py"))
             + sorted(FAMILIES.glob("*.py")) if p.stem != "__init__"]
    assert {p.stem for p in paths} >= {"decoder", "tiny_hybrid"}
    code = (
        "import sys, json; sys.path[:0] = [%r]\n"
        "from pathlib import Path\n"
        "from nbench import family\n"
        "for p in %r:\n"
        "    family._load(Path(p))\n"
        "bad = ('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')\n"
        "print(json.dumps(sorted({n for n in sys.modules\n"
        "                         if n.split('.')[0] in bad})))\n"
        % (str(BENCH), [str(p) for p in paths]))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tiny_root)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


# ---- the program's config against the file's

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_the_cells_configurations_pass_unchanged(path):
    cfg_file = _file(path)
    cfg = program.port_config(cfg_file)
    assert cfg.num_layers == cfg_file["model"]["num_layers"]


def test_a_hybrid_pattern_and_ssm_are_the_files():
    conf = tiny_hybrid_config("tiny", 1e-3)
    cfg = program.port_config(conf)
    assert [[s.mixer, s.ffn] for s in cfg.layers] == conf["model"]["layers"]
    assert cfg.ssm.d_state == 16 and cfg.ssm.chunk == 32
    for key, value in (("layers", conf["model"]["layers"][::-1]),
                       ("ssm", dict(conf["model"]["ssm"], d_state=32)),
                       ("moe", dict(conf["model"]["moe"], top_k=3))):
        bad = json.loads(json.dumps(conf))
        bad["model"][key] = value
        with pytest.raises(ValueError, match="is not the file's"):
            program.port_config(bad)
