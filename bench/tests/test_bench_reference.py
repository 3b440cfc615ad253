"""The plain references (the family modules of ``bench/reference/``, and
the tests' own ``tiny_hybrid``) against the program's offline forward
(``repro_torch.models.transformer.prefill``) at a reduced size on the
CPU, one test per configuration's family: dense SwiGLU (as Qwen-7B),
routed experts (as Qwen3-30B-A3B) and a hybrid of Mamba2 and attention
layers, on the benchmark's own seeded weights in float32."""
import pytest
import torch

from conftest import tiny_config, tiny_hybrid_config
from nbench import family, program
from nbench.weights import SeededWeights

KINDS = {"qwen-7b": lambda: tiny_config("tiny", False, 1e-3),
         "qwen3-moe": lambda: tiny_config("tiny", True, 1e-3),
         "hybrid": lambda: tiny_hybrid_config("tiny", 1e-3)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_logits_match_the_program(tiny_root, kind):
    from repro_torch.models.transformer import (init_cache, load_params,
                                                prefill)
    cfg_file = KINDS[kind]()
    m = cfg_file["model"]
    fam = family.load(tiny_root, m)
    cfg = program.port_config(cfg_file)
    w = SeededWeights(fam, m, 123, torch.device("cpu"), torch.float32)
    params = load_params(cfg, w, "cpu", torch.float32)
    toks = torch.randint(0, m["vocab_size"], (1, 96),
                         generator=torch.Generator().manual_seed(1))
    cache = init_cache(cfg, 1, 128, dtype=torch.float32, device="cpu")
    got, _ = prefill(params, cfg, cache, toks.int(),
                     torch.zeros(1, dtype=torch.int32))
    got = got[0, :, :m["vocab_size"]].float()
    head = w.group(m["num_layers"] + 2)["lm_head"]
    hid = fam.final_hidden(m, w.group, [toks[0]], [torch.arange(96)])[0]
    want = fam.logits(m, head, hid)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 1e-4 * float(scale)
    # the fp8 control departs from both by far more
    ctl = fam.logits(m, head, fam.final_hidden(m, w.group, [toks[0]],
                                               [torch.arange(96)],
                                               "fp8")[0])
    assert float((ctl - want).abs().max()) > 100 * float(
        (got - want).abs().max())


def test_weights_are_a_function_of_seed_and_group(tiny_root):
    m = tiny_config("tiny", True, 1e-3)["model"]
    fam = family.load(tiny_root, m)
    a = SeededWeights(fam, m, 2 ** 31 + 3, torch.device("cpu"),
                      torch.float32)
    b = SeededWeights(fam, m, 2 ** 31 + 3, torch.device("cpu"),
                      torch.float32)
    c = SeededWeights(fam, m, 2 ** 31 + 4, torch.device("cpu"),
                      torch.float32)
    names = list(a)
    assert names == list(b) and len(a) == len(names)
    for n in reversed(names):       # any order draws the same numbers
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["layers.1.moe.w_up"], c["layers.1.moe.w_up"])
    assert a["layers.0.attn.wq"].shape == (64, 4, 16)
    assert a["embed"].shape == (512, 64)


def test_a_leaf_with_a_mean_is_drawn_around_it(tiny_root):
    """The hybrid's ``A_log``, ``D`` and ``dt_bias`` give a mean; the
    leaves that give none are drawn as before (a norm at 0.1)."""
    m = tiny_hybrid_config("tiny", 1e-3)["model"]
    w = SeededWeights(family.load(tiny_root, m), m, 7, torch.device("cpu"),
                      torch.float32)
    g = w.group(1)
    assert g["layers.0.mamba.D"].mean() == pytest.approx(1.0, abs=0.1)
    assert g["layers.0.mamba.dt_bias"].mean() == pytest.approx(-3.0,
                                                               abs=0.5)
    assert g["layers.0.mamba.norm_w"].std() == pytest.approx(0.1, rel=0.3)
    assert "layers.2.norm2" not in w and "layers.1.ffn.w_up" in w
