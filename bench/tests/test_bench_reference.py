"""The plain reference (``bench/reference/decoder.py``) against the
program's offline forward (``repro_torch.models.transformer.prefill``)
at a reduced size on the CPU, one test per configuration's family:
dense SwiGLU (as Qwen-7B) and routed experts (as Qwen3-30B-A3B), on the
benchmark's own seeded weights in float32."""
import pytest
import torch

from conftest import tiny_config
from nbench import program
from nbench.weights import SeededWeights
from reference import decoder


@pytest.mark.parametrize("moe", [False, True], ids=["qwen-7b", "qwen3-moe"])
def test_reference_logits_match_the_program(moe):
    from repro_torch.models.transformer import (init_cache, load_params,
                                                prefill)
    cfg_file = tiny_config("tiny", moe, 1e-3)
    m = cfg_file["model"]
    cfg = program.port_config(cfg_file)
    w = SeededWeights(m, 123, torch.device("cpu"), torch.float32)
    params = load_params(cfg, w, "cpu", torch.float32)
    toks = torch.randint(0, m["vocab_size"], (1, 96),
                         generator=torch.Generator().manual_seed(1))
    cache = init_cache(cfg, 1, 128, dtype=torch.float32, device="cpu")
    got, _ = prefill(params, cfg, cache, toks.int(),
                     torch.zeros(1, dtype=torch.int32))
    got = got[0, :, :m["vocab_size"]].float()
    hid = decoder.final_hidden(m, w.group, [toks[0]],
                               [torch.arange(96)])[0]
    want = decoder.logits(m, w.group(m["num_layers"] + 2)["lm_head"], hid)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 1e-4 * float(scale)
    # the fp8 control departs from both by far more
    ctl = decoder.logits(m, w.group(m["num_layers"] + 2)["lm_head"],
                         decoder.final_hidden(m, w.group, [toks[0]],
                                              [torch.arange(96)], "fp8")[0])
    assert float((ctl - want).abs().max()) > 100 * float(
        (got - want).abs().max())


def test_weights_are_a_function_of_seed_and_group():
    m = tiny_config("tiny", True, 1e-3)["model"]
    a = SeededWeights(m, 2 ** 31 + 3, torch.device("cpu"), torch.float32)
    b = SeededWeights(m, 2 ** 31 + 3, torch.device("cpu"), torch.float32)
    c = SeededWeights(m, 2 ** 31 + 4, torch.device("cpu"), torch.float32)
    names = list(a)
    assert names == list(b) and len(a) == len(names)
    for n in reversed(names):       # any order draws the same numbers
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["layers.1.moe.w_up"], c["layers.1.moe.w_up"])
    assert a["layers.0.attn.wq"].shape == (64, 4, 16)
    assert a["embed"].shape == (512, 64)
