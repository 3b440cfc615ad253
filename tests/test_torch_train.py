"""The port's training path against the JAX package's, on the CPU.

Every arch of the JAX registry at ``.reduced(num_layers=2, d_model=128)``
in f32, the JAX weights carried across by ``repro_torch.bridge``, the
same numpy batch (2 x 32 tokens, one label -1; random stub frames and
patch embeddings where the model has them):

- ``forward_train`` logits with remat on and off against JAX's, within
  ``LOGIT_TOL`` (XLA and ATen sum in different orders); inside the port,
  remat gives the same logits and gradients as no remat, bit for bit;
- the loss and every gradient leaf against ``jax.value_and_grad`` of
  JAX's loss (``cross_entropy`` plus 0.01 times the MoE aux loss): each
  leaf within ``GRAD_ATOL + GRAD_RTOL`` times the leaf's largest
  magnitude;
- one ``make_train_step`` step against JAX's update of those gradients
  (``adamw_update``, which is JAX's step body): loss and ``grad_norm``
  within 1e-5 relative, the updated parameters within ``PARAM_TOL``
  (JAX's own reason: AdamW's rsqrt amplifies tiny gradient differences
  near zero), and no more than ``PARAM_SHARE`` of them beyond 1e-5;
  and, for llama3.2-3b, JAX's jitted ``make_train_step`` itself;
- whisper-medium: JAX's training forward rounds the cross K/V to bf16
  (``init_cache``'s default dtype), as the port does. With the same
  encoder output they are equal bit for bit; through the two encoders
  (3e-6 apart) a few K/V elements land one bf16 ulp apart, so its
  logits and gradients have limits of their own (``WHISPER_TOL``).

Then the pieces: the microbatched step against the full batch and AdamW
on a quadratic (twins of ``tests/test_engine_optim.py``), the training
MoE with drops and with two dispatch groups, ``cross_entropy`` over a
padded vocab, ``rmsnorm_bwd_ref`` against ``jax.vjp`` of JAX's
``layers.rmsnorm`` and against autograd of ``rmsnorm_ref``, the
``rmsnorm`` Function's wiring, the attention kernels, which have no
backward, refusing grad on the kernel route (forced with stub wrappers;
the scan's gradient is ``tests/test_torch_ssd_bwd.py``'s), ``synthetic_batch``
equal to JAX's, checkpoints crossing both ways, the bridge's round
trips and the training script with ``--checkpoint`` / ``--resume``.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.engine import checkpoint as JC  # noqa: E402
from repro.engine import optim as JO  # noqa: E402
from repro.engine import steps as JS  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import layers as JLAY  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine import checkpoint as TC  # noqa: E402
from repro_torch.engine import optim as TO  # noqa: E402
from repro_torch.engine import steps as TS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

B, S = 2, 32
LR = 1e-3
AUX_WEIGHT = 0.01
LOGIT_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARAM_TOL = 1e-3
# and no more than PARAM_SHARE of a step's parameters beyond 1e-5
PARAM_SHARE = 1e-3
# whisper-medium: a few cross K/V elements one bf16 ulp (2^-8 of |K|)
# apart move its logits by up to ~1e-4 (6.2e-5 measured) and its
# gradients by up to ~2e-3 of a leaf's largest magnitude (1.4e-3); where
# that flips the sign of a near-zero gradient, AdamW's first update
# (about lr times the sign) moves the element by up to 2 lr (1.96e-3
# measured, in 269 of 1.05M elements)
WHISPER_TOL = dict(logits=5e-4, grad_rtol=1e-2, params=2.5 * LR)


def _configs(arch):
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _np_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[1, 3] = -1                                  # a masked label
    nb = {"tokens": tok, "labels": lab}
    if cfg.encoder is not None:
        nb["frames"] = (rng.normal(size=(B, cfg.encoder.num_positions,
                                         cfg.d_model)) * 0.02
                        ).astype(np.float32)
    if cfg.frontend is not None:
        nb["frontend_embeds"] = rng.normal(
            size=(B, cfg.frontend.num_tokens, cfg.d_model)
        ).astype(np.float32)
    return nb


def _port_params(tc, jparams):
    params = TT.Transformer(tc, torch.device("cpu"), torch.float32)
    params.load_state_dict(
        bridge.params_from_numpy(jax.tree.map(np.asarray, jparams)),
        strict=True)
    return params


def _port_loss(params, cfg, batch, remat=True):
    """JAX's ``loss_fn`` of ``make_train_step`` over the port's pieces."""
    logits, aux = TT.forward_train(params, cfg, batch, remat=remat)
    loss = TS.cross_entropy(logits, batch["labels"], cfg.vocab_size)
    if "moe_aux_loss" in aux:
        loss = loss + AUX_WEIGHT * aux["moe_aux_loss"]
    return loss, logits


@functools.lru_cache(maxsize=None)
def _jax_results(arch):
    """JAX's logits (remat on and off), loss, gradients and one AdamW
    update of them, all as numpy (gradients and parameters flat, by the
    port's names)."""
    jc, _ = _configs(arch)
    jparams = JT.init_params(jax.random.PRNGKey(7), jc, jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _np_batch(jc).items()}

    def loss_fn(p, b):
        logits, aux = JT.forward_train(p, jc, b, remat=True)
        loss = JS.cross_entropy(logits, b["labels"], jc.vocab_size)
        if "moe_aux_loss" in aux:
            loss = loss + AUX_WEIGHT * aux["moe_aux_loss"]
        return loss, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams, jb)
    plain = jax.jit(functools.partial(JT.forward_train, cfg=jc,
                                      remat=False))(jparams, batch=jb)[0]
    new, _, gnorm = JO.adamw_update(jparams, grads, JO.init_adamw(jparams),
                                    lr=LR)

    def flat(tree):
        return {k: v.numpy() for k, v in bridge.params_from_numpy(
            jax.tree.map(np.asarray, tree)).items()}
    return dict(jparams=jparams, loss=float(loss), gnorm=float(gnorm),
                logits=np.asarray(logits), logits_plain=np.asarray(plain),
                grads=flat(grads), params=flat(new))


def _tol(arch):
    if arch == "whisper-medium":
        return WHISPER_TOL["logits"], WHISPER_TOL["grad_rtol"]
    return LOGIT_TOL, GRAD_RTOL


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_matches_jax(arch, remat):
    jc, tc = _configs(arch)
    want = _jax_results(arch)
    params = _port_params(tc, want["jparams"])
    tb = {k: torch.from_numpy(v) for k, v in _np_batch(jc).items()}
    with torch.no_grad():
        logits, aux = TT.forward_train(params, tc, tb, remat=remat)
    assert logits.shape == (B, S, tc.vocab_padded)
    limit, _ = _tol(arch)
    np.testing.assert_allclose(
        logits.numpy(), want["logits" if remat else "logits_plain"],
        rtol=0, atol=limit)
    assert set(aux) == ({"moe_aux_loss", "moe_drop_frac"}
                        if any(l.ffn == "moe" for l in tc.layers) else set())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    """Every gradient leaf against JAX's; inside the port, remat on and
    off give the same loss and gradients, bit for bit."""
    jc, tc = _configs(arch)
    want = _jax_results(arch)
    params = _port_params(tc, want["jparams"])
    for p in params.parameters():
        p.requires_grad_(True)
    names = [n for n, _ in params.named_parameters()]
    tb = {k: torch.from_numpy(v) for k, v in _np_batch(jc).items()}
    got = {}
    for remat in (True, False):
        loss, _ = _port_loss(params, tc, tb, remat)
        got[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(params.parameters())))
    assert torch.equal(got[True][0], got[False][0])
    for a, b in zip(got[True][1], got[False][1]):
        assert torch.equal(a, b)
    loss, grads = got[True]
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    _, rtol = _tol(arch)
    assert set(names) == set(want["grads"])
    for n, g in zip(names, grads):
        w = want["grads"][n]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_ATOL + rtol * float(np.abs(w).max()), (n, err)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch):
    jc, tc = _configs(arch)
    want = _jax_results(arch)
    params = _port_params(tc, want["jparams"])
    tb = {k: torch.from_numpy(v) for k, v in _np_batch(jc).items()}
    opt = TO.init_adamw(params)
    params, opt, m = TS.make_train_step(tc, lr=LR)(params, opt, tb)
    assert int(opt.step) == 1
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(want["gnorm"], rel=1e-5)
    limit = WHISPER_TOL["params"] if arch == "whisper-medium" \
        else PARAM_TOL
    off = total = 0
    for n, p in params.named_parameters():
        assert p.requires_grad
        err = np.abs(p.detach().numpy() - want["params"][n])
        assert float(err.max()) < limit, (n, float(err.max()))
        off += int((err > 1e-5).sum())
        total += err.size
    assert off <= PARAM_SHARE * total, (off, total)


def test_jitted_make_train_step_matches_the_port():
    """JAX's own jitted ``make_train_step`` on llama3.2-3b, against the
    port's step from the same weights and batch."""
    jc, tc = _configs("llama3.2-3b")
    want = _jax_results("llama3.2-3b")
    jb = {k: jnp.asarray(v) for k, v in _np_batch(jc).items()}
    jp, _, jm = jax.jit(JS.make_train_step(jc, lr=LR))(
        want["jparams"], JO.init_adamw(want["jparams"]), jb)
    params = _port_params(tc, want["jparams"])
    tb = {k: torch.from_numpy(v) for k, v in _np_batch(jc).items()}
    params, _, m = TS.make_train_step(tc, lr=LR)(
        params, TO.init_adamw(params), tb)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    for n, a in bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp)).items():
        got = dict(params.named_parameters())[n].detach()
        assert float((got - a).abs().max()) < PARAM_TOL, n


def test_microbatched_train_step_matches_full_batch():
    """Twin of ``test_engine_optim.py::
    test_microbatched_train_step_matches_full_batch``: same tolerances."""
    cfg = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    gen = torch.Generator().manual_seed(0)
    params, opt = TS.init_train_state(cfg, gen, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    full = TT.Transformer(cfg, torch.device("cpu"), torch.float32)
    full.load_state_dict(params.state_dict())
    p1, _, m1 = TS.make_train_step(cfg, lr=1e-3)(full, TO.init_adamw(full),
                                                 batch)
    p2, _, m2 = TS.make_train_step(cfg, lr=1e-3, microbatches=2)(
        params, opt, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    assert m2.keys() == {"loss", "grad_norm"}
    with torch.no_grad():
        d = max(float((a - b).abs().max()) for a, b in
                zip(p1.parameters(), p2.parameters()))
    assert d < 1e-3


def test_adamw_optimizes_quadratic_as_jax():
    """Twin of ``test_engine_optim.py::test_adamw_optimizes_quadratic``,
    and the trajectory against JAX's: 300 steps within 1e-6."""
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = TO.init_adamw(params)
    jparams = {"w": jnp.array([5.0, -3.0, 2.0])}
    jopt = JO.init_adamw(jparams)
    for _ in range(300):
        g = {"w": 2 * params["w"]}
        params, opt, _ = TO.adamw_update(params, g, opt, lr=0.05,
                                         weight_decay=0.0)
        jg = {"w": 2 * jparams["w"]}
        jparams, jopt, _ = JO.adamw_update(jparams, jg, jopt, lr=0.05,
                                           weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1
    assert int(opt.step) == 300
    np.testing.assert_allclose(params["w"].numpy(),
                               np.asarray(jparams["w"]), rtol=0, atol=1e-6)


def test_adamw_state_and_clip_match_jax():
    """Moments, step, clip and decay in one step of bf16 and f32 leaves
    with gradients whose norm exceeds the clip: within 1e-6 (f32) and one
    bf16 ulp (the bf16 parameter)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    ga = (rng.normal(size=a.shape) * 3).astype(np.float32)
    gb = (rng.normal(size=b.shape) * 3).astype(np.float32)
    params = {"a": torch.from_numpy(a.copy()),
              "b": torch.from_numpy(b).to(torch.bfloat16)}
    opt = TO.init_adamw(params)
    grads = {"a": torch.from_numpy(ga), "b": torch.from_numpy(gb)}
    jp = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16)}
    jopt = JO.init_adamw(jp)
    for _ in range(2):
        params, opt, gn = TO.adamw_update(params, grads, opt, lr=0.01)
        jp, jopt, jgn = JO.adamw_update(
            jp, {"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, jopt, lr=0.01)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    assert int(opt.step) == int(jopt.step) == 2
    np.testing.assert_allclose(params["a"].numpy(), np.asarray(jp["a"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(params["b"].float().numpy(),
                               np.asarray(jp["b"], np.float32),
                               rtol=2 ** -7, atol=0)
    for k in ("a", "b"):
        np.testing.assert_allclose(opt.mu[k].numpy(), np.asarray(jopt.mu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(jopt.nu[k]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- pieces

@pytest.mark.parametrize("T", [1, 4096, 4097, 6000, 8192, 12289])
def test_num_groups_as_jax(T):
    assert TMOE._num_groups(T) == JMOE._num_groups(T)
    assert TMOE.GROUP_TOKENS == JMOE.GROUP_TOKENS


@pytest.mark.parametrize("case", ["drops", "two_groups"])
def test_moe_forward_matches_jax(case):
    """The capacity dispatch against JAX's ``moe_forward``: output within
    4e-6 (the MoE limit of the port's other checks; the reference itself
    moves by up to 7.2e-7 between its MoE paths), metrics within 1e-6.
    ``drops``: capacity factor 0.5, so a quarter or more of the replicas
    drop; ``two_groups``: 6000 tokens, two dispatch groups of 3000."""
    jc, tc = _configs("qwen3-moe-30b-a3b")
    if case == "drops":
        moe = dataclasses.replace(jc.moe, capacity_factor=0.5)
        jc, tc = (dataclasses.replace(c, moe=moe) for c in (jc, tc))
        shape = (2, 64)
    else:
        shape = (3, 2000)
    jparams = JT.init_params(jax.random.PRNGKey(2), jc, jnp.float32)
    params = _port_params(tc, jparams)
    x = np.random.default_rng(4).normal(
        size=shape + (jc.d_model,)).astype(np.float32)
    jout, jaux = JMOE.moe_forward(jparams["layers"][0]["moe"],
                                  jnp.asarray(x), jc)
    with torch.no_grad():
        out, aux = TMOE.moe_forward(params.layers[0].moe,
                                    torch.from_numpy(x), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=4e-6)
    for k in ("moe_aux_loss", "moe_drop_frac"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), abs=1e-6)
    if case == "drops":
        assert float(aux["moe_drop_frac"]) > 0.2


def test_cross_entropy_matches_jax():
    """A padded vocabulary (300 logits, 250 real) and masked labels:
    within 1e-6."""
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 9, 300)) * 3).astype(np.float32)
    labels = rng.integers(0, 250, (2, 9)).astype(np.int32)
    labels[0, :4] = -1
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 250)
    got = TS.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), 250)
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    none = torch.full((2, 9), -1, dtype=torch.int32)
    assert float(TS.cross_entropy(torch.from_numpy(logits), none, 250)) == 0


def test_cross_caches_train_equal_jax():
    """Given the same encoder output, the training forward's cross K/V
    (rounded to bf16, as JAX's) are JAX's, bit for bit."""
    jc, tc = _configs("whisper-medium")
    jparams = JT.init_params(jax.random.PRNGKey(8), jc, jnp.float32)
    params = _port_params(tc, jparams)
    enc = np.random.default_rng(6).normal(
        size=(B, jc.encoder.num_positions, jc.d_model)).astype(np.float32)
    want = JT._build_cross_caches(jparams, jc, jnp.asarray(enc),
                                  JT.init_cache(jc, B, 1))
    with torch.no_grad():
        got = TT._cross_caches_train(params, tc, torch.from_numpy(enc))
    for w, g in zip(want, got):
        assert g.k.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.k.float().numpy(),
                                      np.asarray(w.k, np.float32))
        np.testing.assert_array_equal(g.v.float().numpy(),
                                      np.asarray(w.v, np.float32))
        np.testing.assert_array_equal(g.pos.numpy(), np.asarray(w.pos))


# ---------------------------------------------------------------- the norm

def _norm_inputs(dtype, N=48, D=96, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(N, D)).astype(np.float32)
    t = [torch.from_numpy(a).to(dtype) for a in (x, w, dy)]
    return (x, w, dy), t


# dx: f32 within 1e-5 (sums in other orders); bf16 within one bf16 ulp
# of the value (both compute in fp32 and round once). dw: the columns'
# sums of N terms, within 1e-5 of the column's sum of magnitudes
NORM_DX_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
               torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _dw_limit(x, w, dy, eps=1e-5):
    r = 1 / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True)
                    + eps)
    return 1e-5 * np.abs(dy * x * r).sum(0) + 1e-7


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_bwd_ref_matches_jax_vjp(dt):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    (x, w, dy), (tx, tw, tdy) = _norm_inputs(dtype)
    xr, wr, dyr = (tx.float().numpy(), tw.float().numpy(),
                   tdy.float().numpy())
    _, vjp = jax.vjp(lambda a, b: JLAY.rmsnorm(a, b, 1e-5),
                     jnp.asarray(xr, jdt), jnp.asarray(wr, jdt))
    jdx, jdw = vjp(jnp.asarray(dyr, jdt))
    dx, dw = ref.rmsnorm_bwd_ref(tx, tw, tdy, 1e-5)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32),
                               **NORM_DX_TOL[dtype])
    if dtype == torch.float32:
        assert np.all(np.abs(dw.numpy() - np.asarray(jdw))
                      <= _dw_limit(xr, wr, dyr))
    else:       # JAX rounds dw to the weight's bf16
        np.testing.assert_allclose(dw.to(torch.bfloat16).float().numpy(),
                                   np.asarray(jdw, np.float32),
                                   rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_bwd_ref_matches_autograd_of_rmsnorm_ref(dt):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    _, (tx, tw, tdy) = _norm_inputs(dtype, seed=10)
    x = tx.clone().requires_grad_()
    w = tw.clone().requires_grad_()
    ax, aw = torch.autograd.grad(ref.rmsnorm_ref(x, w, 1e-5), (x, w), tdy)
    dx, dw = ref.rmsnorm_bwd_ref(tx, tw, tdy, 1e-5)
    torch.testing.assert_close(dx.float(), ax.float(), **NORM_DX_TOL[dtype])
    xr, wr, dyr = (t.float().numpy() for t in (tx, tw, tdy))
    if dtype == torch.float32:
        assert np.all(np.abs(dw.numpy() - aw.numpy())
                      <= _dw_limit(xr, wr, dyr))
    else:
        torch.testing.assert_close(dw.to(torch.bfloat16).float(), aw.float(),
                                   rtol=2 ** -7, atol=1e-5)


def test_rmsnorm_function_uses_its_backward():
    """With an input requiring a gradient, ``ops.rmsnorm`` is the
    Function: its gradients are ``rmsnorm_bwd_ref``'s, bit for bit, over
    a [2, 3, D] input, counted as one plain backward call; without, it is
    the plain forward alone, with no ``grad_fn``."""
    _, (tx, tw, tdy) = _norm_inputs(torch.float32, N=6, seed=11)
    x = tx.reshape(2, 3, -1).clone().requires_grad_()
    w = tw.clone().requires_grad_()
    ops.reset_counts()
    y = ops.rmsnorm(x, w)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    gx, gw = torch.autograd.grad(y, (x, w), tdy.reshape(2, 3, -1))
    dx, dw = ref.rmsnorm_bwd_ref(tx.reshape(2, 3, -1), tw,
                                 tdy.reshape(2, 3, -1))
    assert torch.equal(gx, dx) and torch.equal(gw, dw)
    c = ops.counts()
    assert c["rmsnorm"] == {"launches": 0, "plain": 1}
    assert c["rmsnorm_bwd"] == {"launches": 0, "plain": 1}
    with torch.no_grad():
        assert ops.rmsnorm(x, w).grad_fn is None
    assert ops.rmsnorm(tx, tw).grad_fn is None
    assert ops.counts()["rmsnorm"]["plain"] == 3
    assert ops.counts()["rmsnorm_bwd"]["plain"] == 1


def test_rmsnorm_bwd_grid_and_refusals():
    """The backward's grid (a row a group up to ``BWD_MAX_BLOCKS`` blocks,
    then that many) and its wrapper's refusals, which come before the
    device check, so the CPU sees them."""
    from repro_torch.kernels import rmsnorm as rms
    p = rms.bwd_plan(3072, torch.float32)
    assert (p.warps_per_row, p.units_per_lane, p.rows_per_block) == (3, 8, 2)
    assert rms.bwd_blocks(1024, p) == rms.BWD_MAX_BLOCKS == 264
    assert rms.bwd_blocks(1, p) == 1 and rms.bwd_blocks(400, p) == 200
    assert rms.bwd_blocks(10 ** 6, p) == rms.BWD_MAX_BLOCKS
    assert rms.bwd_blocks(1024, rms.bwd_plan(768, torch.float32)) == 128
    x, w = torch.zeros(4, 3072), torch.zeros(3072)
    with pytest.raises(ValueError, match="shapes"):
        rms.rmsnorm_bwd_cuda(x, w, torch.zeros(4, 3071))
    with pytest.raises(TypeError, match="dtype"):
        rms.rmsnorm_bwd_cuda(x, w, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="at most 8"):
        rms.rmsnorm_bwd_cuda(torch.zeros(2, 16384), torch.zeros(16384),
                             torch.zeros(2, 16384))
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm_bwd_cuda(x, w, x)


@pytest.fixture
def kernel_route(monkeypatch):
    """Route ``ops`` to the kernel wrappers, the attention and norm
    wrappers each replaced by a stub that runs the plain version and
    records its call: the kernel route's wiring, without a card."""
    calls = []

    def stub(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(ops, "_plain", lambda name, device: False)
    monkeypatch.setattr(ops._pa, "paged_attention_cuda", stub(
        "paged_attention", ref.paged_attention_ref))
    monkeypatch.setattr(ops._pa8, "paged_attention_int8_cuda", stub(
        "paged_attention_int8",
        lambda q, k, v, ks, vs, bt, lens: ref.paged_attention_ref(
            q, k, v, bt, lens, ks, vs)))
    monkeypatch.setattr(ops._cpa, "chunked_prefill_attention_cuda", stub(
        "chunked_prefill_attention",
        lambda q, k, v, qo, kl, window=None:
        ref.chunked_prefill_attention_ref(q, k, v, qo, kl, window=window)))
    monkeypatch.setattr(ops._rms, "rmsnorm_cuda", stub(
        "rmsnorm", ref.rmsnorm_ref))
    monkeypatch.setattr(ops._rms, "rmsnorm_bwd_cuda", stub(
        "rmsnorm_bwd", ref.rmsnorm_bwd_ref))
    return calls


def _kernel_calls(name, rng):
    """A call of ``ops.<name>`` on small random inputs, and the tensors
    that may require a gradient."""
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bt = torch.tensor([[0, 1]], dtype=torch.int32)
    lens = torch.tensor([20], dtype=torch.int32)
    if name == "paged_attention":
        q = t(1, 4, 16)
        return (lambda: ops.paged_attention(q, t(3, 16, 2, 16),
                                            t(3, 16, 2, 16), bt, lens)), q
    if name == "paged_attention_int8":
        q = t(1, 4, 16)
        k8 = torch.randint(-127, 128, (3, 16, 2, 16), dtype=torch.int8)
        sc = t(3, 16, 2).abs().to(torch.bfloat16)
        return (lambda: ops.paged_attention(q, k8, k8, bt, lens,
                                            k_scales=sc, v_scales=sc)), q
    q = t(1, 8, 4, 16)
    return (lambda: ops.chunked_prefill_attention(
        q, t(1, 8, 2, 16), t(1, 8, 2, 16))), q


@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_int8",
                                  "chunked_prefill_attention"])
def test_kernel_without_backward_refuses_grad(kernel_route, name):
    """On the kernel route, an input requiring a gradient raises, naming
    the kernel, before the wrapper runs; under ``no_grad`` the wrapper
    runs."""
    call, t = _kernel_calls(name, np.random.default_rng(12))
    t.requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call()
    assert kernel_route == []
    with torch.no_grad():
        call()
    t.requires_grad_(False)
    call()
    assert kernel_route == [name, name]


def test_rmsnorm_kernel_route_runs_both_kernels(kernel_route):
    """On the kernel route the Function's forward and backward are the
    two wrappers, once each."""
    _, (tx, tw, tdy) = _norm_inputs(torch.float32, N=4, seed=13)
    x = tx.clone().requires_grad_()
    y = ops.rmsnorm(x, tw)
    (gx,) = torch.autograd.grad(y, (x,), tdy)
    assert kernel_route == ["rmsnorm", "rmsnorm_bwd"]
    assert torch.equal(gx, ref.rmsnorm_bwd_ref(tx, tw, tdy)[0])


# ---------------------------------------------------------------- script

@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium",
                                  "internvl2-76b"])
def test_synthetic_batch_and_small_100m_as_jax(arch):
    jc = JTR.small_100m(jax_get_config(arch))
    tc = TTR.small_100m(get_config(arch))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for seed in (0, 3):
        jrng, trng = (np.random.default_rng(seed) for _ in range(2))
        for _ in range(2):          # the stream, not only its first batch
            want = JTR.synthetic_batch(jrng, jc, 2, 24)
            got = TTR.synthetic_batch(trng, tc, 2, 24)
            assert set(want) == set(got)
            for k in want:
                assert got[k].dtype == {"tokens": torch.int32,
                                        "labels": torch.int32}.get(
                                            k, torch.float32)
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def _trained_state(arch="mamba2-370m", steps=1):
    cfg = get_config(arch).reduced(num_layers=2, d_model=128)
    params, opt = TS.init_train_state(cfg, torch.Generator().manual_seed(3),
                                      device="cpu")
    step = TS.make_train_step(cfg, lr=1e-3)
    for i in range(steps):
        batch = TTR.synthetic_batch(np.random.default_rng(i), cfg, 2, 16)
        params, opt, _ = step(params, opt, batch)
    return cfg, params, opt


def test_checkpoint_roundtrip(tmp_path):
    """Twin of ``test_engine_optim.py::test_checkpoint_roundtrip``, after
    a step (the moments nonzero)."""
    cfg, params, opt = _trained_state()
    p = tmp_path / "ck.npz"
    TC.save_checkpoint(p, params, opt, step=42)
    fresh, fopt = TS.init_train_state(cfg, torch.Generator().manual_seed(9),
                                      device="cpu")
    params2, opt2, step = TC.restore_checkpoint(p, fresh, fopt)
    assert step == 42 and params2 is fresh
    for (n, a), b in zip(params.named_parameters(), params2.parameters()):
        assert torch.equal(a, b), n
    assert int(opt2.step) == int(opt.step) == 1
    for k in opt.mu:
        assert torch.equal(opt.mu[k], opt2.mu[k])
        assert torch.equal(opt.nu[k], opt2.nu[k])
    assert float(opt.mu["embed"].abs().max()) > 0


def test_checkpoint_bf16_leaves_written_as_f32(tmp_path):
    cfg = get_config("llama3.2-3b").reduced(num_layers=2, d_model=64)
    params = TT.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu", dtype=torch.bfloat16)
    TC.save_checkpoint(tmp_path / "b.npz", params)
    with np.load(tmp_path / "b.npz") as z:
        assert z["p/embed"].dtype == np.float32
    back = TT.Transformer(cfg, torch.device("cpu"), torch.bfloat16)
    TC.restore_checkpoint(tmp_path / "b.npz", back)
    for a, b in zip(params.parameters(), back.parameters()):
        assert torch.equal(a, b)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jc, tc = _configs("jamba-v0.1-52b")
    jparams = JT.init_params(jax.random.PRNGKey(5), jc)
    jopt = JO.init_adamw(jparams)
    grads = jax.tree.map(lambda a: jnp.ones_like(a) * 0.01, jparams)
    jparams, jopt, _ = JO.adamw_update(jparams, grads, jopt)
    JC.save_checkpoint(tmp_path / "j.npz", jparams, jopt, step=7)
    params = TT.Transformer(tc, torch.device("cpu"), torch.float32)
    opt = TO.init_adamw(params)
    params, opt, step = TC.restore_checkpoint(tmp_path / "j.npz", params, opt)
    assert step == 7 and int(opt.step) == 1
    want = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    for n, t in params.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), want[n].numpy())
    want_opt = bridge.adamw_from_numpy(jax.tree.map(np.asarray, jopt),
                                       device="cpu")
    for k in opt.mu:
        assert torch.equal(opt.mu[k], want_opt.mu[k])
        assert torch.equal(opt.nu[k], want_opt.nu[k])


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port-written file carries JAX's keys and JAX's
    ``restore_checkpoint`` reads it: every leaf equal."""
    cfg, params, opt = _trained_state("qwen3-moe-30b-a3b")
    TC.save_checkpoint(tmp_path / "t.npz", params, opt, step=3)
    jc = jax_get_config("qwen3-moe-30b-a3b").reduced(num_layers=2,
                                                     d_model=128)
    jtpl = JT.init_params(jax.random.PRNGKey(0), jc)
    jparams, jopt, step = JC.restore_checkpoint(tmp_path / "t.npz", jtpl,
                                                JO.init_adamw(jtpl))
    assert step == 3 and int(jopt.step) == 1
    JC.save_checkpoint(tmp_path / "j.npz", jparams, jopt, step=3)
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert set(zt.files) == set(zj.files)
        assert {"__step__", "p/embed", "p/layers/0/attn/wq", "o/step",
                "o/mu/layers/0/moe/router", "o/nu/final_norm"} <= set(zt.files)
        for k in zt.files:
            np.testing.assert_array_equal(zt[k], zj[k])


def test_bridge_round_trips_params_and_adamw():
    cfg, params, opt = _trained_state("whisper-medium")
    tree = bridge.params_to_numpy(params)
    jtpl = JT.init_params(jax.random.PRNGKey(0), _configs(
        "whisper-medium")[0])
    assert jax.tree.structure(tree) == jax.tree.structure(jtpl)
    back = bridge.params_from_numpy(tree)
    for n, t in params.named_parameters():
        assert torch.equal(t.detach(), back[n])
    jopt = JO.AdamWState(**bridge.adamw_to_numpy(opt))
    assert jax.tree.structure(jopt.mu) == jax.tree.structure(jtpl)
    opt2 = bridge.adamw_from_numpy(jopt, device="cpu")
    assert int(opt2.step) == 1 and opt2.step.dtype == torch.int32
    for k in opt.mu:
        assert torch.equal(opt.mu[k], opt2.mu[k])
        assert torch.equal(opt.nu[k], opt2.nu[k])


def test_train_script_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU, as a user runs it, on a reduced variant (the
    ~100M one is too large for a unit test): JAX's printed lines, a
    checkpoint after 3 steps, and a resumed run that starts at step 3."""
    monkeypatch.setattr(TTR, "small_100m",
                        lambda cfg: cfg.reduced(num_layers=2, d_model=64))
    ck = tmp_path / "ck.npz"
    common = ["--device", "cpu", "--batch", "2", "--seq", "16",
              "--log-every", "1", "--arch", "qwen3-moe-30b-a3b"]
    params, opt, m = TTR.main(common + ["--steps", "3", "--checkpoint",
                                        str(ck)])
    out = capsys.readouterr().out.splitlines()
    cfg = get_config("qwen3-moe-30b-a3b").reduced(num_layers=2, d_model=64)
    assert out[0] == (f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
                      f"layers={cfg.num_layers} d_model={cfg.d_model}")
    steps = [int(re.match(r"step +(\d+) loss +[\d.]+ gnorm +[\d.]+ "
                          r"tok/s +\d+$", line).group(1))
             for line in out[1:4]]
    assert steps == [0, 1, 2]
    assert out[4] == f"saved {ck}"
    assert re.fullmatch(r"final loss [\d.]+ \(uniform = 6\.24\)", out[5])
    assert int(opt.step) == 3 and "moe_aux_loss" in m
    _, opt2, _ = TTR.main(common + ["--steps", "5", "--resume", str(ck)])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "resumed from step 3"
    assert [line.split()[1] for line in out[2:4]] == ["3", "4"]
    assert int(opt2.step) == 5


def test_step_time_times_the_steps_on_the_plain_route(capsys):
    """``launch.step_time`` on the CPU at a reduced Mamba2: one line with
    every step's time and their median, the losses those of
    ``make_train_step`` on the same batches, and the scan's and the norm's
    plain versions counted (the CPU never launches a kernel)."""
    from repro_torch.launch import step_time
    argv = ["--device", "cpu", "--reduced", "--arch", "mamba2-370m",
            "--batch", "1", "--seq", "32", "--steps", "2"]
    r = step_time.main(argv)
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"\[step_time\] repro_torch from .+: "
                        r"mamba2-370m \(\d+ layers, d_model \d+\), f32, "
                        r"batch 1 x 32: median step [\d.]+ ms of steps 2-2 "
                        r"\(steps \[[\d., ]+\] ms\), losses \[[\d., ]+\]; "
                        r"kernels .+", line), line
    assert len(r["ms"]) == 2 and r["median_ms"] == r["ms"][1]
    cfg = get_config("mamba2-370m").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params, opt = TS.init_train_state(cfg, gen, device="cpu")
    rng = np.random.default_rng(0)
    batches = [TTR.synthetic_batch(rng, cfg, 1, 32, "cpu") for _ in range(2)]
    step = TS.make_train_step(cfg)
    for b, loss in zip(batches, r["losses"]):
        params, opt, m = step(params, opt, b)
        assert float(m["loss"]) == loss
    c = r["counts"]
    assert all(c[k]["launches"] == 0 for k in c)
    assert c["ssd_scan_bwd"]["plain"] > 0 and c["rmsnorm_bwd"]["plain"] > 0
