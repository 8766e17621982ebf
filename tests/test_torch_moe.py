"""PyTorch port vs JAX package: the mixture-of-experts LMs
(``repro_torch.models.moe``, arctic-480b's and kimi-k2-1t-a32b's family):
routing and the capacity dispatch, the training loss and its gradients,
the quantizer's grain, oneshot prefill and decode, a DPQuant step, the
sharding rules, the CLIs and the parameter counts of the card's cuts.

On the same numpy params and tokens (made from a seed with numpy) at the
two smoke configs (2 layers; arctic-smoke: d_model 48, 4 experts of 64,
top-2 and a dense residual MLP of 48; kimi-k2-smoke: d_model 64, 8
experts of 96, top-2; both the capacity dispatch at factor 1.25, float32;
sequences of 12 tokens):

* ``convert`` carries the reference's tree to the port's flat names and
  back unchanged; the port's init has the reference's names, shapes and
  dtypes (the router float32);
* ``_route``'s ids, ``_capacity`` and each (token, slot) pair's position
  and overflow are bitwise the reference's (the positions against the
  reference's own lines, ``src/repro/models/moe.py:117-128``), at the
  published factor and at 0.5, where pairs drop; the gates within 1e-6;
* ``moe_ffn_capacity`` and ``moe_ffn_dense`` within rtol 1e-5 of the
  reference's (``jax.vmap`` over the batch) at fmt ``none``, with and
  without drops, and the two dispatches agree when nothing drops;
* ``lm_loss`` within rtol 1e-5, its gradients and the vmap engine's
  per-example gradients (3 examples) within rtol 1e-4 of the mean of
  ``jax.vmap(jax.grad)``'s (the mean loss's ``jax.grad``) and of each of
  them, at fmt none and with every layer
  quantized at an identity format registered in both packages (one
  compiled reference program, the flags an argument); torch.func's
  warnings are errors there (a batching-rule fallback would loop over the
  examples on the card); the router's gradient flows through the gates
  alone (detached gates leave it zero);
* at luq_fp4 the quantizer sees the reference's grain: each expert
  weight whole, the dispatch buffer and the expert GEMMs' cotangents one
  row per example, attention and the dense residual MLP whole (the
  reference's quantizer calls, traced; arctic-smoke, which has all
  three kinds of projection);
* prefill (a cache longer than the prompt) and three decode steps within
  rtol 1e-5 of the reference's; at capacity factor E / k decode within
  1e-4 of a prefill of the extended prompt;
* one ``build_train_setup`` step of arctic-smoke (microbatch 2, sigma 0,
  the identity format) within rtol 2e-4 of the reference's (1, 1)-mesh
  step;
* the FULL configs' ``sharding_overrides`` lay the microbatch over
  ``data`` alone on a (pod 2, data 2) mesh, in both packages;
* the train CLI runs DPQuant steps, ``--grad-mode ghost`` raises the
  reference's error, and the serve CLI's ``--engine continuous`` falls
  back to oneshot with the same tokens;
* the parameter counts of the card's training cut (2 layers of 8 experts,
  and the 6-expert fallback) and serving cuts (one layer) equal the
  reference's ``jax.eval_shape`` counts, the port's taken under
  ``FakeTensorMode`` (nothing allocated).
"""
import dataclasses
import functools
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

import repro.quant.backend as jbackend  # noqa: E402
from repro.config import DPConfig as JDPConfig  # noqa: E402
from repro.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as jax_full_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.mesh import make_compat_mesh as jmesh  # noqa: E402
from repro.launch.steps import build_train_setup as jsetup  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.parallel import partitioner as jpt  # noqa: E402
from repro_torch.config import (DPConfig, OptimConfig,  # noqa: E402
                                QuantConfig, RunConfig)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import partitioner as pt  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.serve import build_oneshot_fns  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
QFMT = "identity_for_tests"
B, S = 3, 12


def jax_config(arch, **kw):
    # remat recomputes the same numbers; off, the reference compiles faster
    return dataclasses.replace(jax_smoke_config(arch), remat=False, **kw)


def port_config(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), **kw)


def numpy_params(cfg, seed):
    """Params of the JAX model's shapes from numpy: N(0, 0.1^2) for the
    embedding and norms, the matrices N(0, 1/fan_in), the router N(0, 4 /
    d) (routing decided by clear margins)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jmoe.init_params(k, cfg),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        scale = 0.1
        if "'router'" in name:
            scale = 2.0 / np.sqrt(s.shape[1])
        elif "'e_" in name:
            scale = 1.0 / np.sqrt(s.shape[2])
        elif len(s.shape) >= 3:
            fan_in = s.shape[1] * (s.shape[2] if "'wo'" in name else 1)
            scale = 1.0 / np.sqrt(fan_in)
        return (scale * rng.standard_normal(s.shape)).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tokens_of(cfg, n=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)


def _port(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _flat(tree):
    return {k: v.float().numpy() for k, v in _port(tree).items()}


@pytest.fixture(scope="module")
def identity_format():
    """``QFMT`` registered in both packages as the identity quantizer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda x, key=None: x)
        mp.setitem(qbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda rows, key: rows.clone())
        yield QFMT


# --------------------------------------------------------------------------- #
# params and counts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_params_convert_both_ways_and_match_the_port_init(arch):
    params = numpy_params(jax_config(arch), 1)
    flat = _port(params)
    assert flat["blocks.router"].dtype == torch.float32
    back = params_to_numpy(flat)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))
    init = moe.init_params(0, port_config(arch), torch.device("cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in flat.items()}


@pytest.mark.parametrize("arch, cut, want", [
    ("arctic-480b", dict(n_layers=2, n_experts=8), 2_475_576_320),
    ("arctic-480b", dict(n_layers=2, n_experts=6), 2_057_165_824),
    ("arctic-480b", dict(n_layers=1), 13_904_794_624),
    ("kimi-k2-1t-a32b", dict(n_layers=1), 18_204_218_368)])
def test_parameter_counts_of_the_card_cuts_match_jax(arch, cut, want):
    jcfg = dataclasses.replace(jax_full_config(arch), **cut)
    shapes = jax.eval_shape(lambda k: jmoe.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == want
    cfg = dataclasses.replace(get_config(arch), **cut)
    with FakeTensorMode():
        params = moe.init_params(0, cfg, torch.device("cpu"))
    assert sum(t.numel() for t in params.values()) == want
    assert params["blocks.router"].dtype == torch.float32
    assert moe.prepare(params, cfg)["blocks.router"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# routing and dispatch
# --------------------------------------------------------------------------- #
def _jax_positions(ids, E, C):
    """The reference's positions and overflow of one example's (S, k) ids,
    its own lines (``src/repro/models/moe.py:117-128``)."""
    S, k = ids.shape
    onehot = jax.nn.one_hot(ids, E, dtype=jnp.int32)
    counts = onehot.reshape(S * k, E)
    pos_flat = jnp.cumsum(counts, axis=0) - counts
    pos = jnp.take_along_axis(
        pos_flat.reshape(S, k, E), ids[..., None], axis=-1)[..., 0]
    return pos, pos >= C


def _hidden(cfg, seed, n=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, s, cfg.d_model)).astype(np.float32)


def _layer0(params):
    return {k: v[0] for k, v in params["blocks"].items()}


@pytest.mark.parametrize("factor", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_capacity_and_positions_match_jax_bitwise(arch, factor):
    kw = {} if factor is None else {"moe_capacity_factor": factor}
    jcfg, cfg = jax_config(arch, **kw), port_config(arch, **kw)
    params = numpy_params(jcfg, 2)
    h = _hidden(jcfg, 4)
    router = params["blocks"]["router"][0]
    jids, jgates = jax.jit(jax.vmap(lambda hh: jmoe._route(hh, router,
                                                           jcfg)))(h)
    ids, gates = moe._route(torch.from_numpy(h), torch.from_numpy(router),
                            cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-6,
                               atol=1e-7)
    for n in (1, 2, 5, S, 64, 512):
        assert moe._capacity(cfg, n) == jmoe._capacity(jcfg, n), n
    C = moe._capacity(cfg, S)
    jpos, jover = jax.jit(jax.vmap(
        lambda i: _jax_positions(i, cfg.n_experts, C)))(jids)
    pos, over = moe._positions(ids, cfg.n_experts, C)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    if factor == 0.5:
        assert over.any()


@pytest.mark.parametrize("factor", [None, 0.5])
@pytest.mark.parametrize("impl", ["capacity", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_dispatches_match_jax(arch, impl, factor):
    kw = {"moe_impl": impl}
    if factor is not None:
        kw["moe_capacity_factor"] = factor
    jcfg, cfg = jax_config(arch, **kw), port_config(arch, **kw)
    params = numpy_params(jcfg, 5)
    h = _hidden(jcfg, 6)
    jblk = _layer0(params)
    fn = getattr(jmoe, f"moe_ffn_{impl}")
    want = jax.jit(jax.vmap(lambda hh: fn(hh, jblk, jnp.float32(0.0),
                                          jnp.uint32(0), jcfg,
                                          JQuantConfig(fmt="none"))))(h)
    blk = {k: torch.from_numpy(np.asarray(v)) for k, v in jblk.items()}
    got = getattr(moe, f"moe_ffn_{impl}")(
        torch.from_numpy(h), blk, False, 0, cfg, QuantConfig(fmt="none"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_and_capacity_agree_when_nothing_drops(arch):
    """At factor E / k every expert holds a whole sequence (C = S): the
    scatter / gather dispatch computes what every expert on every token
    does (the port's counterpart of ``tests/test_models_smoke.py:125``)."""
    base = port_config(arch)
    cfg = dataclasses.replace(base, moe_capacity_factor=(
        base.n_experts / base.top_k))
    assert moe._capacity(cfg, S) == S
    params = _port(numpy_params(jax_config(arch), 7))
    blk = moe._layer(params, cfg, 1)
    h = torch.from_numpy(_hidden(cfg, 8))
    quant = QuantConfig(fmt="none")
    ids, _ = moe._route(h, blk["router"], cfg)
    assert not moe._positions(ids, cfg.n_experts, S)[1].any()
    np.testing.assert_allclose(
        moe.moe_ffn_capacity(h, blk, False, 97, cfg, quant).numpy(),
        moe.moe_ffn_dense(h, blk, False, 97, cfg, quant).numpy(), **TOL)


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_reference(arch):
    """The reference's per-example losses and gradients,
    ``jax.vmap(jax.value_and_grad)``, compiled once at the identity format
    with params, tokens and flags its arguments: at flags 0 its
    quantizers' ``lax.cond`` takes the identity branch, so it computes fmt
    none's numbers; at flags 1 the quantized path's.  Every example has
    the batch's length, so their mean is the mean loss and the mean of
    their gradients its ``jax.grad`` (one program instead of two)."""
    jcfg = jax_config(arch)
    quant = JQuantConfig(fmt=QFMT)

    @jax.jit
    def fn(p, tok, flags):
        def loss(pp, t):
            return jmoe.lm_loss(pp, {"tokens": t[None]}, None, flags, jcfg,
                                quant)
        return jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0))(p, tok)

    def reference(params, tokens, flags):
        return fn(params, jnp.asarray(tokens),
                  jnp.full((jcfg.n_layers,), flags, jnp.float32))
    return reference


def _port_per_example(model, params, tokens, flags):
    def one(p, t):
        return model.loss_fn(p, {"tokens": t[None]}, flags)
    with warnings.catch_warnings():
        # a batching rule's fallback warns (and would loop over the
        # examples on the card)
        warnings.simplefilter("error")
        return vmap(grad(one), in_dims=(None, 0), randomness="same")(
            params, torch.from_numpy(tokens))


@pytest.mark.parametrize("flags", [0.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_and_per_example_gradients_match_jax(
        arch, flags, identity_format):
    jcfg = jax_config(arch)
    params = numpy_params(jcfg, 11)
    tokens = tokens_of(jcfg, seed=12)
    jlosses, jper = _jax_reference(arch)(params, tokens, flags)
    jper = _flat(jper)
    jgrad = {k: v.mean(0) for k, v in jper.items()}
    cfg = port_config(arch, remat=False)
    fmt = "none" if flags == 0.0 else QFMT
    model = build_model(cfg, QuantConfig(fmt=fmt, backend="ref"),
                        device="cpu")
    tparams = {k: v.requires_grad_() for k, v in _port(params).items()}
    qflags = torch.full((cfg.n_layers,), flags)
    loss = model.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                         qflags)
    np.testing.assert_allclose(loss.item(), float(np.mean(jlosses)), **TOL)
    grads = dict(zip(tparams, torch.autograd.grad(loss,
                                                  list(tparams.values()))))
    per = _port_per_example(model, tparams, tokens, qflags)
    for what, got, want in (("mean", grads, jgrad),
                            ("per example", per, jper)):
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w,
                                       err_msg=f"{what} {name}", **GRAD_TOL)
    # the router learns through its gates
    assert np.abs(jper["blocks.router"]).max() > 1e-4


def test_the_router_learns_through_the_gates_alone(monkeypatch):
    """The top-k ids are integers: with the gates detached the router's
    gradient is exactly zero, while every other leaf keeps one."""
    cfg = port_config("arctic-480b")
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    params = {k: v.requires_grad_() for k, v in
              _port(numpy_params(jax_config("arctic-480b"), 13)).items()}
    tokens = torch.from_numpy(tokens_of(cfg, seed=14))
    route = moe._route

    def detached(h, router_w, c):
        ids, gates = route(h, router_w, c)
        return ids, gates.detach()

    for patched in (False, True):
        if patched:
            monkeypatch.setattr(moe, "_route", detached)
        loss = model.loss_fn(params, {"tokens": tokens}, (False,) * 2)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        g = dict(zip(params, gs))
        assert (g["blocks.router"] is None) == patched
        assert all(v is not None and v.abs().max() > 0
                   for k, v in g.items() if k != "blocks.router")


def _grain_of_jax(arch, monkeypatch):
    """{(fold, elements a quantized row)} of the reference's quantizer
    calls in the gradient of its mean loss over 2 examples at luq_fp4,
    traced; a call inside ``moe_block``'s ``vmap`` sees one example."""
    from repro.quant import fake_quant as jfq

    jcfg = jax_config(arch)
    orig = jbackend._REGISTRY[("quantize", "luq_fp4", "ref")]
    orig_mq = jfq._maybe_quant
    folds, pairs = [], set()

    def spy_mq(x, seed, fold, fmt, flag, backend="ref", per_example=False):
        folds.append(fold)
        return orig_mq(x, seed, fold, fmt, flag, backend, per_example)

    def q(x, key=None):
        pairs.add((folds[-1], int(np.prod(x.shape))))
        return orig(x, key)

    monkeypatch.setitem(jbackend._REGISTRY, ("quantize", "luq_fp4", "ref"),
                        q)
    monkeypatch.setattr(jfq, "_maybe_quant", spy_mq)
    params = numpy_params(jcfg, 15)
    tokens = jnp.asarray(tokens_of(jcfg, n=2, seed=16))
    flags = jnp.ones((jcfg.n_layers,), jnp.float32)
    jax.eval_shape(jax.grad(lambda p: jmoe.lm_loss(
        p, {"tokens": tokens}, None, flags, jcfg,
        JQuantConfig(fmt="luq_fp4"))), params)
    return pairs


@pytest.mark.parametrize("arch", ["arctic-480b"])
def test_quantizer_grain_matches_jax(arch, monkeypatch):
    """Each expert weight whole, the dispatch buffer and the expert GEMMs'
    cotangents one row per example, attention and the residual MLP whole:
    the (fold, row size) of every quantizer call is the reference's, and
    the port's per-example calls hold one row for each of the 2
    examples."""
    want = _grain_of_jax(arch, monkeypatch)
    cfg = port_config(arch)
    seen = []
    orig = fq._quantize_rows

    def spy(rows, fmt, backend, seed, fold, flag=None):
        seen.append((seed % 97, fold, tuple(rows.shape)))
        return orig(rows, fmt, backend, seed, fold, flag)

    monkeypatch.setattr(fq, "_quantize_rows", spy)
    model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="ref"),
                        device="cpu")
    params = {k: v.requires_grad_() for k, v in
              _port(numpy_params(jax_config(arch), 15)).items()}
    loss = model.loss_fn(params, {"tokens": torch.from_numpy(
        tokens_of(cfg, n=2, seed=16))}, torch.ones(cfg.n_layers))
    torch.autograd.grad(loss, list(params.values()))
    assert {(fold, n) for _, fold, (_, n) in seen} == want
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    C = moe._capacity(cfg, S)
    for proj, fold, (rows, n) in seen:
        expert = proj in (10, 11, 12)
        weight = fold in (1, 2)
        assert rows == (1 if weight or not expert else 2), (proj, fold)
        if expert and weight:
            assert n == E * d * f
        if proj in (10, 11) and fold in (0, 4):
            assert n == E * C * d          # one example's dispatch buffer


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg = jax_config(arch)
    params = numpy_params(jcfg, 17)
    tokens = tokens_of(jcfg, seed=18)
    jquant = JQuantConfig(fmt="none")
    cfg = port_config(arch)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    tp = model.prepare(_port(params))
    cache_len = S + 4
    prefill, decode = build_oneshot_fns(model, cache_len)
    jdecode = jax.jit(lambda p, c, t: jmoe.decode_step(p, c, t, jcfg,
                                                       jquant))
    jlog, jcache = jax.jit(lambda p, t: jmoe.prefill(
        p, {"tokens": t}, jcfg, jquant, cache_len=cache_len))(
            params, jnp.asarray(tokens))
    tlog, tcache = prefill(tp, {"tokens": torch.from_numpy(tokens)})
    for step in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   err_msg=f"logits {step}", **TOL)
        for name in ("k", "v"):
            assert tcache[name].shape == jcache[name].shape
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       err_msg=f"{name} {step}", **TOL)
        assert tcache["pos"] == int(jcache["pos"]) == S + step
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        jlog, jcache = jdecode(params, jcache, jnp.asarray(tok))
        tlog, tcache = decode(tp, tcache, torch.from_numpy(tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_a_prefill_of_the_extended_prompt_without_drops(arch):
    """At capacity factor E / k the prompt's prefill drops nothing, as
    one-token decode never does: decode's logits are a prefill's of the
    extended prompt."""
    base = port_config(arch)
    cfg = dataclasses.replace(base, moe_capacity_factor=(
        base.n_experts / base.top_k))
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    tp = model.prepare(_port(numpy_params(jax_config(arch), 19)))
    tokens = torch.from_numpy(tokens_of(cfg, seed=20))
    prefill, decode = build_oneshot_fns(model, S + 5)
    logits, cache = prefill(tp, {"tokens": tokens})
    seq = tokens
    for step in range(5):
        tok = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, cache = decode(tp, cache, tok)
        want, _ = model.prefill(tp, {"tokens": seq})
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")


# --------------------------------------------------------------------------- #
# the DPQuant step and the sharding rules
# --------------------------------------------------------------------------- #
def test_train_step_matches_jax(identity_format):
    """One step of each package's ``build_train_setup`` (vmap engine,
    microbatch 2, clip 0.5, no noise, every layer quantized at the
    identity format) from the same params and batch."""
    arch = "arctic-480b"
    jcfg, cfg = jax_config(arch), port_config(arch)
    params = numpy_params(jcfg, 21)
    tokens = tokens_of(jcfg, n=4, seed=22)
    kw = dict(clip_norm=0.5, noise_multiplier=0.0, microbatch_size=2)
    jrun = JRunConfig(model=jcfg, quant=JQuantConfig(fmt=QFMT),
                      dp=JDPConfig(**kw),
                      optim=JOptimConfig(name="sgd", lr=0.1),
                      global_batch=4, seq_len=S)
    jset = jsetup(jax_build_model(jcfg, jrun.quant), jrun,
                  jmesh((1, 1), ("data", "model")))
    want, _, jm = jax.jit(jset.step_fn)(
        params, jset.opt_init_fn(params), {"tokens": jnp.asarray(tokens)},
        jnp.uint32(0), jnp.ones((jcfg.n_layers,), jnp.float32),
        jnp.float32(0.1))
    run = RunConfig(model=cfg, quant=QuantConfig(fmt=QFMT, backend="ref"),
                    dp=DPConfig(**kw), optim=OptimConfig(name="sgd", lr=0.1),
                    global_batch=4, seq_len=S)
    setup = steps.build_train_setup(build_model(cfg, run.quant,
                                                device="cpu"), run)
    p = _port(params)
    got, _, metrics = setup.step_fn(
        p, setup.opt_init_fn(p), {"tokens": torch.from_numpy(tokens)}, 0,
        torch.ones(cfg.n_layers), torch.tensor(0.1))
    want = _flat(want)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name,
                                   rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(jm["clip_fraction"]) > 0


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_overrides_lay_the_microbatch_as_jax(arch):
    mesh = FakeMesh((2, 2), ("pod", "data"))
    full, jfull = get_config(arch), jax_full_config(arch)
    assert full.sharding_overrides == jfull.sharding_overrides
    for mb in (2, 4, 8):
        want = jpt.assign_spec(("batch",), (mb,), mesh, jpt.merge_rules(
            jpt.DEFAULT_RULES, jfull.sharding_overrides))
        got = pt.assign_spec(("batch",), (mb,), mesh, pt.merge_rules(
            pt.DEFAULT_RULES, full.sharding_overrides))
        assert tuple(got) == tuple(want) == ("data",)


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #
def test_cli_trains_and_serves_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    base = ["--arch", "arctic-480b", "--smoke", "--device", "cpu",
            "--batch", "2", "--microbatch", "1", "--seq-len", "10",
            "--dataset-size", "4096"]
    train_cli.main(base + ["--epochs", "1", "--steps-per-epoch", "2",
                           "--clip-backend", "fused",
                           "--quant-fraction", "0.5"])
    out = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in out if ln.startswith("epoch ")]
    assert len(epochs) == 1
    assert "k=1 " in epochs[0] and "acc=None" in epochs[0]     # 0.5 x 2
    assert math.isfinite(float(epochs[0].split("loss=")[1].split()[0]))
    with pytest.raises(ValueError, match="has no ghost hooks"):
        train_cli.main(base + ["--grad-mode", "ghost", "--epochs", "1",
                               "--steps-per-epoch", "1"])
    serve = ["--arch", "kimi-k2-1t-a32b", "--smoke", "--device", "cpu",
             "--batch", "2", "--prompt-len", "10", "--gen", "4"]
    serve_cli.main(serve + ["--engine", "oneshot"])
    oneshot = capsys.readouterr().out
    serve_cli.main(serve + ["--engine", "continuous"])
    fallback = capsys.readouterr().out
    assert "falling back to --engine oneshot" in fallback
    assert fallback.split("generated token ids:")[1] == \
        oneshot.split("generated token ids:")[1]
    with pytest.raises(ValueError, match="does not support kv_fmt"):
        serve_cli.main(serve + ["--engine", "oneshot", "--kv-fmt", "int8"])
