"""PyTorch port vs JAX package: the Griffin hybrid
(``repro_torch.models.griffin``): parameters, the RG-LRU scan, the
training loss and gradients, oneshot prefill and decode, and the CLIs.

On the same numpy params and tokens (made from a seed with numpy) at the
smoke config (8 layers: two (rec, rec, attn) superblocks and a 2-layer
recurrent tail; d_model 48, lru_width 64, window 8; sequences of 16
tokens, longer than the window):

* ``convert`` carries the reference's parameter tree to the port's flat
  names and back unchanged, and the port's init has the reference's
  names, shapes and dtypes;
* ``rglru_scan`` (recursive doubling) within 1e-5 of a numpy sequential
  loop, with and without ``h0``;
* ``forward_hidden`` and ``lm_loss`` within 1e-5 (relative) of the
  reference's at fmt ``none``, float32; per-example gradients of two
  examples under ``torch.func.vmap`` within 1e-5 of
  ``jax.vmap(jax.grad)`` (one compiled program, the forward with it,
  serves this case, the next and the reference's forward below: at the
  identity format, the flags an argument);
* every layer quantized at an identity format (registered in both
  packages): the loss and the gradients of the quantized autograd path
  within 1e-5; the quantizer seeds of each layer are the reference's
  (superblock ``397 s`` + 0..7, rec2 + 11, attention + 23, tail
  ``1_000_003 + 397 t``) and a layer's flag routes only its own
  projections; at luq_fp4 (the port's own Philox draws: a statistical
  check) the loss is within 5 % of fmt none's, and every per-example
  gradient is finite, within a factor 2 of fmt none's in norm and
  positively correlated with it (LUQ's noise through every quantized
  dgrad leaves a cosine of 0.15-0.19 at this size);
* at bf16 compute: every quantized projection's operand dtypes are the
  reference's (traced; the gate products take the float32 conv output
  against a bf16 weight) and the loss is finite;
* with a prompt at least the window (12 tokens): prefill's logits and
  cache and three decode steps' within 1e-5 of the reference's;
* with a prompt shorter than the window (4 tokens, a cache of 16
  positions): decode's logits within 1e-4 of the reference's prefill of
  the extended prompt at every step.  The reference's own decode fails
  this: its prefill keeps a ring of only ``S`` rows when ``S <
  attn_window`` (``src/repro/models/griffin.py:348``, ``:369``; witnessed
  here by the shape of its cache) and its decode wraps the ring at ``S``
  (``:441``), so from the first step it attends over the last ``S``
  positions instead of the window (its logits 0.36-1.22 of the largest
  from its own prefill's, ``ROADMAP.md``);
* the train CLI (at fmt none: the quantized path is held above) trains a
  step with k = 7 of 8 and the serve CLI generates, ``--engine
  continuous`` falling back to oneshot with the same tokens.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

import repro.quant.backend as jbackend  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro_torch.config import QuantConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import griffin  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.serve import build_oneshot_fns  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "recurrentgemma-9b"
QFMT = "identity_for_tests"
B, S = 2, 16


def jax_config(**kw):
    # remat recomputes the same numbers; off, the reference compiles faster
    return dataclasses.replace(jax_smoke_config(ARCH), remat=False, **kw)


def port_config(**kw):
    return dataclasses.replace(get_smoke_config(ARCH), **kw)


def numpy_params(cfg, seed):
    """Params of the JAX model's shapes from numpy: N(0, 0.1^2) for the
    embedding, norms, biases and ``lam``, the matrices N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jgriffin.init_params(k, cfg),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        scale = 0.1
        if len(s.shape) >= 3:
            name = jax.tree_util.keystr(path)
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
# params and the scan
# --------------------------------------------------------------------------- #
def test_params_convert_both_ways_and_match_the_port_init():
    jcfg = jax_config()
    params = numpy_params(jcfg, 1)
    flat = _port(params)
    assert "tail.w_x" in flat and "superblocks.attn.wq" in flat
    back = params_to_numpy(flat)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))
    init = griffin.init_params(0, port_config(), torch.device("cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in flat.items()}


@pytest.mark.parametrize("seq", [13, 16])
def test_rglru_scan_matches_a_sequential_loop(seq):
    rng = np.random.default_rng(seq)
    log_a = -np.abs(rng.standard_normal((2, seq, 5))).astype(np.float32)
    inp = rng.standard_normal((2, seq, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32)
    for start in (None, h0):
        h = np.zeros((2, 5)) if start is None else start.astype(np.float64)
        want = []
        for t in range(seq):
            h = np.exp(log_a[:, t]) * h + inp[:, t]
            want.append(h)
        got = griffin.rglru_scan(
            torch.from_numpy(log_a), torch.from_numpy(inp),
            None if start is None else torch.from_numpy(start))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **TOL)


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_reference():
    """The reference's training forward (final-norm hidden states) and
    per-example losses and gradients of a (B, S) batch,
    ``jax.vmap(jax.value_and_grad)``, compiled once at the identity
    format with params, tokens and flags its arguments: at flags 0 its
    quantizers' ``lax.cond`` takes the identity branch, so it computes
    fmt none's numbers; at flags 1 the quantized path's."""
    jcfg = jax_config()
    quant = JQuantConfig(fmt=QFMT)

    @jax.jit
    def fn(p, tok, flags):
        def one(pp, t):
            return jgriffin.lm_loss(pp, {"tokens": t[None]}, None, flags,
                                    jcfg, quant)
        h = jgriffin.forward_hidden(p, tok, flags, jcfg, quant)
        return h, jax.vmap(jax.value_and_grad(one), in_axes=(None, 0))(
            p, tok)

    def reference(params, tokens, flags):
        return fn(params, jnp.asarray(tokens),
                  jnp.full((jcfg.n_layers,), flags, jnp.float32))
    return reference


@pytest.fixture(scope="module")
def reference_grads(identity_format):
    """Params and tokens of ``B`` sequences, and the reference of
    :func:`_jax_reference` on them at flags 0 or 1."""
    jcfg = jax_config()
    params = numpy_params(jcfg, 7)
    tokens = tokens_of(jcfg)
    return params, tokens, lambda flags: _jax_reference()(params, tokens,
                                                          flags)


def _port_per_example(model, params, tokens, flags):
    def one(p, t):
        return model.loss_fn(p, {"tokens": t[None]}, flags)
    return vmap(grad(one), in_dims=(None, 0), randomness="same")(
        params, torch.from_numpy(tokens))


def test_forward_loss_and_per_example_gradients_match_jax(reference_grads):
    params, tokens, reference = reference_grads
    jh, (jlosses, jgrads) = reference(0.0)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt="none", backend="ref"),
                        device="cpu")
    tparams = _port(params)
    ttok = torch.from_numpy(tokens)
    flags = (False,) * cfg.n_layers
    with torch.no_grad():
        h = griffin.forward_hidden(tparams, ttok, flags, cfg, model.quant)
        loss = model.loss_fn(tparams, {"tokens": ttok}, flags)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jlosses).mean(),
                               **TOL)
    grads = _port_per_example(model, tparams, tokens, flags)
    want = _flat(jgrads)
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w, err_msg=name,
                                   **TOL)


def _expected_seeds(cfg, layers):
    """The quantizer seeds of the layers ``layers`` (policy indices)."""
    period, n_super, n_tail = griffin._layout(cfg)
    out = set()
    for i in layers:
        if i < period * n_super:
            s, j = divmod(i, period)
            base = 397 * s + (0, 11, 23)[j]
            mixer = range(4) if j == 2 else range(5)
        else:
            base = 1_000_003 + 397 * (i - period * n_super)
            mixer = range(5)
        out |= {base + k for k in mixer} | {base + k for k in (5, 6, 7)}
    return out


def test_quantized_path_matches_jax_and_routes_seeds_and_flags(
        reference_grads, monkeypatch):
    """Every layer on at the identity format: the quantized autograd path
    against the reference's; then which seeds quantize under one layer's
    flag, and luq_fp4 against fmt none (statistical)."""
    params, tokens, reference = reference_grads
    _, (jlosses, jgrads) = reference(1.0)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt=QFMT, backend="ref"),
                        device="cpu")
    tparams = _port(params)
    seen = []
    orig = fq._quantize_rows

    def spy(rows, fmt, backend, seed, fold, flag=None):
        seen.append(seed)
        return orig(rows, fmt, backend, seed, fold, flag)

    monkeypatch.setattr(fq, "_quantize_rows", spy)
    on = torch.ones((cfg.n_layers,))
    grads = _port_per_example(model, tparams, tokens, on)
    want = _flat(jgrads)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w, err_msg=name,
                                   **TOL)
    # six quantize points a projection: forward, dgrad and wgrad
    assert set(seen) == _expected_seeds(cfg, range(cfg.n_layers))
    ttok = torch.from_numpy(tokens)
    for layer in (1, 2, cfg.n_layers - 1):
        seen.clear()
        flags = tuple(i == layer for i in range(cfg.n_layers))
        with torch.no_grad():
            loss = model.loss_fn(tparams, {"tokens": ttok}, flags)
        assert set(seen) == _expected_seeds(cfg, [layer]), layer
    with torch.no_grad():
        loss = model.loss_fn(tparams, {"tokens": ttok}, on)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jlosses).mean(),
                               **TOL)

    # luq_fp4 with the port's draws against fmt none
    ref_model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    luq = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="ref"),
                      device="cpu")
    with torch.no_grad():
        l0 = ref_model.loss_fn(tparams, {"tokens": ttok}, on)
        l1 = luq.loss_fn(tparams, {"tokens": ttok}, on)
    assert abs(float(l1) - float(l0)) < 0.05 * float(l0)
    g0 = _port_per_example(ref_model, tparams, tokens, on)
    g1 = _port_per_example(luq, tparams, tokens, on)
    flat0 = torch.cat([g.reshape(B, -1) for g in g0.values()], 1)
    flat1 = torch.cat([g1[k].reshape(B, -1) for k in g0], 1)
    assert torch.isfinite(flat1).all()
    cos = torch.nn.functional.cosine_similarity(flat0, flat1, dim=1)
    ratio = flat1.norm(dim=1) / flat0.norm(dim=1)
    assert (cos > 0).all() and (ratio > 0.5).all() and (ratio < 2).all(), (
        cos, ratio)


def _spy_qproj(monkeypatch, module, seen: dict):
    """Record the operand dtypes of every quantized projection of
    ``module`` (``common``) by einsum spec."""
    orig = module.qproj

    def spy(spec, x, w, **kw):
        seen.setdefault(spec, set()).add((str(x.dtype).split(".")[-1],
                                          str(w.dtype).split(".")[-1]))
        return orig(spec, x, w, **kw)

    monkeypatch.setattr(module, "qproj", spy)


def test_bf16_compute_matches_jax_in_dtypes(monkeypatch):
    jcfg = jax_config(compute_dtype="bfloat16")
    cfg = port_config(compute_dtype="bfloat16")
    params = numpy_params(jcfg, 5)
    tokens = tokens_of(jcfg, seed=6)
    jseen, tseen = {}, {}
    _spy_qproj(monkeypatch, jcm, jseen)
    _spy_qproj(monkeypatch, cm, tseen)
    jflags = jnp.ones((jcfg.n_layers,), jnp.float32)
    jax.eval_shape(lambda p: jgriffin.lm_loss(
        p, {"tokens": jnp.asarray(tokens)}, None, jflags, jcfg,
        JQuantConfig(fmt="bf16")), params)          # traced: the dtypes
    model = build_model(cfg, QuantConfig(fmt="bf16", backend="ref"),
                        device="cpu")
    with torch.no_grad():
        loss = model.loss_fn(_port(params),
                             {"tokens": torch.from_numpy(tokens)},
                             torch.ones((cfg.n_layers,)))
    bf, f32 = "bfloat16", "float32"
    assert tseen == jseen == {
        "bsd,dw->bsw": {(bf, bf)}, "bsw,wu->bsu": {(f32, bf)},
        "bsw,wd->bsd": {(bf, bf)}, "bsd,dhk->bshk": {(bf, bf)},
        "bshk,hkd->bsd": {(bf, bf)}, "bsd,df->bsf": {(bf, bf)},
        "bsf,fd->bsd": {(bf, bf)}}
    assert np.isfinite(float(loss))


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def _serving(seed, prompt):
    jcfg = jax_config()
    params = numpy_params(jcfg, seed)
    tokens = tokens_of(jcfg, s=prompt, seed=seed)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    return jcfg, params, tokens, model, model.prepare(_port(params))


def _jax_decode(jcfg, jquant):
    """The reference's decode step, compiled once for the test's shapes."""
    return jax.jit(lambda p, c, t: jgriffin.decode_step(p, c, t, jcfg,
                                                        jquant))


def test_prefill_and_decode_match_jax_when_the_prompt_fills_the_window():
    jcfg, params, tokens, model, tp = _serving(9, 12)
    jquant = JQuantConfig(fmt="none")
    cache_len = 16
    prefill, decode = build_oneshot_fns(model, cache_len)
    jdecode = _jax_decode(jcfg, jquant)
    jlog, jcache = jgriffin.prefill(params, {"tokens": jnp.asarray(tokens)},
                                    jcfg, jquant, cache_len=cache_len)
    tlog, tcache = prefill(tp, {"tokens": torch.from_numpy(tokens)})
    spec = griffin.cache_spec(model.config, B, cache_len)
    assert spec["attn"]["k"][0][3] == jcfg.attn_window
    for step in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   err_msg=f"logits {step}", **TOL)
        for group, names in spec.items():
            if group == "pos":
                continue
            for name, (shape, dtype) in names.items():
                t = tcache[group][name]
                assert (tuple(t.shape), t.dtype) == (shape, dtype)
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(jcache[group][name]), **TOL,
                    err_msg=f"{group}.{name} {step}")
        assert tcache["pos"] == int(jcache["pos"]) == 12 + step
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        jlog, jcache = jdecode(params, jcache, jnp.asarray(tok))
        tlog, tcache = decode(tp, tcache, torch.from_numpy(tok))


def test_decode_matches_a_prefill_of_the_extended_prompt_below_the_window(
        identity_format):
    """The reference's ring-cache fault (see the module docstring): a
    4-token prompt, a cache of 16 positions, 12 decode steps, 8 of them
    past the window of 8.  The reference's prefill of each extended
    prompt is its last row of the reference's training forward over the
    whole sequence (the forward is causal; prefill's final norm and
    float32 head are the same)."""
    jcfg, params, tokens, model, tp = _serving(10, 4)
    cache_len = S
    prefill, decode = build_oneshot_fns(model, cache_len)
    logits, cache = prefill(tp, {"tokens": torch.from_numpy(tokens)})
    assert cache["attn"]["k"].shape[3] == jcfg.attn_window
    seq, got = tokens, []
    for _ in range(cache_len - tokens.shape[1]):
        tok = logits.argmax(-1).to(torch.int32)
        seq = np.concatenate([seq, tok.numpy()[:, None]], axis=1)
        logits, cache = decode(tp, cache, tok)
        got.append(logits.numpy())
    assert cache["pos"] == cache_len
    h, _ = _jax_reference()(params, seq, 0.0)
    want = np.einsum("bsd,vd->bsv", np.asarray(h),
                     np.asarray(params["embed"]))
    for step, g in enumerate(got):
        np.testing.assert_allclose(g, want[:, tokens.shape[1] + step],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
    # the reference's prefill keeps a ring of the prompt's 4 rows, not
    # the window's 8: its decode then wraps at 4
    ring = jax.eval_shape(
        lambda p, t: jgriffin.prefill(p, {"tokens": t}, jcfg,
                                      JQuantConfig(fmt="none"),
                                      cache_len=cache_len)[1]["attn"]["k"],
        params, jnp.asarray(tokens))
    assert ring.shape[3] == tokens.shape[1] < jcfg.attn_window


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #
def test_cli_trains_and_serves_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "2", "--microbatch", "2", "--seq-len", "10",
                    "--epochs", "1", "--steps-per-epoch", "1",
                    "--clip-backend", "fused", "--dataset-size", "4096",
                    "--fmt", "none"])
    out = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in out if ln.startswith("epoch ")]
    assert len(epochs) == 1
    assert "k=7 " in epochs[0] and "acc=None" in epochs[0]   # 0.9 x 8
    assert np.isfinite(float(epochs[0].split("loss=")[1].split()[0]))
    serve = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "10", "--gen", "4"]
    serve_cli.main(serve + ["--engine", "oneshot"])
    oneshot = capsys.readouterr().out
    serve_cli.main(serve)                          # continuous: falls back
    fallback = capsys.readouterr().out
    assert "falling back to --engine oneshot" in fallback
    assert fallback.split("generated token ids:")[1] == \
        oneshot.split("generated token ids:")[1]
