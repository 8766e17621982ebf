"""PyTorch port vs JAX package: the encoder-decoder
(``repro_torch.models.encdec``, whisper-medium's family): parameters,
the training loss, its gradients and the DP engine's clipped sum, the
quantizer's seeds and flags, oneshot prefill and decode, and the CLIs.

On the same numpy params, tokens and encoder frames (made from a seed
with numpy) at the smoke config (2 encoder and 2 decoder layers, d_model
48, 4 heads of 12, vocab 131 padded to 144, float32; sequences of 12):

* ``convert`` carries the reference's nested ``enc`` / ``dec`` tree (the
  decoder's ``self_`` and ``cross_`` leaves) to the port's flat names and
  back unchanged, and the port's init has the reference's names, shapes
  and dtypes;
* at fmt ``none`` the loss and its gradients within 1e-5 of the
  reference's ``loss_fn``, and the vmap engine's per-example clipped sum
  (the fused clip's plain version, microbatches of 2) within 1e-5 of
  ``repro.dp``'s on the same batch (one compiled reference program, at
  an identity format with the flags an argument, serves this case and
  the next);
* every layer quantized at the identity format: the loss and gradients
  of the quantized autograd path within 1e-5 of the reference's; the
  seeds are the reference's (encoder block ``97 l``, decoder block ``97
  (l + 1000)``, its cross-attention ``+ 10``; q, k, v, o ``+ 0..3``, the
  MLP ``+ 4, 5``) and, with one encoder and one decoder layer off, only
  the other layers' seeds quantize; at luq_fp4 (the port's own Philox
  draws: a statistical check) the loss within 5 % of fmt none's and every
  per-example gradient finite, within a factor 2 of fmt none's in norm
  and positively correlated with it;
* prefill's logits and every cache leaf (the cross K/V padded to the
  cache's rows) and three decode steps' within 1e-5 of the reference's,
  and decode within 1e-4 of a prefill of the extended prompt (the same
  encoder frames);
* the train CLI trains a step with ``enc_embeds`` in its batch (cast to
  the compute dtype on the device: bf16 in a bf16 config) at fmt none,
  ``--grad-mode ghost`` raises (the family has no ghost hooks), and the
  serve CLI generates, ``--engine continuous`` falling back to oneshot
  with the same tokens.
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
from repro.dp.clip import \
    per_example_clipped_grad_sum as jax_clipped_sum  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.config import QuantConfig, RunConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.data.synthetic import (EncDecDataset,  # noqa: E402
                                        TokenDataset)
from repro_torch.dp.clip import per_example_clipped_grad_sum  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.serve import build_oneshot_fns  # noqa: E402
from repro_torch.train_loop import Trainer  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-medium"
QFMT = "identity_for_tests"
B, S = 4, 12
CLIP = 0.5


def jax_config(**kw):
    # remat recomputes the same numbers; off, the reference compiles faster
    return dataclasses.replace(jax_smoke_config(ARCH), remat=False, **kw)


def port_config(**kw):
    return dataclasses.replace(get_smoke_config(ARCH), **kw)


def inputs(cfg, seed, n=B, s=S):
    """numpy params of the reference's shapes, N(0, 0.1^2) for the
    embedding and norms and N(0, 1/fan_in) for the matrices; tokens and
    encoder frames N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jencdec.init_params(k, cfg),
                            jax.random.PRNGKey(0))

    def leaf(path, sd):
        scale = 0.1
        if len(sd.shape) >= 3:
            wo = jax.tree_util.keystr(path).endswith("wo']")
            scale = 1.0 / np.sqrt(sd.shape[1] * (sd.shape[2] if wo else 1))
        return (scale * rng.standard_normal(sd.shape)).astype(sd.dtype)
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tokens = rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)
    frames = rng.standard_normal((n, s, cfg.d_model)).astype(np.float32)
    return params, tokens, frames


def _port(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _flat(tree):
    return {k: v.float().numpy() for k, v in _port(tree).items()}


def _batch(tokens, frames):
    return {"tokens": torch.from_numpy(tokens),
            "enc_embeds": torch.from_numpy(frames)}


def _jbatch(tokens, frames):
    return {"tokens": jnp.asarray(tokens), "enc_embeds": jnp.asarray(frames)}


def _assert_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


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
# params
# --------------------------------------------------------------------------- #
def test_params_convert_both_ways_and_match_the_port_init():
    jcfg = jax_config()
    params, _, _ = inputs(jcfg, 1)
    flat = _port(params)
    assert {"enc.wq", "dec.self_wq", "dec.cross_wo", "dec.wo_mlp",
            "enc_norm"} <= set(flat)
    back = params_to_numpy(flat)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))
    init = encdec.init_params(0, port_config(), torch.device("cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in flat.items()}
    assert port_config().policy_len() == jcfg.policy_len() == 4


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_reference():
    """The reference's batch loss and its gradient, and ``repro.dp``'s
    per-example clipped sum (microbatches of 2, the plain clip), compiled
    once at the identity format with params, batch and flags its
    arguments: at flags 0 its quantizers' ``lax.cond`` takes the
    unquantized branch, so it computes fmt none's numbers; at flags 1 the
    quantized path's."""
    jcfg = jax_config()
    quant = JQuantConfig(fmt=QFMT)

    @jax.jit
    def fn(p, batch, flags):
        def loss(pp, b):
            return jencdec.loss_fn(pp, b, None, flags, jcfg, quant)

        def one(pp, ex, rng):
            return loss(pp, jax.tree.map(lambda v: v[None], ex))

        value, g = jax.value_and_grad(loss)(p, batch)
        clipped, _ = jax_clipped_sum(one, p, batch, clip_norm=CLIP,
                                     microbatch_size=2,
                                     rng=jax.random.PRNGKey(0))
        return value, g, clipped

    def reference(params, tokens, frames, flags):
        return fn(params, _jbatch(tokens, frames),
                  jnp.asarray(flags, jnp.float32))
    return reference


@pytest.fixture(scope="module")
def reference_grads(identity_format):
    jcfg = jax_config()
    params, tokens, frames = inputs(jcfg, 7)
    return params, tokens, frames, functools.partial(
        _jax_reference(), params, tokens, frames)


def _port_loss_and_grads(model, params, batch, flags):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = model.loss_fn(leaves, batch, flags)
    loss.backward()
    return loss.detach(), {k: v.grad.numpy() for k, v in leaves.items()}


def _clipped_sum(model, params, batch, flags):
    return per_example_clipped_grad_sum(
        lambda p, ex: model.loss_fn(p, {k: v[None] for k, v in ex.items()},
                                    flags),
        params, batch, clip_norm=CLIP, microbatch_size=2,
        clip_backend="fused")[0]


def test_loss_gradients_and_clipped_sum_match_jax(reference_grads):
    params, tokens, frames, reference = reference_grads
    jloss, jgrad, jclipped = reference([0.0] * 4)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt="none", backend="ref"),
                        device="cpu")
    tparams = _port(params)
    batch = _batch(tokens, frames)
    flags = (False,) * cfg.policy_len()
    loss, grads = _port_loss_and_grads(model, tparams, batch, flags)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    _assert_close(grads, _flat(jgrad), **TOL)
    got = {k: v.numpy() for k, v in
           _clipped_sum(model, tparams, batch, flags).items()}
    want = _flat(jclipped)
    top = max(float(np.abs(v).max()) for v in want.values())
    _assert_close(got, want, rtol=1e-5, atol=1e-5 * top)
    # the clip binds: the sum is not the unclipped one
    assert not np.allclose(got["embed"], B * _flat(jgrad)["embed"],
                           rtol=1e-3)


def _expected_seeds(cfg, layers):
    """The quantizer seeds of the policy layers ``layers``."""
    out = set()
    for i in layers:
        if i < cfg.n_enc_layers:
            base = 97 * i
            out |= {base + k for k in range(6)}
        else:
            base = 97 * (i - cfg.n_enc_layers + 1000)
            out |= {base + k for k in range(6)}
            out |= {base + 10 + k for k in range(4)}
    return out


def test_quantized_path_matches_jax_and_routes_seeds_and_flags(
        reference_grads, monkeypatch):
    """Every layer on at the identity format: the quantized autograd path
    against the reference's; then which seeds quantize with one encoder
    and one decoder layer off, and luq_fp4 against fmt none
    (statistical)."""
    params, tokens, frames, reference = reference_grads
    jloss, jgrad, jclipped = reference([1.0] * 4)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt=QFMT, backend="ref"),
                        device="cpu")
    tparams = _port(params)
    batch = _batch(tokens, frames)
    seen = []
    orig = fq._quantize_rows

    def spy(rows, fmt, backend, seed, fold, flag=None):
        seen.append((seed, 1.0 if flag is None else float(flag)))
        return orig(rows, fmt, backend, seed, fold, flag)

    monkeypatch.setattr(fq, "_quantize_rows", spy)
    on = torch.ones((cfg.policy_len(),))
    loss, grads = _port_loss_and_grads(model, tparams, batch, on)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    _assert_close(grads, _flat(jgrad), **TOL)
    # six quantize points a projection (forward, dgrad, wgrad), each
    # seed's once the forward's and once the backward's
    assert {seed for seed, _ in seen} == _expected_seeds(cfg, range(4))
    # encoder layer 1 and decoder layer 0 off, as host bools (an off layer
    # takes the plain einsum) and as the trainer's device flags (an off
    # layer's quantizer reads its 0 and copies the operands through)
    for flags in ((True, False, False, True),
                  torch.tensor([1.0, 0.0, 0.0, 1.0])):
        seen.clear()
        with torch.no_grad():
            model.loss_fn(tparams, batch, flags)
        assert {s for s, f in seen if f == 1.0} == _expected_seeds(cfg,
                                                                   [0, 3])
        assert {s for s, f in seen if f != 1.0} == (
            set() if isinstance(flags, tuple) else _expected_seeds(cfg,
                                                                   [1, 2]))
    monkeypatch.setattr(fq, "_quantize_rows", orig)

    # luq_fp4 with the port's draws against fmt none, two examples
    two = {k: v[:2] for k, v in batch.items()}
    none = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    luq = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="ref"),
                      device="cpu")
    with torch.no_grad():
        l0 = none.loss_fn(tparams, two, on)
        l1 = luq.loss_fn(tparams, two, on)
    assert abs(float(l1) - float(l0)) < 0.05 * float(l0)

    def per_example(m):
        def one(p, tok, emb):
            return m.loss_fn(p, {"tokens": tok[None],
                                 "enc_embeds": emb[None]}, on)
        g = vmap(grad(one), in_dims=(None, 0, 0), randomness="same")(
            tparams, two["tokens"], two["enc_embeds"])
        return torch.cat([g[k].reshape(2, -1) for k in sorted(g)], 1)

    flat0, flat1 = per_example(none), per_example(luq)
    assert torch.isfinite(flat1).all()
    cos = torch.nn.functional.cosine_similarity(flat0, flat1, dim=1)
    ratio = flat1.norm(dim=1) / flat0.norm(dim=1)
    assert (cos > 0).all() and (ratio > 0.5).all() and (ratio < 2).all(), (
        cos, ratio)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_prefill_and_decode_match_jax_and_a_prefill_of_the_extended_prompt():
    jcfg = jax_config()
    jquant = JQuantConfig(fmt="none")
    params, tokens, frames = inputs(jcfg, 9, n=2, s=8)
    cache_len = 12
    jlog, jcache = jencdec.prefill(params, _jbatch(tokens, frames), jcfg,
                                   jquant, cache_len=cache_len)
    jdecode = jax.jit(lambda p, c, t: jencdec.decode_step(p, c, t, jcfg,
                                                          jquant))
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    tp = model.prepare(_port(params))
    prefill, decode = build_oneshot_fns(model, cache_len)
    tlog, tcache = prefill(tp, _batch(tokens, frames))
    spec = encdec.cache_spec(cfg, 2, cache_len)
    assert set(tcache) == set(spec) == set(jcache)
    seq = tokens
    for step in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   err_msg=f"logits {step}", **TOL)
        for name in encdec.CACHE_LEAVES:
            t = tcache[name]
            assert (tuple(t.shape), t.dtype) == spec[name]
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]),
                                       err_msg=f"{name} {step}", **TOL)
        assert tcache["pos"] == int(jcache["pos"]) == 8 + step
        assert tcache["enc_len"] == int(jcache["enc_len"]) == 8
        if step:
            ref, _ = model.prefill(tp, _batch(seq, frames))
            np.testing.assert_allclose(tlog.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"prefill {step}")
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        jlog, jcache = jdecode(params, jcache, jnp.asarray(tok))
        tlog, tcache = decode(tp, tcache, torch.from_numpy(tok))


# --------------------------------------------------------------------------- #
# data and the CLIs
# --------------------------------------------------------------------------- #
def test_dataset_and_trainer_batches_carry_the_encoder_frames():
    """``EncDecDataset``: ``TokenDataset``'s tokens, the same frames for
    the same index whenever drawn; the trainer stages them in the compute
    dtype (bf16 here), the scan executor's static batch too."""
    ds = EncDecDataset(n=64, vocab=131, seq_len=S, seed=3, d_model=48)
    idx = np.array([5, 9, 5])
    got = ds.get(idx)
    assert torch.equal(got["tokens"], TokenDataset(
        n=64, vocab=131, seq_len=S, seed=3).get(idx)["tokens"])
    emb = got["enc_embeds"]
    assert emb.shape == (3, S, 48) and emb.dtype == torch.float32
    assert torch.equal(emb[0], emb[2]) and not torch.equal(emb[0], emb[1])
    assert torch.equal(ds.get(np.array([9]))["enc_embeds"][0], emb[1])
    cfg = port_config(compute_dtype="bfloat16")
    run = RunConfig(model=cfg, quant=QuantConfig(fmt="none"), global_batch=2,
                    seq_len=S, steps_per_epoch=1, steps=1)
    ds = EncDecDataset(n=64, vocab=cfg.vocab_size, seq_len=S, d_model=48)
    tr = Trainer(run, ds, device="cpu")
    batch = tr._to_device(ds.get(np.arange(2)))
    assert batch["enc_embeds"].dtype == torch.bfloat16
    assert batch["tokens"].dtype == torch.int32
    tr._train_steps_scan(tr._set_flags((False,) * 4))
    assert tr.epoch_fn._batch["enc_embeds"].dtype == torch.bfloat16


def test_cli_trains_and_serves_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--microbatch", "2", "--seq-len", "10", "--epochs", "1",
            "--steps-per-epoch", "1", "--dataset-size", "4096"]
    train_cli.main(argv + ["--clip-backend", "fused", "--fmt", "none"])
    out = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in out if ln.startswith("epoch ")]
    assert len(epochs) == 1
    assert "k=4 " in epochs[0] and "acc=None" in epochs[0]   # 0.9 x 4
    assert np.isfinite(float(epochs[0].split("loss=")[1].split()[0]))
    with pytest.raises(ValueError, match="no ghost hooks"):
        train_cli.main(argv + ["--grad-mode", "ghost"])
    serve = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "10", "--gen", "4"]
    serve_cli.main(serve + ["--engine", "oneshot"])
    oneshot = capsys.readouterr().out
    serve_cli.main(serve)                          # continuous: falls back
    fallback = capsys.readouterr().out
    assert "falling back to --engine oneshot" in fallback
    assert fallback.split("generated token ids:")[1] == \
        oneshot.split("generated token ids:")[1]
