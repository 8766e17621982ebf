"""PyTorch port vs JAX package: the VLM backbone (``repro_torch.models.vlm``,
internvl2-1b's family): the dense transformer with a vision prefix.

On the same numpy params, tokens and vision embeddings (made from a seed
with numpy) at the smoke config (2 layers, d_model 48, 3 heads padded to
4 over one KV head, vocab 211 padded to 224, 4 vision tokens; sequences
of 12), fmt ``none``, float32:

* the loss with ``vision_embeds`` replacing the first 4 positions and the
  first 4 predictions masked, and its gradients, within 1e-5 of the
  reference's; the masked prefix takes no part (the token ids under it
  change nothing, bit for bit), and without the mask the loss differs;
* the VLM's token embeddings are not scaled by ``sqrt(d_model)`` and a
  ``dense_lm`` of the same shapes' are: both losses within 1e-5 of the
  reference's for their family;
* the padded vocabulary is masked in the loss: padded embedding rows of
  any size change nothing, bit for bit;
* prefill with ``vision_embeds`` (logits and KV cache) and three decode
  steps within 1e-5 of the reference's, decode within 1e-4 of a prefill
  of the extended prompt (the same vision prefix);
* the train CLI trains a step with k = 2 of 2 at fmt none (no vision
  embeddings in a training batch, as in the reference's CLI) and the
  serve CLI generates
  from a Gaussian vision prefix with a luq_fp4 logits head, ``--engine
  continuous`` falling back to oneshot with the same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro_torch.config import QuantConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import build_oneshot_fns  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "internvl2-1b"
B, S = 2, 12


def jax_config(**kw):
    # remat recomputes the same numbers; off, the reference compiles faster
    return dataclasses.replace(jax_smoke_config(ARCH), remat=False, **kw)


def inputs(cfg, seed):
    """numpy params N(0, 0.1^2) of the reference's shapes (the norm scales
    included), tokens and vision embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vision = rng.standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return params, tokens, vision


def _port(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _batch(tokens, vision):
    return {"tokens": torch.from_numpy(tokens),
            "vision_embeds": torch.from_numpy(vision)}


def _jbatch(tokens, vision):
    return {"tokens": jnp.asarray(tokens),
            "vision_embeds": jnp.asarray(vision)}


def test_masked_loss_with_vision_embeds_matches_jax():
    jcfg = jax_config()
    params, tokens, vision = inputs(jcfg, 1)
    jmodel = jax_build_model(jcfg, JQuantConfig(fmt="none"))
    jflags = jnp.zeros((jcfg.n_layers,), jnp.float32)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, _jbatch(tokens, vision), None, jflags)))(
            params)
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _port(params).items()}
    flags = (False,) * cfg.n_layers
    loss = model.loss_fn(leaves, _batch(tokens, vision), flags)
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               **TOL)
    want = {k: v.numpy() for k, v in _port(jgrad).items()}
    assert set(want) == set(leaves)
    for name, w in want.items():
        np.testing.assert_allclose(leaves[name].grad.numpy(), w,
                                   err_msg=name, **TOL)
    # the token ids under the vision prefix are neither inputs nor
    # targets of an unmasked prediction
    nv = cfg.n_vision_tokens
    other = tokens.copy()
    other[:, :nv] = (other[:, :nv] + 1) % cfg.vocab_size
    tparams = _port(params)
    with torch.no_grad():
        same = model.loss_fn(tparams, _batch(other, vision), flags)
        unmasked = tfm.lm_loss(tparams, _batch(tokens, vision), flags, cfg,
                               model.quant)
    assert torch.equal(same, loss.detach())
    assert abs(float(unmasked) - float(loss.detach())) > 1e-3


@pytest.mark.parametrize("family", ["vlm", "dense_lm"])
def test_embedding_scale_by_family_and_padded_vocab_masked(family):
    jcfg = jax_config(family=family)
    cfg = dataclasses.replace(get_smoke_config(ARCH), family=family)
    params, tokens, _ = inputs(jcfg, 2)
    jflags = jnp.zeros((jcfg.n_layers,), jnp.float32)
    jloss = jax.jit(lambda p: jtfm.lm_loss(
        p, {"tokens": jnp.asarray(tokens)}, None, jflags, jcfg,
        JQuantConfig(fmt="none")))(params)
    tparams = _port(params)
    ttok = torch.from_numpy(tokens)
    emb = tfm._embed(tparams, ttok, cfg)
    scale = np.sqrt(np.float32(cfg.d_model)) if family == "dense_lm" else 1.0
    assert torch.equal(emb, tparams["embed"][ttok] * scale)
    flags = (False,) * cfg.n_layers
    quant = QuantConfig(fmt="none")
    with torch.no_grad():
        loss = tfm.lm_loss(tparams, {"tokens": ttok}, flags, cfg, quant)
        big = dict(tparams, embed=tparams["embed"].clone())
        big["embed"][cfg.vocab_size:] = 1e4        # the padded rows
        padded = tfm.lm_loss(big, {"tokens": ttok}, flags, cfg, quant)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    assert torch.equal(padded, loss)


def test_prefill_and_decode_with_vision_embeds_match_jax():
    jcfg = jax_config()
    jquant = JQuantConfig(fmt="none")
    params, tokens, vision = inputs(jcfg, 3)
    cache_len = S + 4
    jlog, jcache = jtfm.prefill(params, _jbatch(tokens, vision), jcfg,
                                jquant, cache_len=cache_len)
    jdecode = jax.jit(lambda p, c, t: jtfm.decode_step(p, c, t, jcfg,
                                                       jquant))
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    tp = model.prepare(_port(params))
    prefill, decode = build_oneshot_fns(model, cache_len)
    tlog, tcache = prefill(tp, _batch(tokens, vision))
    seq = tokens
    for step in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   err_msg=f"logits {step}", **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       err_msg=f"{name} {step}", **TOL)
        if step:
            ref, _ = model.prefill(tp, _batch(seq, vision))
            np.testing.assert_allclose(tlog.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"prefill {step}")
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        jlog, jcache = jdecode(params, jcache, jnp.asarray(tok))
        tlog, tcache = decode(tp, tcache, torch.from_numpy(tok))


def test_cli_trains_and_serves_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "2", "--microbatch", "2", "--seq-len", "12",
                    "--epochs", "1", "--steps-per-epoch", "1",
                    "--clip-backend", "fused", "--dataset-size", "4096",
                    "--fmt", "none"])
    out = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in out if ln.startswith("epoch ")]
    assert len(epochs) == 1
    assert "k=2 " in epochs[0] and "acc=None" in epochs[0]
    assert np.isfinite(float(epochs[0].split("loss=")[1].split()[0]))
    serve = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "10", "--gen", "4", "--quant-fmt", "luq_fp4"]
    serve_cli.main(serve + ["--engine", "oneshot"])
    oneshot = capsys.readouterr().out
    serve_cli.main(serve)                          # continuous: falls back
    fallback = capsys.readouterr().out
    assert "falling back to --engine oneshot" in fallback
    assert fallback.split("generated token ids:")[1] == \
        oneshot.split("generated token ids:")[1]
    args = serve_cli.parse_args(serve)
    model, _ = serve_cli.build(args)
    batch = serve_cli.oneshot_batch(args, model)
    cfg = model.config
    assert batch["vision_embeds"].shape == (2, cfg.n_vision_tokens,
                                            cfg.d_model)
    assert batch["vision_embeds"].dtype == torch.float32
