"""PyTorch port vs JAX package: BERT-SNLI (``repro_torch.models.bert``),
its data and its training CLI.

On the same numpy params and tokens (made from a seed with numpy) at the
smoke config, float32 compute: the final hidden states, the [CLS]
logits, the loss and one example's gradient within 1e-5 (atol and rtol;
float32 summed in another order) at fmt ``none`` with the flags off, and
at fmt ``bf16`` with every layer's flag on within 1e-2 of each array's
largest entry (2.5 bf16 ulps): a float32 value within an ulp of a bf16
rounding edge rounds either way, and the two packages' float32 values
differ by an ulp where they sum in another order (one operand element of
the first attention output flips, then a few in each later operand; the
largest difference is 2.0e-3 of an array's largest entry, the hidden
states');  ``trainable_last_only`` leaves exactly-zero gradients on the
frozen layers and the reference's on the last.  The non-causal chunked
attention within 1e-6.  One DP step of the vmap engine (DP-AdamW, sigma
0, the fused clip's plain version) against per-example gradients from
``jax.vmap(jax.grad(...))``, clipped and summed (within 1e-5 of the
sum's largest entry), and the JAX package's AdamW (the new params within
1e-6).  ``NLIDataset`` bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data.synthetic import NLIDataset as JNLIDataset  # noqa: E402
from repro.models import bert as jbert  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.config import (DPConfig, OptimConfig, QuantConfig,  # noqa: E402
                                RunConfig)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.dp.clip import per_example_clipped_grad_sum  # noqa: E402
from repro_torch.data.synthetic import NLIDataset  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import build_train_setup  # noqa: E402
from repro_torch.models import bert  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1e-2              # of an array's largest entry, at fmt bf16
ARCH = "bert-snli"
B, S = 3, 20                 # two attention chunks of 16, the second short
CLIP, LR = 1.0, 1e-3


def jax_config():
    # remat recomputes the same numbers; off, the reference compiles faster
    return dataclasses.replace(jax_smoke_config(ARCH), remat=False)


def numpy_params(cfg, seed):
    """Params of the JAX model's shapes from numpy: N(0, 0.1^2), the norm
    scales included (nonzero, so their gradients are exercised)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jbert.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)


def inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.num_classes, B).astype(np.int32)
    return tokens, labels


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


def _grads(leaves: dict) -> dict:
    """The leaves' gradients as numpy; a leaf the loss never reads
    (``wi_up``) has none in PyTorch and zeros in JAX."""
    return {k: (v.grad.numpy() if v.grad is not None
                else np.zeros(v.shape, np.float32))
            for k, v in leaves.items()}


def _assert_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


def test_nli_dataset_matches_jax():
    mine = NLIDataset(n=20, vocab=97, seq_len=24, num_classes=3, seed=4)
    theirs = JNLIDataset(n=20, vocab=97, seq_len=24, num_classes=3, seed=4)
    idx = np.array([3, 0, 19, 3, 7])
    got, want = mine.get(idx), theirs.get(idx)
    for key in ("tokens", "label"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_matches_jax(causal):
    rng = np.random.default_rng(int(causal))
    q, k, v = (rng.standard_normal((2, 21, 3, 8)).astype(np.float32)
               for _ in range(3))
    want = jcm.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk_q=8,
        causal=causal, scale=0.3)
    got = cm.chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        chunk_q=8, causal=causal, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fmt", ["none", "bf16"])
def test_forward_loss_and_gradient_match_jax(fmt):
    """Hidden states, [CLS] logits, the batch loss and the gradient of
    example 0's loss; at bf16 every layer's flag is on."""
    jcfg = jax_config()
    quantized = fmt != "none"
    jquant = JQuantConfig(fmt=fmt)
    params = numpy_params(jcfg, 7)
    tokens, labels = inputs(jcfg)
    jflags = jnp.full((jcfg.n_layers,), float(quantized), jnp.float32)

    @jax.jit
    def reference(p):
        h = jbert.forward(p, jnp.asarray(tokens), jflags, jcfg, jquant)
        logits = h[:, 0].astype(jnp.float32) @ p["cls_w"] + p["cls_b"]
        batch = {"tokens": jnp.asarray(tokens), "label": jnp.asarray(labels)}
        one = {k: v[:1] for k, v in batch.items()}
        loss = jbert.loss_fn(p, batch, None, jflags, jcfg, jquant)
        g = jax.grad(jbert.loss_fn)(p, one, None, jflags, jcfg, jquant)
        return h, logits, loss, g

    jh, jlogits, jloss, jgrad = reference(params)
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, QuantConfig(fmt=fmt, backend="ref"),
                        device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    flags = (quantized,) * cfg.n_layers
    ttok = torch.from_numpy(tokens)
    batch = {"tokens": ttok, "label": torch.from_numpy(labels)}
    with torch.no_grad():
        h = bert.forward(tparams, ttok, flags, cfg, model.quant)
        logits = model.forward(tparams, ttok, flags)
        loss = model.loss_fn(tparams, batch, flags)
    got = {"hidden": h.numpy(), "logits": logits.numpy(),
           "loss": loss.numpy()}
    want = {"hidden": np.asarray(jh), "logits": np.asarray(jlogits),
            "loss": np.asarray(jloss)}
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    model.loss_fn(leaves, {k: v[:1] for k, v in batch.items()},
                  flags).backward()
    assert leaves["blocks.wi_up"].grad is None    # never read
    got.update(_grads(leaves))
    want.update(_flat(jgrad))
    assert set(got) == set(want)
    for name, w in want.items():
        tol = (TOL if fmt == "none"
               else dict(rtol=0, atol=BF16_REL * float(np.abs(w).max())))
        np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


def test_trainable_last_only_freezes_all_but_the_last_layer():
    jcfg = jax_config()
    jquant = JQuantConfig(fmt="none")
    params = numpy_params(jcfg, 8)
    tokens, labels = inputs(jcfg, 4)
    batch = {"tokens": tokens, "label": labels}
    jflags = jnp.zeros((jcfg.n_layers,), jnp.float32)
    jgrad = jax.jit(jax.grad(lambda p: jbert.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, None, jflags,
        jcfg, jquant, trainable_last_only=True)))(params)
    cfg = get_smoke_config(ARCH)
    leaves = {k: v.requires_grad_() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu").items()}
    bert.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()},
                 (False,) * cfg.n_layers, cfg, QuantConfig(fmt="none"),
                 trainable_last_only=True).backward()
    got = _grads(leaves)
    for leaf in bert.BLOCK_LEAVES:
        g = got[f"blocks.{leaf}"]
        assert not g[:-1].any(), leaf              # exactly zero, frozen
    assert got["blocks.wq"][-1].any() and got["embed"].any()
    _assert_close(got, _flat(jgrad), **TOL)


def test_dp_adamw_step_matches_jax_per_example_gradients():
    """One DP-AdamW step at sigma 0 through the port's train step (vmap
    engine, microbatches of 2, the fused clip's plain version).  Its
    clipped sum against ``jax.vmap(jax.grad(...))`` of the reference's
    loss, clipped per example at C and summed: within 1e-5 of the sum's
    largest entry.  Its new params against the JAX package's AdamW fed
    that clipped sum over the batch: within 1e-6.  (AdamW's first step
    divides each gradient by its own magnitude plus 1e-8, so a gradient
    near 0 turns a float32 difference of the sums into an update
    difference up to 1e5 times larger: the update is held on the port's
    sum.)"""
    jcfg = jax_config()
    jquant = JQuantConfig(fmt="none")
    params = numpy_params(jcfg, 9)
    n = 4
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jcfg.vocab_size, (n, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.num_classes, n).astype(np.int32)
    jflags = jnp.zeros((jcfg.n_layers,), jnp.float32)
    jopt = jax_make_optimizer(JOptimConfig(name="adamw", lr=LR))

    @jax.jit
    def reference(p, tok, lab):
        def one(pp, t, y):
            return jbert.loss_fn(pp, {"tokens": t[None], "label": y[None]},
                                 None, jflags, jcfg, jquant)

        losses = jax.vmap(one, in_axes=(None, 0, 0))(p, tok, lab)
        grads = jax.vmap(jax.grad(one), in_axes=(None, 0, 0))(p, tok, lab)
        sq = sum(jnp.sum(jnp.square(g.reshape(n, -1)), axis=1)
                 for g in jax.tree.leaves(grads))
        scale = jnp.minimum(1.0, CLIP / jnp.maximum(jnp.sqrt(sq), 1e-12))
        return losses.mean(), jax.tree.map(
            lambda g: jnp.einsum("b...,b->...", g, scale), grads)

    @jax.jit
    def adamw_step(p, summed):
        upd, _ = jopt.update(jax.tree.map(lambda g: g / n, summed),
                             jopt.init(p), p, LR)
        return jax.tree.map(lambda a, u: a + u, p, upd)

    jloss, jsum = reference(params, jnp.asarray(tokens), jnp.asarray(labels))
    cfg = get_smoke_config(ARCH)
    run = RunConfig(model=cfg, quant=QuantConfig(fmt="none", backend="ref"),
                    dp=DPConfig(clip_norm=CLIP, noise_multiplier=0.0,
                                microbatch_size=2, clip_backend="fused"),
                    optim=OptimConfig(name="adamw", lr=LR), global_batch=n)
    model = build_model(cfg, run.quant, device="cpu")
    setup = build_train_setup(model, run)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "label": torch.from_numpy(labels)}
    flags = torch.zeros((cfg.n_layers,))
    new, _, metrics = setup.step_fn(tparams, setup.opt_init_fn(tparams),
                                    batch, 0, flags, LR)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), **TOL)
    # the step's clipped sum: with sigma 0 it is what the engine gives
    tsum, _ = per_example_clipped_grad_sum(
        lambda p, ex: model.loss_fn(p, {k: v[None] for k, v in ex.items()},
                                    flags),
        tparams, batch, clip_norm=CLIP, microbatch_size=2,
        clip_backend="fused")
    want_sum = _flat(jsum)
    top = max(float(np.abs(v).max()) for v in want_sum.values())
    _assert_close({k: v.numpy() for k, v in tsum.items()}, want_sum,
                  rtol=1e-5, atol=1e-5 * top)
    jnew = adamw_step(params, jax.tree.map(jnp.asarray,
                                           params_to_numpy(tsum)))
    _assert_close({k: v.numpy() for k, v in new.items()}, _flat(jnew),
                  rtol=1e-6, atol=1e-6)


def test_cli_trains_on_cpu_and_serving_refuses_an_encoder(capsys,
                                                          monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    argv = ["--arch", ARCH, "--smoke", "--optimizer", "adamw", "--lr",
            "1e-3", "--batch", "8", "--microbatch", "4", "--seq-len", "32",
            "--epochs", "1", "--steps-per-epoch", "2", "--clip-backend",
            "fused", "--dataset-size", "4096"]
    train_cli.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(epochs) == 1 and "k=2 " in epochs[0]
    acc = float(epochs[0].rsplit("acc=", 1)[1])
    assert 0.0 <= acc <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)
    with pytest.raises(SystemExit, match="no decoder"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
