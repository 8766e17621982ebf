"""PyTorch port vs JAX package: the dense-LM training loss
(``repro_torch.models.transformer.lm_loss``) and its gradients, the
chunked LM loss with the ghost logits tap, the token data, and the
training CLI in ghost mode.

On the same numpy params and tokens (made from a seed with numpy), at
fmt ``none`` and float32 compute: the mean loss, the per-example losses
and the gradients of both within 1e-5 (atol and rtol; float32, summed in
another order), for the stablelm-3b smoke config (untied head, SwiGLU)
and the gemma-7b smoke config (tied embeddings, GeGLU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data.synthetic import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro_torch.config import QuantConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.synthetic import TokenDataset  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["stablelm-3b", "gemma-7b"]
B, S = 3, 12


def numpy_params(model, rng):
    """Params of the JAX model's shapes from numpy: N(0, 0.1^2), the norm
    scales included (nonzero, so their gradients are exercised)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: jnp.asarray(0.1 * rng.standard_normal(s.shape), s.dtype),
        shapes)


@pytest.fixture(scope="module")
def jax_ref():
    """Per arch: params, tokens, per-example weights, and JAX's mean loss,
    per-example losses, and the gradients of the mean and of the
    weighted per-example sum."""
    out = {}
    for arch in ARCHS:
        # remat (the JAX default) recomputes the same numbers; off, the
        # reference compiles faster
        cfg = dataclasses.replace(jax_smoke_config(arch), remat=False)
        model = jax_build_model(cfg, JQuantConfig(fmt="none"))
        rng = np.random.default_rng(7)
        params = numpy_params(model, rng)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        weights = rng.random(B).astype(np.float32)
        flags = jnp.zeros((cfg.policy_len(),), jnp.float32)
        batch = {"tokens": jnp.asarray(tokens)}
        key = jax.random.PRNGKey(0)

        def mean(p):
            return model.loss_fn(p, batch, key, flags)

        def weighted(p):
            return jnp.vdot(weights,
                            model.per_example_loss(p, batch, key, flags))

        @jax.jit
        def all_of(p):
            loss, g_mean = jax.value_and_grad(mean)(p)
            return (loss, model.per_example_loss(p, batch, key, flags),
                    g_mean, jax.grad(weighted)(p))

        loss, pel, g_mean, g_pe = all_of(params)
        tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        out[arch] = dict(params=tree(params), tokens=tokens, weights=weights,
                         loss=float(loss), pel=np.asarray(pel),
                         g_mean=tree(g_mean), g_pe=tree(g_pe))
    return out


def _grads(fn, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    value = fn(leaves)
    value.backward()
    return value.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(jax_ref, arch):
    ref = jax_ref[arch]
    cfg = get_smoke_config(arch)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    params = params_from_numpy(ref["params"], device="cpu")
    batch = {"tokens": torch.from_numpy(ref["tokens"])}
    flags = (False,) * cfg.n_layers
    weights = torch.from_numpy(ref["weights"])
    loss, g_mean = _grads(lambda p: model.loss_fn(p, batch, flags), params)
    pel = model.per_example_loss(params, batch, flags)
    _, g_pe = _grads(lambda p: (weights * model.per_example_loss(
        p, batch, flags)).sum(), params)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    np.testing.assert_allclose(pel.numpy(), ref["pel"], **TOL)
    for got, want in ((g_mean, ref["g_mean"]), (g_pe, ref["g_pe"])):
        want = params_from_numpy(want, device="cpu")
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       err_msg=name, **TOL)


@pytest.mark.parametrize("per_example,tapped", [
    (False, False), (True, False), (True, True)])
def test_chunked_lm_loss_matches_jax(per_example, tapped):
    """Four sequence chunks untapped; one chunk with the logits tap,
    whose gradient (the logits cotangent) and hidden rows are compared
    too."""
    rng = np.random.default_rng(11)
    b, s, d, v, vpad = 2, 10, 8, 13, 16
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    embed = rng.standard_normal((vpad, d)).astype(np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    kw = dict(real_vocab=v, ce_chunk=3, per_example=per_example)
    tap = np.zeros((b, s, vpad), np.float32)

    def jfn(tp):
        out = jcm.chunked_lm_loss(jnp.asarray(h), jnp.asarray(targets),
                                  jnp.asarray(embed),
                                  logits_tap=tp if tapped else None, **kw)
        loss, hc = out if tapped else (out, None)
        return loss.sum(), (loss, hc)

    (_, (jloss, jhc)), jdtap = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(jnp.asarray(tap))
    ttap = torch.from_numpy(tap).requires_grad_()
    out = cm.chunked_lm_loss(torch.from_numpy(h), torch.from_numpy(targets),
                             torch.from_numpy(embed),
                             logits_tap=ttap if tapped else None, **kw)
    loss, hc = out if tapped else (out, None)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               **TOL)
    if tapped:
        loss.sum().backward()
        np.testing.assert_allclose(ttap.grad.numpy(), np.asarray(jdtap),
                                   **TOL)
        np.testing.assert_allclose(hc.detach().numpy(), np.asarray(jhc),
                                   **TOL)


def test_token_dataset_matches_jax():
    mine = TokenDataset(n=20, vocab=97, seq_len=9, seed=4)
    theirs = JTokenDataset(n=20, vocab=97, seq_len=9, seed=4)
    idx = np.array([3, 0, 19, 3])
    got = mine.get(idx)["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(theirs.get(idx)["tokens"]))


def test_ghost_cli_on_cpu_and_not_without_a_gpu(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    argv = ["--arch", "stablelm-3b", "--smoke", "--grad-mode", "ghost",
            "--batch", "4", "--ghost-microbatch", "2", "--seq-len", "16",
            "--microbatch", "4", "--epochs", "1", "--steps-per-epoch", "1",
            "--dataset-size", "4096"]
    train_cli.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(epochs) == 1
    assert all("k=2 " in ln and "acc=None" in ln for ln in epochs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)
