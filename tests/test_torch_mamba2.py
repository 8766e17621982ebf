"""PyTorch port vs JAX package: Mamba-2 (``repro_torch.models.mamba2``):
the SSD layer, the training loss and gradients, oneshot prefill and
decode, the activation x activation quantized einsums of the SSD, one DP
step, and the CLIs.

On the same numpy params and tokens (made from a seed with numpy) at the
smoke config (2 layers, d_model 64, 4 SSD heads of 32, state 16, chunk
16; sequences of 24 tokens, so the SSD pads its last chunk):

* ``ssd_chunked`` within 1e-5 (atol and rtol) of the reference's and
  within 2e-4 of the naive recurrence (the reference's own test);
* the loss and its gradients within 1e-5 at fmt ``none``, float32
  compute; at fmt ``bf16`` with every layer's flag on within 1e-2 of
  each array's largest entry (2.5 bf16 ulps: a float32 value within an
  ulp of a rounding edge rounds either way, and the packages' float32
  values differ by an ulp where they sum in another order);
* at ``compute_dtype="bfloat16"`` (float32 params, as mamba2-130m): the
  dtypes where the reference mixes bf16 and float32 (the conv's bf16
  input times its float32 weight is float32; so both SSD contractions
  quantize float32 operands, the projections bf16 ones; decode's bf16
  conv plus the float32 bias is float32; the caches' dtypes), and the
  loss, prefill and decode within 2e-2 of each array's largest entry
  (bf16 values, rounded where the other package's sums and fusions
  round), the gradients within 5e-2 (the reference's own gradients
  jitted and eager, op by op, differ by up to 1.6e-2 of an array's
  largest entry at these inputs, the port's from the jitted ones by up
  to 4.0e-2, ``dt_bias``);
* prefill's logits and cache and three decode steps' within 1e-5 of the
  reference's, and decode's logits within 1e-4 of a prefill of the
  extended prompt (the O(1) recurrence against the chunked scan);
* the SSD's two quantized einsums under ``vmap`` at luq_fp4, an
  activation in the weight slot: the six quantized operands of each
  bitwise the reference's LUQ (``luq_quant_ref``) of the same operand
  given the port's uniforms (one row per example, one shared draw), the
  outputs and gradients within 1e-5 of the reference's ``qeinsum`` given
  the same uniforms;
* per-example LUQ gradients under ``vmap`` are finite (``_segsum``'s
  -inf has an exact-zero gradient);
* one DP-SGD step at sigma 0 through the vmap engine (the fused clip's
  plain version) against ``jax.vmap(jax.grad(...))``: the loss within
  1e-5, the new params within 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

import repro.quant.fake_quant as jfq  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.ref import luq_quant_ref as jax_luq_ref  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.config import (DPConfig, OptimConfig, QuantConfig,  # noqa: E402
                                RunConfig)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import build_train_setup  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.quant import philox  # noqa: E402
from repro_torch.serve import build_oneshot_fns  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1e-2              # fmt bf16, float32 compute
BF16_COMPUTE_REL = 2e-2      # bfloat16 compute: values
BF16_COMPUTE_GRAD_REL = 5e-2  # bfloat16 compute: gradients
ARCH = "mamba2-130m"
B, S = 2, 24
LR = 0.5


def jax_config(**kw):
    # remat recomputes the same numbers; off, the reference compiles faster
    return dataclasses.replace(jax_smoke_config(ARCH), remat=False, **kw)


def port_config(**kw):
    return dataclasses.replace(get_smoke_config(ARCH), **kw)


def numpy_params(cfg, seed):
    """Params of the JAX model's shapes from numpy: N(0, 0.1^2), except
    the decay rates, log(1..16) plus N(0, 0.1^2) as the init spreads
    them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jmamba.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)
    a = params["blocks"]["A_log"]
    params["blocks"]["A_log"] = (a + np.log(np.linspace(
        1.0, 16.0, a.shape[1]))[None]).astype(np.float32)
    return params


def tokens_of(cfg, n=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)


def _port(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _flat(tree):
    return {k: v.float().numpy() for k, v in _port(tree).items()}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_rel(got, want, rel, name=""):
    """Within ``rel`` of ``want``'s largest entry."""
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=rel * float(np.abs(want).max()))


def _grads(leaves: dict) -> dict:
    return {k: v.grad.float().numpy() for k, v in leaves.items()}


# --------------------------------------------------------------------------- #
# the SSD layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [16, 13])
def test_ssd_chunked_matches_jax_and_the_recurrence(seq):
    rng = np.random.default_rng(seq)
    b, H, P, N = 2, 3, 5, 7
    x = rng.standard_normal((b, seq, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seq, H)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((b, seq, N)).astype(np.float32)
    Cm = rng.standard_normal((b, seq, N)).astype(np.float32)
    want = np.asarray(jmamba.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=4, flag=jnp.float32(0),
        seed=jnp.uint32(0), quant=JQuantConfig(fmt="none")))
    got = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                             chunk=4, flag=False, seed=0,
                             quant=QuantConfig(fmt="none")).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    h = np.zeros((b, H, P, N))
    ys = []
    for t in range(seq):
        a = np.exp(dt[:, t] * A[None, :])
        h = h * a[:, :, None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    np.testing.assert_allclose(got, np.stack(ys, 1), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------- #
# training loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", ["none", "bf16"])
def test_loss_and_gradients_match_jax(fmt):
    jcfg = jax_config()
    quantized = fmt != "none"
    params = numpy_params(jcfg, 7)
    tokens = tokens_of(jcfg)
    jflags = jnp.full((jcfg.n_layers,), float(quantized), jnp.float32)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jmamba.lm_loss(p, {"tokens": jnp.asarray(tokens)}, None,
                                 jflags, jcfg, JQuantConfig(fmt=fmt))))(params)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt=fmt, backend="ref"),
                        device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _port(params).items()}
    loss = model.loss_fn(leaves, {"tokens": torch.from_numpy(tokens)},
                         (quantized,) * cfg.n_layers)
    loss.backward()
    got = {"loss": loss.detach().numpy(), **_grads(leaves)}
    want = {"loss": np.asarray(jloss), **_flat(jgrad)}
    assert set(got) == set(want)
    for name, w in want.items():
        if quantized:
            _close_rel(got[name], w, BF16_REL, name)
        else:
            np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)


def _spy_qproj(monkeypatch, module, seen: dict):
    """Record the operand dtypes of every quantized projection of
    ``module`` (``common``) by einsum spec."""
    orig = module.qproj

    def spy(spec, x, w, **kw):
        seen.setdefault(spec, set()).add((str(x.dtype).split(".")[-1],
                                          str(w.dtype).split(".")[-1]))
        return orig(spec, x, w, **kw)

    monkeypatch.setattr(module, "qproj", spy)


def test_bf16_compute_matches_jax_in_dtypes_and_values(monkeypatch):
    jcfg = jax_config(compute_dtype="bfloat16")
    cfg = port_config(compute_dtype="bfloat16")
    jquant, quant = JQuantConfig(fmt="none"), QuantConfig(fmt="none")
    params = numpy_params(jcfg, 8)
    tokens = tokens_of(jcfg, seed=5)
    jflags = jnp.zeros((jcfg.n_layers,), jnp.float32)
    jseen, tseen = {}, {}
    _spy_qproj(monkeypatch, jcm, jseen)
    _spy_qproj(monkeypatch, cm, tseen)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jmamba.lm_loss(p, {"tokens": jnp.asarray(tokens)}, None,
                                 jflags, jcfg, jquant)))(params)
    leaves = {k: v.requires_grad_() for k, v in _port(params).items()}
    loss = mamba2.lm_loss(leaves, {"tokens": torch.from_numpy(tokens)},
                          (False,) * cfg.n_layers, cfg, quant)
    loss.backward()
    # the projections quantize bf16 operands, both SSD contractions
    # float32 ones (the conv's float32 weight promotes its bf16 input)
    assert tseen == jseen == {
        "bsd,de->bse": {("bfloat16", "bfloat16")},
        "bcln,bcsn->bcls": {("float32", "float32")},
        "bchls,bcshp->bclhp": {("float32", "float32")},
        "bse,ed->bsd": {("bfloat16", "bfloat16")}}
    _close_rel(loss.detach().numpy(), np.asarray(jloss), BF16_COMPUTE_REL,
               "loss")
    got, want = _grads(leaves), _flat(jgrad)
    assert set(got) == set(want)
    for name, w in want.items():
        _close_rel(got[name], w, BF16_COMPUTE_GRAD_REL, name)

    # the conv: bf16 input times the float32 weight is float32, the state
    # keeps the input's dtype
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((2, 6, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    jy, jst = jmamba._causal_conv(jnp.asarray(xs, jnp.bfloat16),
                                  jnp.asarray(w), jnp.asarray(b))
    ty, tst = mamba2._causal_conv(torch.from_numpy(xs).bfloat16(),
                                  torch.from_numpy(w), torch.from_numpy(b))
    assert (ty.dtype, tst.dtype) == (torch.float32, torch.bfloat16)
    assert (str(jy.dtype), str(jst.dtype)) == ("float32", "bfloat16")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tst.float().numpy(), _f32(jst))

    # prefill and decode at bf16 compute: dtypes and values
    jp = jmamba.prefill(params, {"tokens": jnp.asarray(tokens)}, jcfg, jquant)
    model = build_model(cfg, quant, device="cpu")
    tp = model.prepare(_port(params))
    tlogits, tcache = model.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    jlog, jcache = jp
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    jlog2, jcache2 = jmamba.decode_step(params, jcache, jnp.asarray(tok),
                                        jcfg, jquant)
    tlog2, tcache2 = model.decode_step(tp, tcache, torch.from_numpy(tok))
    for jl, tl, jc, tc in ((jlog, tlogits, jcache, tcache),
                           (jlog2, tlog2, jcache2, tcache2)):
        assert tl.dtype == torch.float32 and str(jl.dtype) == "float32"
        assert (tc["conv"].dtype, tc["ssm"].dtype) == (torch.bfloat16,
                                                       torch.float32)
        assert (str(jc["conv"].dtype), str(jc["ssm"].dtype)) == (
            "bfloat16", "float32")
        _close_rel(tl.numpy(), np.asarray(jl), BF16_COMPUTE_REL, "logits")
        for name in ("ssm", "conv"):
            _close_rel(tc[name].float().numpy(), _f32(jc[name]),
                       BF16_COMPUTE_REL, name)
    assert tcache2["pos"] == int(jcache2["pos"]) == S + 1


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_prefill_and_decode_match_jax_and_decode_matches_prefill():
    jcfg = jax_config()
    jquant = JQuantConfig(fmt="none")
    params = numpy_params(jcfg, 9)
    tokens = tokens_of(jcfg, s=20, seed=6)
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    tp = model.prepare(_port(params))
    prefill, decode = build_oneshot_fns(model, 64)
    jlog, jcache = jmamba.prefill(params, {"tokens": jnp.asarray(tokens)},
                                  jcfg, jquant)
    tlog, tcache = prefill(tp, {"tokens": torch.from_numpy(tokens)})
    spec = mamba2.cache_spec(cfg, tokens.shape[0], 64)
    assert set(spec) == set(tcache)
    for name in ("ssm", "conv"):
        assert (tuple(tcache[name].shape), tcache[name].dtype) == spec[name]
    assert isinstance(tcache["pos"], int)            # host-side
    seq = tokens
    for step in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   err_msg=f"logits {step}", **TOL)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       err_msg=f"{name} {step}", **TOL)
        assert tcache["pos"] == int(jcache["pos"]) == seq.shape[1]
        if step:
            # decode against a prefill of the extended prompt
            ref, _ = prefill(tp, {"tokens": torch.from_numpy(seq)})
            np.testing.assert_allclose(tlog.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"prefill {step}")
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        jlog, jcache = jmamba.decode_step(params, jcache, jnp.asarray(tok),
                                          jcfg, jquant)
        tlog, tcache = decode(tp, tcache, torch.from_numpy(tok))


# --------------------------------------------------------------------------- #
# the SSD's activation x activation quantized einsums
# --------------------------------------------------------------------------- #
SSD_SPECS = {
    # CB = C B^T and y_diag = gate @ (x dt), per example (b = 1 a lane)
    "bcln,bcsn->bcls": ((1, 2, 8, 5), (1, 2, 8, 5)),
    "bchls,bcshp->bclhp": ((1, 2, 3, 8, 8), (1, 2, 8, 3, 4)),
}
QSEED = 97 + 30


@pytest.mark.parametrize("spec", list(SSD_SPECS))
def test_activation_by_activation_qeinsum_bitwise_given_the_uniforms(
        spec, monkeypatch):
    """Under vmap over 3 examples, both operands batched, luq_fp4: the
    port's six quantize points (forward x and w, dgrad w and g, wgrad x
    and g) each quantize one row per example with stream (seed, fold)'s
    one draw.  The reference's ``_maybe_quant`` is given the same draws
    (its per-lane quantizer under ``jax.vmap``)."""
    xs, ws = SSD_SPECS[spec]
    rng = np.random.default_rng(len(spec))
    n = 3
    x = rng.standard_normal((n,) + xs).astype(np.float32)
    w = rng.standard_normal((n,) + ws).astype(np.float32)
    x[1] *= 5.0                       # another scale in another example
    gy = rng.standard_normal(
        (n,) + np.einsum(spec, x[0], w[0]).shape).astype(np.float32)

    def uniforms(fold, size):
        return philox.uniforms(fq.stream_key(QSEED, fold), 0, size).numpy()

    def reference_quant(v, seed, fold, fmt, flag, backend="ref",
                        per_example=False):
        u = jnp.asarray(uniforms(fold, v.size)).reshape(v.shape)
        q = jax_luq_ref(v, u, jnp.max(jnp.abs(v)))
        return jnp.where(flag > 0.5, q, v)

    monkeypatch.setattr(jfq, "_maybe_quant", reference_quant)

    def jone(a, b, g):
        y, vjp = jax.vjp(lambda aa, bb: jfq.qeinsum(
            spec, aa, bb, seed=QSEED, flag=1.0, fmt="luq_fp4",
            backend="ref"), a, b)
        return (y, *vjp(g))

    jy, jdx, jdw = jax.jit(jax.vmap(jone))(*map(jnp.asarray, (x, w, gy)))

    calls = []
    orig = fq._quantize_rows

    def spy(rows, fmt, backend, seed, fold, flag=None):
        out = orig(rows, fmt, backend, seed, fold, flag)
        calls.append((fold, rows.clone(), out))
        return out

    monkeypatch.setattr(fq, "_quantize_rows", spy)

    def loss(a, b, g):
        return (fq.qeinsum(spec, a, b, seed=QSEED, flag=True,
                           fmt="luq_fp4", backend="ref") * g).sum()

    ty = vmap(lambda a, b: fq.qeinsum(spec, a, b, seed=QSEED, flag=True,
                                      fmt="luq_fp4", backend="ref"),
              randomness="same")(torch.from_numpy(x), torch.from_numpy(w))
    tdx, tdw = vmap(grad(loss, argnums=(0, 1)), randomness="same")(
        *map(torch.from_numpy, (x, w, gy)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **TOL)
    folds = sorted(f for f, _, _ in calls)
    assert folds == [0, 0, 1, 1, 2, 3, 4, 5], folds   # forward traced twice
    for fold, rows, out in calls:
        assert rows.shape[0] == n                     # one row per example
        u = jnp.asarray(uniforms(fold, rows.shape[1]))
        want = jax.vmap(lambda r: jax_luq_ref(r, u, jnp.max(jnp.abs(r))))(
            jnp.asarray(rows.numpy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want),
                                      err_msg=f"fold {fold}")


def test_per_example_luq_gradients_are_finite():
    """Every layer quantized at luq_fp4 under the vmap engine: the decay
    kernel's -inf above the diagonal gives exact-zero gradients, and no
    NaN reaches a leaf."""
    jcfg = jax_config()
    cfg = port_config()
    model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="ref"),
                        device="cpu")
    params = _port(numpy_params(jcfg, 10))
    tokens = torch.from_numpy(tokens_of(jcfg, n=3, seed=7))
    flags = torch.ones((cfg.n_layers,))
    grads = vmap(grad(lambda p, t: model.loss_fn(p, {"tokens": t[None]},
                                                 flags)),
                 in_dims=(None, 0), randomness="same")(params, tokens)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        assert g.shape == (3,) + params[name].shape
    assert grads["blocks.A_log"].abs().sum() > 0


# --------------------------------------------------------------------------- #
# one DP step, and the CLIs
# --------------------------------------------------------------------------- #
def test_dp_sgd_step_matches_jax_per_example_gradients():
    jcfg = jax_config()
    jquant = JQuantConfig(fmt="none")
    params = numpy_params(jcfg, 11)
    n, clip = 4, 0.5
    tokens = tokens_of(jcfg, n=n, seed=8)
    jflags = jnp.zeros((jcfg.n_layers,), jnp.float32)

    @jax.jit
    def reference(p, tok):
        def one(pp, t):
            return jmamba.lm_loss(pp, {"tokens": t[None]}, None, jflags,
                                  jcfg, jquant)

        losses = jax.vmap(one, in_axes=(None, 0))(p, tok)
        grads = jax.vmap(jax.grad(one), in_axes=(None, 0))(p, tok)
        sq = sum(jnp.sum(jnp.square(g.reshape(n, -1)), axis=1)
                 for g in jax.tree.leaves(grads))
        scale = jnp.minimum(1.0, clip / jnp.maximum(jnp.sqrt(sq), 1e-12))
        return losses.mean(), jax.tree.map(
            lambda a, g: a - LR * jnp.einsum("b...,b->...", g, scale) / n,
            p, grads)

    jloss, jnew = reference(params, jnp.asarray(tokens))
    cfg = port_config()
    run = RunConfig(model=cfg, quant=QuantConfig(fmt="none", backend="ref"),
                    dp=DPConfig(clip_norm=clip, noise_multiplier=0.0,
                                microbatch_size=2, clip_backend="fused"),
                    optim=OptimConfig(name="sgd", lr=LR), global_batch=n)
    model = build_model(cfg, run.quant, device="cpu")
    setup = build_train_setup(model, run)
    tparams = _port(params)
    new, _, metrics = setup.step_fn(
        tparams, setup.opt_init_fn(tparams),
        {"tokens": torch.from_numpy(tokens)}, 0,
        torch.zeros((cfg.n_layers,)), LR)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), **TOL)
    assert float(metrics["clip_fraction"]) > 0     # the clip acts
    want = _flat(jnew)
    assert set(new) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(new[name].numpy(), w, err_msg=name,
                                   rtol=1e-6, atol=1e-6)


def test_cli_trains_and_serves_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "4", "--microbatch", "2", "--seq-len", "24",
                    "--epochs", "1", "--steps-per-epoch", "2",
                    "--clip-backend", "fused", "--dataset-size", "4096"])
    out = capsys.readouterr().out.splitlines()
    epochs = [ln for ln in out if ln.startswith("epoch ")]
    assert len(epochs) == 1
    assert "k=2 " in epochs[0] and "acc=None" in epochs[0]
    loss = float(epochs[0].split("loss=")[1].split()[0])
    assert np.isfinite(loss)
    serve = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "20", "--gen", "4"]
    serve_cli.main(serve + ["--engine", "oneshot"])
    oneshot = capsys.readouterr().out
    serve_cli.main(serve)                          # continuous: falls back
    fallback = capsys.readouterr().out
    assert "falling back to --engine oneshot" in fallback
    assert fallback.split("generated token ids:")[1] == \
        oneshot.split("generated token ids:")[1]
