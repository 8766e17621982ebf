"""Ghost-mode DP-SGD in the port (``repro_torch.dp.ghost``) against the JAX
package's ghost engine, against the port's own vmap engine, and its
routing to the fused ``ghost_norm`` op.

Against ``repro.dp.ghost`` (its two passes, ``_two_pass``), on the same
numpy params and tokens, for the stablelm-3b smoke config (untied head)
and the gemma-7b smoke config (tied embeddings: the gather-head cross
term): at fmt ``none``, and at a format registered in both packages as the
identity, which drives every fold of every projection through the hooks
(the port's hand-written qeinsum backward and tap).  The JAX package's
tolerances (``tests/test_dp_ghost.py``): per-example norms rtol 1e-4;
clipped sums rtol 2e-4, atol 2e-5; losses rtol 1e-5.

Under a policy given as a float32 device tensor (every layer's entry read
on the device, the reference's traced flags), against the reference's two
passes under the same flags, compiled once for every policy.  The
reference runs with its default remat (each block under
``jax.checkpoint``) and so does the port (``torch.utils.checkpoint``);
remat on and off give the port the same bits.

Within the port at luq_fp4 on the ``cuda`` backend with CPU tensors (the
fused op runs the kernel's plain version): ghost against vmap at the same
tolerances, with every layer quantized and with part of them, by host
bools and by a device policy; the pass-1 chunking changes nothing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

import repro.dp.ghost as jghost  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.quant import backend as jbackend  # noqa: E402
from repro_torch.config import QuantConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.dp import ghost  # noqa: E402
from repro_torch.dp.clip import per_example_clipped_grad_sum  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["stablelm-3b", "gemma-7b"]
QFMT = "identity_for_tests"         # registered as the identity (fixture)
B, S = 4, 12
NORM_TOL = dict(rtol=1e-4, atol=0.0)
SUM_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def identity_format():
    """``QFMT`` as the identity quantizer in both packages (and its
    ``ghost_norm`` op as the plain Gram reduction, which neither package
    fuses on its ref backend)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda x, key=None: x)
        mp.setitem(jbackend._REGISTRY, ("ghost_norm", QFMT, "ref"),
                   lambda xm, gm, kx, kg: jghost._matpair_sq_norm(xm, gm))
        mp.setitem(qbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda rows, key: rows.clone())
        mp.setitem(qbackend._REGISTRY, ("ghost_norm", QFMT, "ref"),
                   lambda x, g, kx, kg: ghost._matpair_sq_norm(x, g))
        yield QFMT


def _port(arch, fmt, backend="ref", params=None, seed=0):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, QuantConfig(fmt=fmt, backend=backend),
                        device="cpu")
    if params is None:
        params = model.init(seed)
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    return cfg, model, params, batch


def _ghost(model, params, batch, flags, clip, chunk=0):
    pel = lambda p, b, h: model.per_example_loss(p, b, flags,  # noqa: E731
                                                 hooks=h)
    kw = dict(hooked_mask=model.ghost_mask(params),
              aux=model.ghost_aux(flags))
    losses, norms = ghost.ghost_per_example_norms(pel, params, batch,
                                                  microbatch=chunk, **kw)
    gsum, metrics = ghost.ghost_clipped_grad_sum(
        pel, params, batch, clip_norm=clip, ghost_microbatch=chunk, **kw)
    return losses, norms, gsum, metrics


_JAX_TWO_PASS = {}


def _jax_two_pass(arch, fmt, params_np, tokens, clip, flags=None):
    """The reference's two ghost passes under its traced ``flags`` (every
    layer's 1 when None), with its default remat (each block under
    ``jax.checkpoint``); compiled once per (arch, fmt) for every policy
    and clip norm."""
    if (arch, fmt) not in _JAX_TWO_PASS:
        cfg = jax_smoke_config(arch)
        assert cfg.remat
        model = jax_build_model(cfg, JQuantConfig(fmt=fmt))

        def two_pass(p, b, clip, f):
            def loss_one(p, ex, r):
                return model.loss_fn(p, jax.tree.map(lambda x: x[None], ex),
                                     r, f)

            def pel(p, b, r):
                return model.per_example_loss(p, b, r, f)

            return jghost._two_pass(
                loss_one, pel, p, b, clip_norm=clip,
                rng=jax.random.PRNGKey(0), hooked_mask=model.ghost_mask(p),
                aux=model.ghost_aux(f), ghost_microbatch=0)

        _JAX_TWO_PASS[arch, fmt] = (cfg, jax.jit(two_pass))
    cfg, two_pass = _JAX_TWO_PASS[arch, fmt]
    if flags is None:
        flags = (True,) * cfg.policy_len()
    grads, losses, norms = two_pass(params_np, {"tokens": jnp.asarray(tokens)},
                                    jnp.float32(clip),
                                    jnp.asarray(flags, jnp.float32))
    return (jax.tree.map(np.asarray, grads), np.asarray(losses),
            np.asarray(norms))


def _numpy_params(arch, seed):
    """Params of the JAX model's shapes from numpy, N(0, 0.1^2)."""
    model = jax_build_model(jax_smoke_config(arch), JQuantConfig(fmt="none"))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def _between(norms) -> float:
    """A clip norm halfway between the two middle per-example norms: some
    examples are clipped, and none sits at the edge."""
    n = norms.sort().values
    return float(n[len(n) // 2 - 1] + n[len(n) // 2]) / 2


def _assert_sums_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **SUM_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", ["none", QFMT])
def test_ghost_matches_jax(identity_format, arch, fmt):
    params_np = _numpy_params(arch, 3)
    cfg, model, params, batch = _port(
        arch, fmt, params=params_from_numpy(params_np, device="cpu"))
    flags = (True,) * cfg.n_layers
    # a clip norm between the per-example norms, so some are clipped
    _, probe = ghost.ghost_per_example_norms(
        lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h),
        params, batch, hooked_mask=model.ghost_mask(params),
        aux=model.ghost_aux(flags))
    clip = _between(probe)
    losses, norms, gsum, metrics = _ghost(model, params, batch, flags, clip)
    jgrads, jlosses, jnorms = _jax_two_pass(arch, fmt, params_np,
                                            batch["tokens"].numpy(), clip)
    np.testing.assert_allclose(norms.numpy(), jnorms, **NORM_TOL)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    _assert_sums_close(gsum, params_from_numpy(jgrads, device="cpu"))
    assert 0 < float(metrics["clip_fraction"]) < 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", ["none", QFMT])
def test_device_flags_match_jax_under_traced_flags(identity_format, arch,
                                                   fmt):
    """The first layer quantized, the policy the trainer's float32 tensor
    read on the device: pass-1 norms, losses and clipped sums equal the
    reference's two passes under the same traced flags (one compile for
    both policies)."""
    params_np = _numpy_params(arch, 3)
    cfg, model, params, batch = _port(
        arch, fmt, params=params_from_numpy(params_np, device="cpu"))
    policy = (True,) + (False,) * (cfg.n_layers - 1)
    flags = torch.tensor(policy, dtype=torch.float32)
    _, probe = ghost.ghost_per_example_norms(
        lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h),
        params, batch, hooked_mask=model.ghost_mask(params),
        aux=model.ghost_aux(flags))
    clip = _between(probe)
    losses, norms, gsum, metrics = _ghost(model, params, batch, flags, clip)
    jgrads, jlosses, jnorms = _jax_two_pass(
        arch, fmt, params_np, batch["tokens"].numpy(), clip, policy)
    np.testing.assert_allclose(norms.numpy(), jnorms, **NORM_TOL)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    _assert_sums_close(gsum, params_from_numpy(jgrads, device="cpu"))
    assert 0 < float(metrics["clip_fraction"]) < 1


@pytest.mark.parametrize("fmt,backend", [("none", "ref"),
                                         ("luq_fp4", "cuda")])
def test_remat_matches_no_remat(fmt, backend):
    """Each block checkpointed (the default) against no remat, in both
    ghost passes: the recomputed forward is the same float32 operations
    (the quantizers' draws are keyed by their static (seed, fold)), so
    losses, pass-1 norms and the clipped sum are bit for bit the same."""
    cfg, model, params, batch = _port("stablelm-3b", fmt, backend=backend)
    assert cfg.remat
    plain = build_model(dataclasses.replace(cfg, remat=False),
                        QuantConfig(fmt=fmt, backend=backend), device="cpu")
    flags = torch.tensor([1.0, 0.0])
    got = _ghost(model, params, batch, flags, clip=1.0, chunk=2)
    want = _ghost(plain, params, batch, flags, clip=1.0, chunk=2)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    for k, v in want[2].items():
        assert torch.equal(got[2][k], v), k


def _loss_one(model, flags):
    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)
    return loss_one


def _vmap_norms(model, params, batch, flags):
    """The per-example gradient norms of the vmap engine's
    ``torch.func`` gradients."""
    grads = vmap(grad(_loss_one(model, flags)), in_dims=(None, 0),
                 randomness="same")(params, batch)
    return torch.sqrt(sum(g.square().sum(dim=tuple(range(1, g.dim())))
                          for g in grads.values()))


@pytest.mark.parametrize("arch,flags", [
    ("stablelm-3b", (True, True)), ("stablelm-3b", (False, True)),
    ("gemma-7b", (True, False, True))])
def test_ghost_matches_vmap_at_luq_fp4(arch, flags):
    """luq_fp4 on the cuda backend: every Gram-route projection goes
    through the fused ghost_norm op (its plain version on CPU tensors)."""
    cfg, model, params, batch = _port(arch, "luq_fp4", backend="cuda")
    assert qbackend.get_ghost_norm("luq_fp4", "cuda")[1] == "cuda"
    vnorms = _vmap_norms(model, params, batch, flags)
    clip = _between(vnorms)
    vsum, vmetrics = per_example_clipped_grad_sum(
        _loss_one(model, flags), params, batch, clip_norm=clip,
        microbatch_size=B)
    losses, norms, gsum, metrics = _ghost(model, params, batch, flags, clip,
                                          chunk=2)
    np.testing.assert_allclose(norms.numpy(), vnorms.numpy(), **NORM_TOL)
    _assert_sums_close(gsum, vsum)
    for k in ("loss", "grad_norm_mean", "grad_norm_max"):
        np.testing.assert_allclose(float(metrics[k]), float(vmetrics[k]),
                                   rtol=1e-4)
    assert float(metrics["clip_fraction"]) == float(vmetrics["clip_fraction"])
    assert 0 < float(metrics["clip_fraction"]) < 1


def test_ghost_matches_vmap_under_device_flags():
    """luq_fp4 on the cuda backend, the second layer quantized by a device
    flag: the fused ghost norm under ``torch.where`` (float32 operands)
    and the vmap engine's per-example gradients agree as above."""
    cfg, model, params, batch = _port("stablelm-3b", "luq_fp4",
                                      backend="cuda")
    flags = torch.tensor([0.0, 1.0])
    vnorms = _vmap_norms(model, params, batch, flags)
    clip = _between(vnorms)
    vsum, _ = per_example_clipped_grad_sum(
        _loss_one(model, flags), params, batch, clip_norm=clip,
        microbatch_size=B)
    losses, norms, gsum, metrics = _ghost(model, params, batch, flags, clip,
                                          chunk=2)
    np.testing.assert_allclose(norms.numpy(), vnorms.numpy(), **NORM_TOL)
    _assert_sums_close(gsum, vsum)
    assert 0 < float(metrics["clip_fraction"]) < 1


def test_pass1_chunking_changes_nothing():
    cfg, model, params, batch = _port("stablelm-3b", "luq_fp4",
                                      backend="cuda", seed=5)
    flags = (True,) * cfg.n_layers
    whole = _ghost(model, params, batch, flags, clip=1.0, chunk=0)
    for chunk in (1, 2):
        part = _ghost(model, params, batch, flags, clip=1.0, chunk=chunk)
        np.testing.assert_allclose(part[1].numpy(), whole[1].numpy(),
                                   rtol=1e-6)
        for k, v in whole[2].items():
            np.testing.assert_allclose(part[2][k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        _ghost(model, params, batch, flags, clip=1.0, chunk=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_lm_leaves_no_fallback(arch):
    cfg, model, params, _ = _port(arch, "none")
    flags = (True,) * cfg.n_layers
    aux = model.ghost_aux(flags)
    state = ghost.per_example_state_bytes(params, model.ghost_mask(params), 8,
                                          aux=aux)
    total = sum(t.numel() for t in params.values())
    assert state == {"params_total": total, "params_nonhooked": 0,
                     "vmap_bytes": 8 * total * 4, "ghost_bytes": 0}
    # without the aux hooks the embedding, head and norms are uncovered,
    # and their vmapped fallback is not ported
    with pytest.raises(NotImplementedError, match="fallback"):
        ghost.ghost_per_example_norms(
            lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h),
            params,
            _port(arch, "none")[3], hooked_mask=model.ghost_mask(params))


# (spec, x shape per example, output axes of w, fmt, backend, q_wgrad):
# "native" is the backend with the fused op (pallas in JAX, cuda here);
# the fused route needs the format there, a quantized wgrad, views that
# are pure reshapes and T^2 <= din * dout
ROUTES = [
    ("bsd,dhk->bshk", (16, 8), (4, 8), "luq_fp4", "native", True),  # fused
    ("bsf,fd->bsd", (6, 9), (5,), "luq_fp4", "native", True),       # fused
    ("bshk,hkd->bsd", (12, 2, 3), (16,), "luq_fp4", "native", True),  # 144 > 96
    ("bsd,dk->bks", (16, 16), (16,), "luq_fp4", "native", True),    # axes moved
    ("bsd,dhk->bshk", (16, 8), (4, 8), "luq_fp4", "ref", True),
    ("bsd,dhk->bshk", (16, 8), (4, 8), "luq_fp4", "native", False),
    ("bsd,dhk->bshk", (16, 8), (4, 8), "int4", "native", True),     # no op
]


@pytest.mark.parametrize("spec,xs,ws,fmt,backend,q_wgrad", ROUTES)
def test_fused_route_taken_exactly_when_jax_takes_it(monkeypatch, spec, xs,
                                                     ws, fmt, backend,
                                                     q_wgrad):
    """Each package's fused op is replaced by a recorder, and its
    quantizers by the identity (only the route is compared)."""
    calls = {"jax": 0, "port": 0}

    def jax_op(xm, gm, kx, kg):
        calls["jax"] += 1
        return jnp.sum(xm) * 0.0

    def port_op(x, g, kx, kg):
        calls["port"] += 1
        assert (kx, kg) == (fq.stream_key(3, 4), fq.stream_key(3, 5))
        return torch.zeros(x.shape[0])

    monkeypatch.setitem(jbackend._REGISTRY, ("ghost_norm", "luq_fp4",
                                             "pallas"), jax_op)
    monkeypatch.setitem(qbackend._REGISTRY, ("ghost_norm", "luq_fp4",
                                             "cuda"), port_op)
    for be in ("ref", "pallas"):
        monkeypatch.setitem(jbackend._REGISTRY, ("quantize", fmt, be),
                            lambda x, key: x)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + xs).astype(np.float32)
    w_term = spec.split(",")[1].split("->")[0]
    wshape = xs[-(len(w_term) - len(ws)):] + ws
    y = np.einsum(spec, x, rng.standard_normal(wshape).astype(np.float32))
    g = rng.standard_normal(y.shape).astype(np.float32)
    jghost._tap_sq_norm(spec, jnp.asarray(x[:1]), jnp.asarray(g[:1]),
                        jnp.uint32(3), jnp.float32(1.0), fmt, q_wgrad,
                        "pallas" if backend == "native" else "ref")
    espec = fq._ESpec(spec, fmt, "cuda" if backend == "native" else "ref", 3,
                      quantized=True, q_fwd=True, q_dgrad=True,
                      q_wgrad=q_wgrad, per_example=True)
    out = ghost._tap_sq_norm(espec, torch.from_numpy(x), torch.from_numpy(g))
    assert out.shape == (2,)
    assert calls["port"] == calls["jax"]
    assert calls["port"] == int(ROUTES.index((spec, xs, ws, fmt, backend,
                                              q_wgrad)) < 2)
