"""PyTorch port vs JAX package: the DP gradient (repro_torch.dp and the
per_sample_clip kernel's plain version) and one DP-SGD step.

Deterministic parts are held to float32 tolerance against the JAX
package on the same numpy params and batches: the clip kernel's plain
version within 1e-6 relative of the Pallas kernel (interpret mode); the
clipped per-example gradient sum and its metrics at fmt ``none``, through
both clip paths, within 1e-5 relative; one full DP step at sigma = 0, and
one non-private step (new params) within 1e-5.  The same clipped sum and
steps again with every conv quantized at a format registered as the
identity in both packages: the gradients then come from the port's
hand-written quantized-conv backward and the reference's custom VJP, held
to the same tolerances.  The Gaussian noise comes from another
generator than JAX's, so it is held statistically to std sigma * C / B.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import DPConfig as JDPConfig  # noqa: E402
from repro.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.dp.clip import per_example_clipped_grad_sum as jax_clip_sum  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_train_setup as jax_train_setup  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.quant import backend as jbackend  # noqa: E402
from repro_torch.config import DPConfig, OptimConfig, QuantConfig, RunConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.dp import engine  # noqa: E402
from repro_torch.dp.clip import per_example_clipped_grad_sum  # noqa: E402
from repro_torch.dp.noise import add_gaussian_noise  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import build_train_setup  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402

torch.set_num_threads(1)

B, MB, CLIP, LR = 4, 2, 14.5, 0.5      # per-example norms here: 13-16
# A deterministic format that rounds nothing (``identity_format``).  A
# real one cannot be held this tight: at bf16 a float32 value within an
# ulp of a rounding edge rounds either way, and the summation order of
# XLA's and PyTorch's convolutions decides it.  There the port's clipped
# sum differs from the reference's by 1.9e-3 of its largest entry, as
# much as the port's own differs when the input moves by one ulp.
QFMT = "identity_for_tests"


@pytest.mark.parametrize("b,d", [(1, 700), (4, 1300), (3, 1536)])
def test_clip_kernel_plain_version_matches_pallas(b, d):
    rng = np.random.default_rng(b * d)
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.05
    if b > 1:
        g[1] = 0.0                                   # an all-zero row
    jsum, jnorms = jops.clip_and_sum(jnp.asarray(g), 1.0, interpret=True)
    tsum, tnorms = ops.clip_and_sum(torch.from_numpy(g), 1.0)
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jsum).max()))


def test_clip_kernel_plain_version_takes_a_view_at_an_offset():
    """The wrapper takes a (B, D) view that starts inside its storage (the
    kernel handles any 4-byte aligned start) and agrees with the Pallas
    kernel on the same values."""
    b, d, offset = 5, 1537, 3
    rng = np.random.default_rng(b * d + offset)
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.05
    storage = torch.full((offset + b * d,), float("nan"))
    view = storage[offset:].view(b, d)
    view.copy_(torch.from_numpy(g))
    jsum, jnorms = jops.clip_and_sum(jnp.asarray(g), 1.0, interpret=True)
    tsum, tnorms = ops.clip_and_sum(view, 1.0)
    np.testing.assert_allclose(tnorms.numpy(), np.asarray(jnorms),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jsum).max()))


def _jax_reference(fmt: str, quantized: bool) -> dict:
    """JAX SMOKE ResNet-18 at ``fmt`` with every layer's flag ``quantized``:
    params, a batch, the clipped gradient sum with its metrics, and the
    params after one DP step at sigma = 0 and one non-private step."""
    cfg = jax_smoke_config("resnet18")
    run = JRunConfig(model=cfg, quant=JQuantConfig(fmt=fmt),
                     dp=JDPConfig(clip_norm=CLIP, noise_multiplier=0.0,
                                  microbatch_size=MB),
                     optim=JOptimConfig(name="sgd", lr=LR), global_batch=B)
    model = jax_build_model(cfg, run.quant)
    params = model.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    batch = {"image": rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, cfg.num_classes, B).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = jnp.full((cfg.policy_len(),), float(quantized), jnp.float32)

    def loss_one(p, ex, r):
        return model.loss_fn(p, jax.tree.map(lambda x: x[None], ex), r,
                             flags)

    gsum, metrics = jax.jit(lambda p, b: jax_clip_sum(
        loss_one, p, b, clip_norm=CLIP, microbatch_size=MB,
        rng=jax.random.PRNGKey(0)))(params, jbatch)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {"params": tree(params), "batch": batch, "gsum": tree(gsum),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    for dp_on in (True, False):
        setup = jax_train_setup(model, dataclasses.replace(
            run, dp=dataclasses.replace(run.dp, enabled=dp_on)),
            make_host_mesh())
        new_params, _, step_metrics = jax.jit(setup.step_fn)(
            params, setup.opt_init_fn(params), jbatch, jnp.uint32(0), flags,
            jnp.float32(LR))
        out[dp_on] = (tree(new_params), float(step_metrics["loss"]))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The reference at fmt none (no layer quantized)."""
    return _jax_reference("none", quantized=False)


@pytest.fixture(scope="module")
def identity_format():
    """``QFMT`` registered in both packages' quantizer registries as the
    identity: a layer quantized at ``QFMT`` runs the fake-quantized conv
    (the port's hand-written backward, the reference's custom VJP) with
    nothing rounded, so the two agree to float32 tolerance."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda x, key=None: x)
        mp.setitem(qbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda rows, u: rows.clone())
        yield QFMT


@pytest.fixture(scope="module")
def jax_ref_quantized(identity_format):
    """The reference with every layer quantized at ``QFMT``: every conv's
    gradient goes through the quantized conv, stride-2 stage included."""
    return _jax_reference(identity_format, quantized=True)


def _port(jax_ref, dp: DPConfig, fmt: str = "none"):
    cfg = get_smoke_config("resnet18")
    run = RunConfig(model=cfg, quant=QuantConfig(fmt=fmt), dp=dp,
                    optim=OptimConfig(name="sgd", lr=LR), global_batch=B)
    model = build_model(cfg, run.quant, device="cpu")
    params = params_from_numpy(jax_ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in jax_ref["batch"].items()}
    return run, model, params, batch


@pytest.mark.parametrize("clip_backend", ["ref", "fused"])
def test_clipped_grad_sum_and_metrics_match_jax(jax_ref, clip_backend):
    run, model, params, batch = _port(jax_ref, DPConfig(clip_norm=CLIP))
    flags = (False,) * run.model.policy_len()

    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)

    gsum, metrics = per_example_clipped_grad_sum(
        loss_one, params, batch, clip_norm=CLIP, microbatch_size=MB,
        clip_backend=clip_backend)
    want = params_from_numpy(jax_ref["gsum"], device="cpu")
    assert set(gsum) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(gsum[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    jm = jax_ref["metrics"]
    assert set(metrics) == set(jm)
    for k in ("loss", "grad_norm_mean", "grad_norm_max"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=1e-5)
    assert float(metrics["clip_fraction"]) == jm["clip_fraction"]
    assert 0 < jm["clip_fraction"] < 1              # some rows were clipped


@pytest.mark.parametrize("dp_on,clip_backend", [
    (True, "ref"), (True, "fused"), (False, "ref")])
def test_one_step_at_sigma_zero_matches_jax(jax_ref, dp_on, clip_backend):
    """One DP-SGD step at sigma = 0 (both clip paths), and one plain
    (non-private) step: the new params equal JAX's."""
    dp = DPConfig(enabled=dp_on, clip_norm=CLIP, noise_multiplier=0.0,
                  microbatch_size=MB, clip_backend=clip_backend)
    run, model, params, batch = _port(jax_ref, dp)
    setup = build_train_setup(model, run)
    before = {k: v.clone() for k, v in params.items()}
    new_params, _, metrics = setup.step_fn(
        params, setup.opt_init_fn(params), batch, 0,
        (False,) * run.model.policy_len(), LR)
    for k in params:                                 # functional: no writes
        assert torch.equal(params[k], before[k])
    want_params, want_loss = jax_ref[dp_on]
    want = params_from_numpy(want_params, device="cpu")
    for name, w in want.items():
        np.testing.assert_allclose(new_params[name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)


@pytest.mark.parametrize("clip_backend", ["ref", "fused"])
def test_clipped_grad_sum_through_quantized_convs_matches_jax(jax_ref_quantized,
                                                              clip_backend):
    """Every conv quantized: the per-example gradients come from the
    quantized conv's backward under vmap, and equal JAX's."""
    run, model, params, batch = _port(jax_ref_quantized, DPConfig(clip_norm=CLIP),
                                      QFMT)
    flags = (True,) * run.model.policy_len()

    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)

    gsum, metrics = per_example_clipped_grad_sum(
        loss_one, params, batch, clip_norm=CLIP, microbatch_size=MB,
        clip_backend=clip_backend)
    want = params_from_numpy(jax_ref_quantized["gsum"], device="cpu")
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(gsum[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    jm = jax_ref_quantized["metrics"]
    for k in ("loss", "grad_norm_mean", "grad_norm_max"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=1e-5)
    assert float(metrics["clip_fraction"]) == jm["clip_fraction"]
    assert 0 < jm["clip_fraction"] < 1


@pytest.mark.parametrize("dp_on", [True, False])
def test_one_step_through_quantized_convs_matches_jax(jax_ref_quantized, dp_on):
    """One DP-SGD step at sigma = 0, and one plain step (autograd over the
    microbatch, no vmap), with every conv quantized: the new params equal
    JAX's."""
    dp = DPConfig(enabled=dp_on, clip_norm=CLIP, noise_multiplier=0.0,
                  microbatch_size=MB, clip_backend="fused")
    run, model, params, batch = _port(jax_ref_quantized, dp, QFMT)
    setup = build_train_setup(model, run)
    new_params, _, metrics = setup.step_fn(
        params, setup.opt_init_fn(params), batch, 0,
        (True,) * run.model.policy_len(), LR)
    want_params, want_loss = jax_ref_quantized[dp_on]
    want = params_from_numpy(want_params, device="cpu")
    for name, w in want.items():
        np.testing.assert_allclose(new_params[name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)


def test_noise_std_is_sigma_c_over_b():
    sigma, c, b = 1.3, 0.7, 8
    zeros = {"a": torch.zeros(200_000), "b": torch.zeros(300, 100)}

    def noisy(seed):
        return add_gaussian_noise(
            zeros, clip_norm=c, noise_multiplier=sigma, batch_size=b,
            generator=torch.Generator().manual_seed(seed))

    out = torch.cat([v.reshape(-1) for v in noisy(0).values()])
    n, want = out.numel(), sigma * c / b
    # 5 standard errors of the sample std and mean of n normals
    assert abs(out.std().item() - want) <= 5 * want / (2 * n) ** 0.5
    assert abs(out.mean().item()) <= 5 * want / n ** 0.5
    again = noisy(0)
    assert all(torch.equal(again[k], v) for k, v in noisy(0).items())
    assert not torch.equal(noisy(1)["a"], again["a"])


def test_clip_sum_has_its_own_knob(monkeypatch):
    """REPRO_QUANT_BACKEND pins the quantizers, never the clip: an explicit
    "fused" request stays on the kernel."""
    from repro_torch.quant import backend as qbackend
    monkeypatch.setenv(qbackend.ENV_VAR, "ref")
    assert qbackend.get_clip_sum("fused")[1] == "cuda"
    assert qbackend.get_clip_sum("ref")[1] == "ref"
    assert qbackend.get_quantizer("luq_fp4", "cuda")[1] == "ref"
    with pytest.raises(ValueError, match="clip backend"):
        qbackend.get_clip_sum("pallas")


def test_ghost_mode_is_not_ported_yet():
    """Grad-mode validation.  Ghost mode is ported for the dense LMs; on a
    ResNet it needs the conv ghost taps, a later slice, and raises.  Ghost
    with the fused clip, an unknown mode and an unknown clip path are
    refused."""
    ghost_dp = dataclasses.replace(DPConfig(), grad_mode="ghost")
    resnet = build_model(get_smoke_config("resnet18"),
                         QuantConfig(fmt="none"), device="cpu")
    lm = build_model(get_smoke_config("stablelm-3b"), QuantConfig(fmt="none"),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="conv ghost taps"):
        engine.validate_grad_mode(ghost_dp, resnet)
    with pytest.raises(NotImplementedError, match="conv ghost taps"):
        build_train_setup(resnet, RunConfig(model=resnet.config, dp=ghost_dp))
    engine.validate_grad_mode(ghost_dp, lm)
    with pytest.raises(ValueError, match="clip_backend='fused'"):
        engine.validate_grad_mode(dataclasses.replace(
            ghost_dp, clip_backend="fused"), lm)
    with pytest.raises(ValueError, match="grad_mode"):
        engine.validate_grad_mode(DPConfig(grad_mode="sharded"))
    with pytest.raises(ValueError, match="clip_backend"):
        engine.validate_grad_mode(DPConfig(clip_backend="pallas"))
