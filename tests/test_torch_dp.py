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
from repro.config import ModelConfig as JModelConfig  # noqa: E402
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
from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,  # noqa: E402
                                QuantConfig, RunConfig)
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


# The other CNNs' cases: a bottleneck ResNet (blocks (8, 1): ResNet-50's
# blocks, both kinds of projection; the reference's resnet50 SMOKE config
# builds basic blocks) and the DenseNet SMOKE config, each at a clip norm
# between its per-example norms (bottleneck 21.9-29.1, DenseNet 3.7-5.4).
# Each case: (JAX config, port config, clip norm, atol of the clipped sum
# over its largest entry, atol of a DP step's params).  The bottleneck's
# are 10x and 50x the others': there the reference's float32 one-example
# gradients (XLA on the CPU) are 2.3e-4 from a float64 evaluation of the
# same net (max abs, sum scale 3.45; e.g. 0.4 % of stages.0.3.conv3's
# largest entry), where the port's float32 ones are within 1.7e-6; a step
# moves that by LR / B: 2.9e-5.
BOTTLENECK = dict(name="rn-bottleneck", family="resnet", resnet_blocks=(8, 1),
                  num_classes=10, image_size=8, compute_dtype="float32")
CNN_CASES = {
    "resnet18": (lambda: jax_smoke_config("resnet18"),
                 lambda: get_smoke_config("resnet18"), CLIP, 1e-5, 1e-6),
    "bottleneck": (lambda: JModelConfig(**BOTTLENECK),
                   lambda: ModelConfig(**BOTTLENECK), 25.0, 1e-4, 5e-5),
    "densenet": (lambda: jax_smoke_config("densenet121"),
                 lambda: get_smoke_config("densenet121"), 4.2, 1e-5, 1e-6),
}


def mixed_policy(n: int) -> tuple:
    """A policy of every other layer, from layer 0."""
    return tuple(i % 2 == 0 for i in range(n))


def _jax_reference(fmt: str, quantized: bool, case: str = "resnet18") -> dict:
    """The JAX SMOKE model of ``case`` (ResNet-18 unless given) at ``fmt``
    with every layer's flag ``quantized``: params, a batch, the clipped
    gradient sum with its metrics, and the params after one DP step at
    sigma = 0 and one non-private step; under ``"mixed"`` the same from
    the same compiled programs under the traced flags of
    :func:`mixed_policy`."""
    jcfg, tcfg, clip, sum_atol, step_atol = CNN_CASES[case]
    cfg = jcfg()
    run = JRunConfig(model=cfg, quant=JQuantConfig(fmt=fmt),
                     dp=JDPConfig(clip_norm=clip, noise_multiplier=0.0,
                                  microbatch_size=MB),
                     optim=JOptimConfig(name="sgd", lr=LR), global_batch=B)
    model = jax_build_model(cfg, run.quant)
    # one compiled init (the eager one compiles every op on its own)
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    s = cfg.image_size
    batch = {"image": rng.standard_normal((B, s, s, 3)).astype(np.float32),
             "label": rng.integers(0, cfg.num_classes, B).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = jnp.full((cfg.policy_len(),), float(quantized), jnp.float32)
    mixed = jnp.asarray(mixed_policy(cfg.policy_len()), jnp.float32)

    def clip_sum(p, b, f):
        def loss_one(p, ex, r):
            return model.loss_fn(p, jax.tree.map(lambda x: x[None], ex), r,
                                 f)

        return jax_clip_sum(loss_one, p, b, clip_norm=clip,
                            microbatch_size=MB, rng=jax.random.PRNGKey(0))

    clip_sum = jax.jit(clip_sum)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {"params": tree(params), "batch": batch, "cfg": tcfg(),
           "clip": clip, "sum_atol": sum_atol, "step_atol": step_atol,
           "mixed": {}}
    for f, target in ((flags, out), (mixed, out["mixed"])):
        gsum, metrics = clip_sum(params, jbatch, f)
        target.update(gsum=tree(gsum),
                      metrics={k: float(v) for k, v in metrics.items()})
    for dp_on in (True, False):
        setup = jax_train_setup(model, dataclasses.replace(
            run, dp=dataclasses.replace(run.dp, enabled=dp_on)),
            make_host_mesh())
        step = jax.jit(setup.step_fn)
        for f, target in ((flags, out), (mixed, out["mixed"])):
            new_params, _, step_metrics = step(
                params, setup.opt_init_fn(params), jbatch, jnp.uint32(0), f,
                jnp.float32(LR))
            target[dp_on] = (tree(new_params), float(step_metrics["loss"]))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The reference at fmt none (no layer quantized)."""
    return _jax_reference("none", quantized=False)


@pytest.fixture(scope="module", params=["bottleneck", "densenet"])
def cnn_ref(request):
    """The reference of another CNN at fmt none (no layer quantized)."""
    return _jax_reference("none", quantized=False, case=request.param)


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
                   lambda rows, key: rows.clone())
        yield QFMT


@pytest.fixture(scope="module")
def jax_ref_quantized(identity_format):
    """The reference with every layer quantized at ``QFMT``: every conv's
    gradient goes through the quantized conv, stride-2 stage included."""
    return _jax_reference(identity_format, quantized=True)


def _port(jax_ref, dp: DPConfig, fmt: str = "none"):
    cfg = jax_ref["cfg"]
    run = RunConfig(model=cfg, quant=QuantConfig(fmt=fmt), dp=dp,
                    optim=OptimConfig(name="sgd", lr=LR), global_batch=B)
    model = build_model(cfg, run.quant, device="cpu")
    params = params_from_numpy(jax_ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in jax_ref["batch"].items()}
    return run, model, params, batch


def _check_clipped_sum(ref, clip_backend, fmt="none", quantized=False,
                       flags=None):
    """The port's clipped per-example gradient sum and its metrics, every
    layer's flag ``quantized`` (or ``flags``, with ``ref["mixed"]``),
    against the reference's ``ref``."""
    clip = ref["clip"]
    run, model, params, batch = _port(ref, DPConfig(clip_norm=clip), fmt)
    if flags is None:
        flags = (quantized,) * run.model.policy_len()
    else:
        ref = {**ref, **ref["mixed"]}

    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)

    gsum, metrics = per_example_clipped_grad_sum(
        loss_one, params, batch, clip_norm=clip, microbatch_size=MB,
        clip_backend=clip_backend)
    want = params_from_numpy(ref["gsum"], device="cpu")
    assert set(gsum) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(gsum[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=ref["sum_atol"] * scale, err_msg=name)
    jm = ref["metrics"]
    assert set(metrics) == set(jm)
    for k in ("loss", "grad_norm_mean", "grad_norm_max"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=1e-5)
    assert float(metrics["clip_fraction"]) == jm["clip_fraction"]
    assert 0 < jm["clip_fraction"] < 1              # some rows were clipped


def _check_one_step(ref, dp_on, clip_backend, fmt="none", quantized=False,
                    flags=None):
    """One DP-SGD step at sigma = 0, or one plain step, every layer's flag
    ``quantized`` (or ``flags``, with ``ref["mixed"]``): the new params and
    the loss equal the reference's, and the step writes none of its
    arguments."""
    dp = DPConfig(enabled=dp_on, clip_norm=ref["clip"], noise_multiplier=0.0,
                  microbatch_size=MB, clip_backend=clip_backend)
    run, model, params, batch = _port(ref, dp, fmt)
    if flags is None:
        flags = (quantized,) * run.model.policy_len()
    else:
        ref = {**ref, **ref["mixed"]}
    setup = build_train_setup(model, run)
    before = {k: v.clone() for k, v in params.items()}
    new_params, _, metrics = setup.step_fn(
        params, setup.opt_init_fn(params), batch, 0, flags, LR)
    for k in params:                                 # functional: no writes
        assert torch.equal(params[k], before[k])
    want_params, want_loss = ref[dp_on]
    want = params_from_numpy(want_params, device="cpu")
    for name, w in want.items():
        np.testing.assert_allclose(new_params[name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=ref["step_atol"],
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)


@pytest.mark.parametrize("clip_backend", ["ref", "fused"])
def test_clipped_grad_sum_and_metrics_match_jax(jax_ref, clip_backend):
    _check_clipped_sum(jax_ref, clip_backend)


@pytest.mark.parametrize("dp_on,clip_backend", [
    (True, "ref"), (True, "fused"), (False, "ref")])
def test_one_step_at_sigma_zero_matches_jax(jax_ref, dp_on, clip_backend):
    """One DP-SGD step at sigma = 0 (both clip paths), and one plain
    (non-private) step: the new params equal JAX's."""
    _check_one_step(jax_ref, dp_on, clip_backend)


@pytest.mark.parametrize("clip_backend", ["ref", "fused"])
def test_clipped_grad_sum_through_quantized_convs_matches_jax(jax_ref_quantized,
                                                              clip_backend):
    """Every conv quantized: the per-example gradients come from the
    quantized conv's backward under vmap, and equal JAX's."""
    _check_clipped_sum(jax_ref_quantized, clip_backend, QFMT, True)


@pytest.mark.parametrize("dp_on", [True, False])
def test_one_step_through_quantized_convs_matches_jax(jax_ref_quantized, dp_on):
    """One DP-SGD step at sigma = 0, and one plain step (autograd over the
    microbatch, no vmap), with every conv quantized: the new params equal
    JAX's."""
    _check_one_step(jax_ref_quantized, dp_on, "fused", QFMT, True)


@pytest.mark.parametrize("clip_backend", ["ref", "fused"])
def test_cnn_clipped_grad_sum_matches_jax(cnn_ref, clip_backend):
    """The bottleneck ResNet's and DenseNet's clipped per-example gradient
    sums (vmap engine) and metrics at fmt none equal JAX's."""
    _check_clipped_sum(cnn_ref, clip_backend)


@pytest.mark.parametrize("dp_on,clip_backend", [
    (True, "ref"), (True, "fused"), (False, "ref")])
def test_cnn_one_step_at_sigma_zero_matches_jax(cnn_ref, dp_on, clip_backend):
    """One DP-SGD step at sigma = 0 and one plain step of the bottleneck
    ResNet and of DenseNet: the new params equal JAX's."""
    _check_one_step(cnn_ref, dp_on, clip_backend)


def _device_flags(ref):
    """:func:`mixed_policy` as the trainer's float32 flags tensor."""
    return torch.tensor(mixed_policy(ref["cfg"].policy_len()),
                        dtype=torch.float32)


@pytest.mark.parametrize("clip_backend", ["ref", "fused"])
def test_device_flags_match_jax_under_traced_flags(jax_ref_quantized,
                                                   clip_backend):
    """Every other layer quantized at ``QFMT``, the policy a float32 tensor
    read on the device: the clipped sum and one DP-SGD step equal the
    reference's under the same traced flags (its programs compiled once
    for both policies)."""
    flags = _device_flags(jax_ref_quantized)
    _check_clipped_sum(jax_ref_quantized, clip_backend, QFMT, flags=flags)
    _check_one_step(jax_ref_quantized, True, clip_backend, QFMT, flags=flags)


def test_device_flags_at_fmt_none_match_jax(jax_ref):
    """At fmt ``none`` a device policy runs the plain ops: the clipped sum
    and a DP step equal the reference's under its traced flags."""
    flags = _device_flags(jax_ref)
    _check_clipped_sum(jax_ref, "fused", flags=flags)
    _check_one_step(jax_ref, True, "ref", flags=flags)


def test_cnn_device_flags_at_fmt_none_match_jax(cnn_ref):
    """The bottleneck ResNet and DenseNet under a device policy at fmt
    ``none``: as above."""
    flags = _device_flags(cnn_ref)
    _check_clipped_sum(cnn_ref, "fused", flags=flags)
    _check_one_step(cnn_ref, True, "ref", flags=flags)


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


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "densenet121",
                                  "stablelm-3b"])
def test_ghost_mode_accepts_every_training_family(arch):
    """Grad-mode validation.  Ghost mode is ported for the dense LMs and
    both CNN families (the conv ghost taps); ghost with the fused clip,
    an unknown mode and an unknown clip path are refused."""
    ghost_dp = dataclasses.replace(DPConfig(), grad_mode="ghost")
    model = build_model(get_smoke_config(arch), QuantConfig(fmt="none"),
                        device="cpu")
    engine.validate_grad_mode(ghost_dp, model)
    build_train_setup(model, RunConfig(model=model.config, dp=ghost_dp))
    with pytest.raises(ValueError, match="clip_backend='fused'"):
        engine.validate_grad_mode(dataclasses.replace(
            ghost_dp, clip_backend="fused"), model)
    with pytest.raises(ValueError, match="grad_mode"):
        engine.validate_grad_mode(DPConfig(grad_mode="sharded"))
    with pytest.raises(ValueError, match="clip_backend"):
        engine.validate_grad_mode(DPConfig(clip_backend="pallas"))
