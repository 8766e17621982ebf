"""The DPQuant policy as a device tensor: one graph of a step for every
policy, read by the quantizer and ghost-norm kernels on the device.

The port's counterpart of the reference's traced flags
(``repro.quant.fake_quant``: ``lax.cond(flag > 0.5, quantize, identity)``,
``tests/test_fake_quant.py::test_flag_switch_no_recompile``), on the CPU,
where every kernel wrapper runs its plain version:

* the ``luq_quant`` kernel's plain version given its flag is the
  reference's ``luq_quant_ref`` fed the port's Philox uniforms under
  ``lax.cond`` (bitwise); every quantizer passes its operand through bit
  for bit at flag 0 and gives its own bits at flag 1; the ghost norm at
  flag 0 is the norm of the unquantized bf16 operands (rtol 1e-6 of the
  float64 value, 1e-5 of the float32 Grams ``dp.ghost`` takes);
* one ``EpochRunner`` serves two policies with one capture, each call
  the bits of eager steps under its policy (the trainers' probe program
  against the eager probes: ``test_torch_epoch_executor``);
* in the ResNet and DenseNet test nets and a 2-layer LM, vmap and ghost
  mode: device flags all on give the bits of the host-bool quantized
  path, all off the clipped gradient sum of fmt ``none`` within rtol 1e-5
  and atol 1e-5 of each leaf's largest entry (the quantized functions'
  hand-written backward against autograd's, summed in another order).

The traced-flags parity against the reference's jitted steps at fmt
``none``, at an identity format and at luq_fp4 fed the port's draws is
in the files that already compile those references
(``test_torch_dp``, ``test_torch_ghost``, ``test_torch_ghost_conv``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import vmap  # noqa: E402

from repro.kernels.ref import luq_quant_ref as jax_luq_quant_ref  # noqa: E402
from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,  # noqa: E402
                                QuantConfig, RunConfig)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import ImageClassDataset  # noqa: E402
from repro_torch.dp import ghost  # noqa: E402
from repro_torch.dp.clip import per_example_clipped_grad_sum  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import EpochRunner, build_train_setup  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.quant import philox  # noqa: E402

torch.set_num_threads(1)

ON, OFF = torch.tensor(1.0), torch.tensor(0.0)
OFF_TOL = 1e-5          # flag off against fmt none: rtol, and atol x max|leaf|


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --------------------------------------------------------------------------- #
# the kernels and the quantize op
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_luq_quant_flag_is_the_reference_cond(dtype):
    """``luq_quant`` given its flag: the reference's ``luq_quant_ref`` of
    each row, fed the port's uniforms, under ``lax.cond(flag > 0.5, q,
    identity)``; at flag 0 the operand's own bits (codes: in bf16)."""
    n = 301
    x = (torch.randn(3, n, generator=_gen(3)) * 2).to(dtype)
    key = fq.stream_key(5, 3)
    u = jnp.asarray(philox.uniforms(key, 0, n).numpy())
    xj = jnp.asarray(x.float().numpy())
    alpha = jnp.max(jnp.abs(xj), axis=1)
    cond = jax.jit(lambda f: jax.lax.cond(
        f > 0.5,
        lambda v: jax.vmap(lambda r, a: jax_luq_quant_ref(r, u, a))(v, alpha),
        lambda v: v, xj))
    for flag in (OFF, ON):
        got = ops.luq_quant(x, key, flag=flag)
        assert got.dtype == dtype
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(cond(jnp.float32(flag.item()))))
        codes = ops.luq_quant(x, key, codes=True, flag=flag)
        assert torch.equal(codes, ops.luq_quant(x, key, codes=True)
                           if flag else x.bfloat16())
    assert torch.equal(ops.luq_quant(x, key, flag=OFF), x)


@pytest.mark.parametrize("fmt,backend", [
    ("luq_fp4", "cuda"), ("luq_fp4", "ref"), ("int4", "cuda"),
    ("fp8_e4m3", "ref"), ("bf16", "cuda")])
def test_every_quantizer_passes_through_at_flag_zero(fmt, backend):
    """The quantize op under a device flag, whether its impl reads the
    flag (the ``cuda`` luq_fp4 kernel) or is wrapped in ``torch.where``:
    flag 1 its own bits, flag 0 the rows themselves."""
    rows = torch.randn(4, 67, generator=_gen(4)) * 3
    want = fq._quantize_rows(rows, fmt, backend, 9, 1)
    assert torch.equal(fq._quantize_rows(rows, fmt, backend, 9, 1, ON), want)
    assert torch.equal(fq._quantize_rows(rows, fmt, backend, 9, 1, OFF), rows)


def test_fake_quant_takes_an_unbatched_flag_under_vmap():
    """The custom op's vmap rule: one row per example under the layer's
    flag; a flag batched over the examples is refused."""
    x = torch.randn(5, 3, 7, generator=_gen(5))
    for flag in (OFF, ON):
        got = vmap(lambda ex: fq.fake_quant(ex, "luq_fp4", "cuda", 7, 2,
                                            flag))(x)
        assert torch.equal(got, fq._quantize_per_example(
            x, "luq_fp4", "cuda", 7, 2, flag))
    assert torch.equal(fq.fake_quant(x, "luq_fp4", "cuda", 7, 2, OFF), x)
    with pytest.raises(ValueError, match="batched"):
        vmap(lambda ex, f: fq.fake_quant(ex, "luq_fp4", "ref", 7, 2, f))(
            x, torch.ones(5))


def test_ghost_norm_flag_zero_is_the_unquantized_norm():
    """``ghost_norm_sq`` at flag 1: its bits without a flag; at flag 0 the
    squared norm of x_b^T g_b of the bf16 operands (the kernel's
    pass-through codes), within 1e-6 of float64 and 1e-5 of the float32
    Grams of ``dp.ghost``."""
    B, T, dx, dg = 3, 8, 24, 16
    x = torch.randn(B, T, dx, generator=_gen(6)).bfloat16()
    g = torch.randn(B, T, dg, generator=_gen(7)).bfloat16()
    kx, kg = fq.stream_key(7, 4), fq.stream_key(7, 5)
    assert torch.equal(ops.ghost_norm_sq(x, g, kx, kg, ON),
                       ops.ghost_norm_sq(x, g, kx, kg))
    off = ops.ghost_norm_sq(x, g, kx, kg, OFF).numpy()
    exact = (x.double().transpose(1, 2) @ g.double()).square().sum((1, 2))
    np.testing.assert_allclose(off, exact.numpy(), rtol=1e-6)
    np.testing.assert_allclose(off, ghost._matpair_sq_norm(x, g).numpy(),
                               rtol=1e-5)


# --------------------------------------------------------------------------- #
# one graph for every policy
# --------------------------------------------------------------------------- #
def _cnn_run():
    model = ModelConfig(name="cnn", family="resnet", resnet_blocks=(1, 1),
                        num_classes=8, image_size=8, compute_dtype="float32")
    return RunConfig(
        model=model, quant=QuantConfig(fmt="luq_fp4", backend="cuda"),
        dp=DPConfig(clip_norm=1.0, noise_multiplier=1.0, microbatch_size=4,
                    quant_fraction=0.4),
        optim=OptimConfig(name="momentum", lr=0.1), global_batch=4,
        steps_per_epoch=2, steps=6)


def test_one_runner_serves_every_policy():
    """Two policies through one ``EpochRunner``: one capture, and each
    call the bits of eager steps of ``step_fn`` under its policy."""
    run = _cnn_run()
    model = build_model(run.model, run.quant, device="cpu")
    setup = build_train_setup(model, run)
    params = model.init(0)
    opt = setup.opt_init_fn(params)
    ds = ImageClassDataset(n=16, num_classes=8, image_size=8)
    batches = {k: v.reshape((2, 4) + v.shape[1:])
               for k, v in ds.get(np.arange(8)).items()}
    lrs = torch.full((2,), 0.1)
    runner = EpochRunner(setup, "cpu", adopt=False)
    for policy in ((1.0, 0.0, 1.0), (0.0, 1.0, 0.0)):
        flags = torch.tensor(policy)
        got_p, got_o, got_m = runner(params, opt, batches, [3, 4], flags,
                                     lrs)
        p, o = params, opt
        for i, seed in enumerate((3, 4)):
            p, o, m = setup.step_fn(p, o, {k: v[i] for k, v in
                                           batches.items()}, seed, flags,
                                    lrs[i])
            assert float(got_m["loss"][i]) == float(m["loss"])
        for a, b in zip(torch.utils._pytree.tree_leaves((got_p, got_o)),
                        torch.utils._pytree.tree_leaves((p, o))):
            assert torch.equal(a, b)
    assert len(runner.captured) == 1


# --------------------------------------------------------------------------- #
# flag on: the host-bool quantized path; flag off: fmt none
# --------------------------------------------------------------------------- #
CASES = {"resnet": "resnet18", "densenet": "densenet121",
         "lm": "stablelm-3b"}


def _clipped_sum(arch, grad_mode, fmt, flags):
    """The clipped gradient sum and losses of one batch of the smoke
    config of ``arch`` under ``flags`` (host bools or a device tensor)."""
    cfg = get_smoke_config(CASES[arch])
    model = build_model(cfg, QuantConfig(fmt=fmt, backend="cuda"),
                        device="cpu")
    params = model.init(1)
    rng = np.random.default_rng(2)
    if arch == "lm":
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))}
    else:
        s = cfg.image_size
        batch = {"image": torch.from_numpy(
            rng.standard_normal((2, s, s, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 10, 2))}
    if grad_mode == "ghost":
        return ghost.ghost_clipped_grad_sum(
            lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h),
            params, batch, clip_norm=1.0,
            hooked_mask=model.ghost_mask(params),
            aux=(model.ghost_aux(flags) if model.ghost_aux else None))

    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)

    return per_example_clipped_grad_sum(loss_one, params, batch,
                                        clip_norm=1.0, microbatch_size=2)


@pytest.mark.parametrize("arch", list(CASES))
@pytest.mark.parametrize("grad_mode", ["vmap", "ghost"])
def test_flags_on_are_the_quantized_path_and_off_fmt_none(arch, grad_mode):
    n = get_smoke_config(CASES[arch]).policy_len()
    on, on_metrics = _clipped_sum(arch, grad_mode, "luq_fp4",
                                  torch.ones(n))
    host, host_metrics = _clipped_sum(arch, grad_mode, "luq_fp4", (True,) * n)
    assert float(on_metrics["loss"]) == float(host_metrics["loss"])
    for name, g in host.items():
        assert torch.equal(on[name], g), name
    off, off_metrics = _clipped_sum(arch, grad_mode, "luq_fp4",
                                    torch.zeros(n))
    plain, plain_metrics = _clipped_sum(arch, grad_mode, "none", (False,) * n)
    np.testing.assert_allclose(float(off_metrics["loss"]),
                               float(plain_metrics["loss"]), rtol=OFF_TOL)
    for name, g in plain.items():
        np.testing.assert_allclose(
            off[name].numpy(), g.numpy(), rtol=OFF_TOL,
            atol=OFF_TOL * float(g.abs().max()), err_msg=name)
    assert not all(torch.equal(on[k], off[k]) for k in on)
