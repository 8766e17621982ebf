"""PyTorch port vs JAX package: the DPQuant training loop and its host-side
state (repro_torch.train_loop, core, data, dp.accountant, launch.train).

Host-side state is held exactly: the accountant's epsilon for the same
event history, the Poisson sampler's indices and the synthetic dataset's
batches (the same numpy streams), and the scheduler's layer subsets for
the same scores and seed.  The trainer is held end to end at SMOKE size:
at fmt none and sigma = 0, from the JAX package's initial params, the
per-epoch losses follow JAX's within 1e-4 relative; at sigma = 1 the
noise differs (another generator) but epsilon and the number of quantized
layers are the same each epoch, for both epoch executors (scan, the default, and
loop).  The probes restore the model: params and optimizer state are
unchanged after ``maybe_analyze``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import train_loop as jtrain  # noqa: E402
from repro.config import DPConfig as JDPConfig  # noqa: E402
from repro.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.core.policy import singleton_policies as jsingletons  # noqa: E402
from repro.core.scheduler import DPQuantScheduler as JScheduler  # noqa: E402
from repro.data import ImageClassDataset as JDataset  # noqa: E402
from repro.data import PoissonSampler as JSampler  # noqa: E402
from repro.dp.accountant import RDPAccountant as JAccountant  # noqa: E402
from repro_torch import train_loop  # noqa: E402
from repro_torch.config import DPConfig, OptimConfig, QuantConfig, RunConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.policy import singleton_policies  # noqa: E402
from repro_torch.core.scheduler import DPQuantScheduler  # noqa: E402
from repro_torch.data import ImageClassDataset, PoissonSampler  # noqa: E402
from repro_torch.dp.accountant import RDPAccountant  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

torch.set_num_threads(1)

EPOCHS, STEPS, BATCH, N = 2, 2, 8, 64


def test_accountant_epsilon_equals_jax_for_the_same_history():
    events = [(1.0, 0.0625, 30, "train"), (0.5, 0.0078125, 1, "analysis"),
              (1.0, 0.0625, 7, "train"), (0.8, 0.02, 3, "train")]
    ours, theirs = RDPAccountant(), JAccountant()
    for sigma, q, steps, label in events:
        for acc in (ours, theirs):
            acc.step(noise_multiplier=sigma, sample_rate=q, steps=steps,
                     label=label)
        assert ours.get_epsilon(1e-5) == theirs.get_epsilon(1e-5)
    assert ours.analysis_fraction(1e-5) == theirs.analysis_fraction(1e-5)


def test_poisson_indices_and_dataset_batches_are_bitwise_equal():
    ours, theirs = PoissonSampler(1000, 64, seed=3), JSampler(1000, 64, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(ours.sample(), theirs.sample())
    np.testing.assert_array_equal(ours.sample_epoch(4), theirs.sample_epoch(4))
    ds, jds = (cls(n=100, num_classes=43, image_size=8, seed=2)
               for cls in (ImageClassDataset, JDataset))
    idx = ours.sample()[:16] % 100
    got, want = ds.get(idx), jds.get(idx)
    assert got["image"].shape == (16, 8, 8, 3) and got["image"].dtype == torch.float32
    for k in ("image", "label"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mode", ["dpquant", "pls", "static"])
def test_scheduler_picks_the_same_layers_as_jax(mode):
    scores = np.random.default_rng(7).standard_normal(9)
    ours = DPQuantScheduler(n_layers=9, dp=DPConfig(), mode=mode, seed=4)
    theirs = JScheduler(n_layers=9, dp=JDPConfig(), mode=mode, seed=4)
    ours.scores, theirs.scores = scores.copy(), scores.copy()
    for epoch in range(3):
        a, b = ours.select(epoch), theirs.select(epoch)
        assert a.layers == b.layers and len(a) == 8
        assert ours.flags() == tuple(bool(f) for f in np.asarray(b.flags()))
    rng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    assert (selection.select_targets(scores, singleton_policies(9), 10.0, 4,
                                     rng, 9).layers
            == jselection.select_targets(scores, jsingletons(9), 10.0, 4,
                                         jrng, 9).layers)


def _run(sigma, fmt="none", optimizer="sgd", jax_cfg=False, executor="scan"):
    cfg = (jax_smoke_config if jax_cfg else get_smoke_config)("resnet18")
    mk = ((JRunConfig, JQuantConfig, JDPConfig, JOptimConfig) if jax_cfg
          else (RunConfig, QuantConfig, DPConfig, OptimConfig))
    run_cls, quant_cls, dp_cls, optim_cls = mk
    # the JAX trainer's loop is bit-equal to its scan (its own tests)
    kw = {"epoch_executor": "loop" if jax_cfg else executor}
    return run_cls(model=cfg, quant=quant_cls(fmt=fmt),
                   dp=dp_cls(clip_norm=14.5, noise_multiplier=sigma,
                             microbatch_size=BATCH),
                   optim=optim_cls(name=optimizer, lr=0.05),
                   global_batch=BATCH, steps_per_epoch=STEPS,
                   steps=EPOCHS * STEPS, seed=1, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer at sigma 0 and 1: initial params and per-epoch
    (loss, eps, k)."""
    out = {}
    for sigma in (0.0, 1.0):
        ds = JDataset(n=N, num_classes=10, image_size=16, seed=0)
        tr = jtrain.Trainer(_run(sigma, jax_cfg=True), ds, mode="dpquant")
        init = jax.tree.map(np.asarray, tr.params)
        hist = tr.train(EPOCHS)
        out[sigma] = (init, [(h.loss, h.eps, h.quantized_layers)
                             for h in hist])
    return out


def _port_trainer(run, init=None):
    ds = ImageClassDataset(n=N, num_classes=10, image_size=16, seed=0)
    tr = train_loop.Trainer(run, ds, mode="dpquant", device="cpu")
    if init is not None:
        tr.params = params_from_numpy(init, device="cpu")
        tr.opt_state = tr.setup.opt_init_fn(tr.params)
    return tr


def test_trainer_follows_jax_losses_at_sigma_zero(jax_runs):
    init, want = jax_runs[0.0]
    tr = _port_trainer(_run(0.0), init)
    hist = tr.train(EPOCHS)
    assert [h.quantized_layers for h in hist] == [k for _, _, k in want]
    np.testing.assert_allclose([h.loss for h in hist],
                               [loss for loss, _, _ in want], rtol=1e-4)
    assert len(tr.step_wall_s) == EPOCHS * STEPS


def test_trainer_at_sigma_one_has_jax_epsilon_and_k(jax_runs):
    init, want = jax_runs[1.0]
    hist = _port_trainer(_run(1.0), init).train(EPOCHS)
    assert [(h.eps, h.quantized_layers) for h in hist] == \
        [(eps, k) for _, eps, k in want]
    assert all(np.isfinite(h.loss) for h in hist)


def test_loop_executor_follows_jax_too(jax_runs):
    """The tests above run the port's default executor, scan; its per-step
    loop meets the same JAX runs: sigma 0 losses, and sigma 1 epsilon and
    k each epoch."""
    init, want = jax_runs[0.0]
    hist = _port_trainer(_run(0.0, executor="loop"), init).train(EPOCHS)
    np.testing.assert_allclose([h.loss for h in hist],
                               [loss for loss, _, _ in want], rtol=1e-4)
    init, want = jax_runs[1.0]
    hist = _port_trainer(_run(1.0, executor="loop"), init).train(EPOCHS)
    assert [(h.eps, h.quantized_layers) for h in hist] == \
        [(eps, k) for _, eps, k in want]


def test_analysis_leaves_params_and_optimizer_state_unchanged():
    tr = _port_trainer(_run(1.0, fmt="luq_fp4", optimizer="adam"))
    tr.train(1)                                 # a non-trivial Adam state
    params = {k: v.clone() for k, v in tr.params.items()}
    mu = {k: v.clone() for k, v in tr.opt_state.mu.items()}
    count = tr.opt_state.count.clone()
    batches = [tr._to_device(tr.dataset.get(np.arange(BATCH)))] * 2
    assert tr.scheduler.maybe_analyze(
        probe_step=tr._probe_step, params=tr.params, opt_state=tr.opt_state,
        batches=batches, sample_rate=BATCH / N, accountant=tr.accountant,
        epoch=0, seed=3)
    assert all(torch.equal(tr.params[k], v) for k, v in params.items())
    assert all(torch.equal(tr.opt_state.mu[k], v) for k, v in mu.items())
    assert torch.equal(tr.opt_state.count, count)
    assert tr.accountant.total_steps("analysis") == 2


def test_train_cli_raises_without_a_gpu_unless_cpu_is_asked(monkeypatch,
                                                            capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "resnet18", "--smoke"])
    train_cli.main(["--arch", "resnet18", "--smoke", "--device", "cpu",
                    "--epochs", "1", "--steps-per-epoch", "1", "--batch", "4",
                    "--microbatch", "4", "--dataset-size", "32",
                    "--clip-backend", "fused"])
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out and " k=3 acc=" in out
