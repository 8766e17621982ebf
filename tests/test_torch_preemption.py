"""The port's preemption-safe DP training: a mid-epoch checkpoint and a
bit-identical resume (repro_torch.runtime, repro_torch.train_loop), the
counterpart of ``tests/test_preemption.py``.

Kill the trainer mid-epoch at a seeded step, restore in a fresh trainer
(or in the preempted one itself), finish the run: params, optimizer
state, per-epoch losses, epsilon and the accountant's history, the
scheduler's state and the sampler's and probe RNG's stream positions all
equal the uninterrupted run's, bit for bit under the vmap engine (loop,
and scan in chunks of 2), within rtol 2e-5, atol 1e-6 under ghost mode
(the reference's tolerance; epsilon and the streams stay exact).  Also:
the handler, the fault plan against the reference's, and the CLI.
"""
import copy
import dataclasses
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import faults as jfaults  # noqa: E402
from repro_torch.config import DPConfig, OptimConfig, RunConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import TokenDataset  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.runtime.faults import FAULT_KINDS, FaultEvent, FaultPlan  # noqa: E402
from repro_torch.runtime.preemption import Preempted, PreemptionHandler  # noqa: E402
from repro_torch.train_loop import Trainer  # noqa: E402

from test_torch_epoch_executor import _dataset, assert_trees_equal, small_run  # noqa: E402

torch.set_num_threads(1)


def preempt_handler(step):
    return PreemptionHandler(
        faults=FaultPlan([FaultEvent(kind="preempt", at=step)]))


def ghost_run():
    """Ghost-mode DP-SGD on the dense-LM smoke config, loop executor, an
    analysis every 2 epochs."""
    return RunConfig(
        model=get_smoke_config("stablelm-3b"),
        dp=DPConfig(microbatch_size=4, grad_mode="ghost", ghost_microbatch=2,
                    quant_fraction=0.5, analysis_interval=2,
                    analysis_reps=1, analysis_batch_size=4),
        optim=OptimConfig(name="sgd", lr=0.5, schedule="cosine"),
        global_batch=4, seq_len=16, steps_per_epoch=4, steps=8,
        epoch_executor="loop")


def make_ds(run):
    if run.model.family == "dense_lm":
        return TokenDataset(n=64, vocab=run.model.vocab_size, seq_len=16)
    return _dataset()


def trainer(run, **kw):
    return Trainer(run, make_ds(run), mode="dpquant", device="cpu", **kw)


def run_uninterrupted(run, epochs=2):
    tr = trainer(run)
    tr.train(epochs)
    return tr


def run_preempted_then_resumed(run, ckpt_dir, at_step, epochs=2):
    """Train until the injected preemption, then resume twice from the
    checkpoint it left: in a fresh trainer (a fresh process: nothing
    carries over but the files) and in the preempted trainer itself."""
    tr1 = trainer(run, checkpoint_dir=ckpt_dir / "a",
                  preemption=preempt_handler(at_step))
    with pytest.raises(Preempted) as exc:
        tr1.train(epochs)
    assert exc.value.step == at_step
    shutil.copytree(ckpt_dir / "a", ckpt_dir / "b")
    tr2 = trainer(run, checkpoint_dir=ckpt_dir / "b")
    tr1.preemption = None
    out = []
    for tr in (tr2, tr1):
        resumed = tr.restore_latest()
        assert resumed is not None
        assert tr._mid_epoch is not None          # the save was mid-epoch
        assert tr.step == at_step
        tr.train(epochs - tr._next_epoch)
        out.append(tr)
    return out


def assert_same_end_state(a: Trainer, b: Trainer, exact=True):
    assert a.step == b.step
    if exact:
        assert_trees_equal(a.params, b.params)
        assert_trees_equal(a.opt_state, b.opt_state)
    else:
        for x, y in zip(torch.utils._pytree.tree_leaves(a.params),
                        torch.utils._pytree.tree_leaves(b.params)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-5,
                                       atol=1e-6)
    # privacy accounting is exact either way: the executors charge at
    # step/chunk boundaries and identical SGM events merge
    assert a.accountant.get_epsilon(1e-5) == b.accountant.get_epsilon(1e-5)
    assert a.accountant.state_dict() == b.accountant.state_dict()
    # per-epoch stats (incl. the interrupted epoch's mean loss)
    assert [h.epoch for h in a.history] == [h.epoch for h in b.history]
    assert ([h.quantized_layers for h in a.history]
            == [h.quantized_layers for h in b.history])
    if exact:
        assert [h.loss for h in a.history] == [h.loss for h in b.history]
        assert ([h.accuracy for h in a.history]
                == [h.accuracy for h in b.history])
    # scheduler EMA / policy / analysis-RNG state
    sa, sb = a.scheduler.state_dict(), b.scheduler.state_dict()
    rng_a, rng_b = sa.pop("rng_state"), sb.pop("rng_state")
    assert sa == sb
    for x, y in zip(rng_a, rng_b):
        np.testing.assert_array_equal(x, y)
    # both RNG streams sit at the same position (drawn from copies: the
    # reference run is compared more than once)
    sampler_a, sampler_b = copy.deepcopy(a.sampler), copy.deepcopy(b.sampler)
    np.testing.assert_array_equal(sampler_a.sample(), sampler_b.sample())
    probe_a, probe_b = copy.deepcopy(a._probe_rng), copy.deepcopy(b._probe_rng)
    np.testing.assert_array_equal(probe_a.randint(0, 1 << 30, 8),
                                  probe_b.randint(0, 1 << 30, 8))


# --------------------------------------------------------------------------- #
# mid-epoch preempt + resume == uninterrupted
# --------------------------------------------------------------------------- #
def test_preempt_resume_bitwise_loop_executor(tmp_path):
    run = small_run("loop", steps_per_epoch=4)
    ref = run_uninterrupted(run)
    for res in run_preempted_then_resumed(run, tmp_path, at_step=6):
        assert_same_end_state(ref, res)


def test_preempt_resume_bitwise_scan_executor(tmp_path):
    """The scan executor polls at chunk boundaries; resuming re-runs only
    the remaining chunks of the interrupted epoch.  Step 10 lands in
    epoch 2, an analysis epoch (interval 2): the resume must not re-run
    analysis or selection (that would draw the probe and scheduler
    streams again and charge the budget twice).  The preempted trainer,
    restored in place, copies the restored tensors into the static buffers
    its runner already holds."""
    run = small_run("scan", chunk=2, steps_per_epoch=4)
    ref = run_uninterrupted(run, epochs=3)
    fresh, in_place = run_preempted_then_resumed(run, tmp_path, at_step=10,
                                                 epochs=3)
    assert fresh.last_analysis_s == in_place.last_analysis_s == 0.0
    for res in (fresh, in_place):
        assert_same_end_state(ref, res)


def test_preempt_resume_ghost_engine(tmp_path):
    """The same under the ghost-norm engine on the dense-LM smoke config
    (rtol 2e-5, atol 1e-6; epsilon and the RNG positions exact)."""
    run = ghost_run()
    ref = run_uninterrupted(run)
    for res in run_preempted_then_resumed(run, tmp_path, at_step=6):
        assert_same_end_state(ref, res, exact=False)


def test_end_of_epoch_checkpoint_resumes_at_the_next_epoch(tmp_path):
    run = small_run("scan", steps_per_epoch=2)
    ref = run_uninterrupted(run, epochs=2)
    tr1 = trainer(run, checkpoint_dir=tmp_path)
    tr1.train(1)
    tr1.ckpt.wait()
    tr2 = trainer(run, checkpoint_dir=tmp_path)
    assert tr2.restore_latest() == 0
    assert tr2._mid_epoch is None and tr2._next_epoch == 1
    tr2.train(1)
    assert_same_end_state(ref, tr2)


def test_mid_epoch_checkpoint_guards_epoch_mismatch(tmp_path):
    run = small_run("loop", steps_per_epoch=4)
    tr1 = trainer(run, checkpoint_dir=tmp_path, preemption=preempt_handler(6))
    with pytest.raises(Preempted):
        tr1.train(2)
    tr2 = trainer(run, checkpoint_dir=tmp_path)
    tr2.restore_latest()
    # the mid-epoch record is for epoch 1; any other epoch must refuse
    with pytest.raises(RuntimeError):
        tr2.train_epoch(0)
    # and the record survives the refusal, so the correct resume still runs
    stats = tr2.train_epoch(1)
    assert stats.epoch == 1


# --------------------------------------------------------------------------- #
# PreemptionHandler and FaultPlan
# --------------------------------------------------------------------------- #
def test_handler_fault_events_latch_and_clear():
    h = preempt_handler(3)
    assert not h.should_preempt(2)
    assert h.should_preempt(5)       # <= semantics: skipped steps still fire
    assert h.should_preempt(6)       # latched until cleared
    h.clear()
    assert not h.should_preempt(7)   # event already consumed


def test_handler_request_flag():
    h = PreemptionHandler()
    assert not h.should_preempt(0)
    h.request()
    assert h.requested and h.should_preempt(1)


def test_handler_signal_install_uninstall():
    h = PreemptionHandler()
    prev = signal.getsignal(signal.SIGUSR1)
    h.install(signals=(signal.SIGUSR1,))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.requested
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is prev


@pytest.mark.parametrize("seed,kinds,n_faults", [
    (0, FAULT_KINDS, None), (7, ("preempt",), 5),
    (123, ("decode_fail", "replica_slow", "clock_freeze"), 9)])
def test_fault_plan_generate_equals_the_reference(seed, kinds, n_faults):
    kw = dict(kinds=kinds, horizon=50, n_faults=n_faults, n_slots=4,
              n_replicas=3)
    mine = FaultPlan.generate(seed, **kw)
    theirs = jfaults.FaultPlan.generate(seed, **kw)
    assert ([dataclasses.asdict(e) for e in mine.pending]
            == [dataclasses.asdict(e) for e in theirs.pending])
    for at in range(0, 50, 7):
        for kind in kinds:
            assert ([dataclasses.asdict(e) for e in mine.take(kind, at)]
                    == [dataclasses.asdict(e)
                        for e in theirs.take(kind, at)])
    assert mine.log == theirs.log
    assert mine.log_json() == theirs.log_json()


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
def test_cli_preempt_and_resume(tmp_path, capsys, monkeypatch):
    """``--preempt-at 2 --checkpoint-dir d`` exits cleanly after a
    mid-epoch checkpoint; the rerun prints the resume line and ends with
    the uninterrupted run's final line."""
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    argv = ["--arch", "resnet18", "--smoke", "--device", "cpu", "--epochs",
            "2", "--steps-per-epoch", "3", "--batch", "8", "--microbatch",
            "8", "--dataset-size", "256", "--epoch-chunk", "2"]
    train_cli.main(argv)
    want = capsys.readouterr().out.splitlines()
    ckpt = ["--checkpoint-dir", str(tmp_path)]
    train_cli.main(argv + ckpt + ["--preempt-at", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out == ["preempted at step 2; checkpoint written — rerun to "
                   "resume"]
    train_cli.main(argv + ckpt)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from checkpoint at epoch 0 (mid-epoch)"
    assert out[1:] == want
