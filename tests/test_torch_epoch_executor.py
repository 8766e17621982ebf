"""The port's scan epoch executor against its per-step loop, on the CPU.

The counterpart of ``tests/test_epoch_executor.py``.  On the CPU the scan
executor stages the chunk's batches, seeds and learning rates, runs the
step over the same static buffers it captures on CUDA and copies the new
params and optimizer state back into them, with the step called directly
instead of replayed.  Both executors draw the same batches, re-seed the
DP noise generator the same way and take the same learning rates, so on
a fixed seed they agree bitwise: params, optimizer state, losses,
epsilon, the accountant's history and the sampler's next draw.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,  # noqa: E402
                                QuantConfig, RunConfig)
from repro_torch.data.synthetic import ImageClassDataset  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train_loop import Trainer  # noqa: E402

torch.set_num_threads(1)


def small_run(executor="scan", *, chunk=0, steps_per_epoch=3, seed=0,
              optim=OptimConfig(name="adam", lr=0.01, schedule="cosine")):
    model = ModelConfig(name="cnn", family="resnet", resnet_blocks=(1, 1),
                        num_classes=8, image_size=16,
                        compute_dtype="float32")
    return RunConfig(
        model=model, quant=QuantConfig(fmt="luq_fp4"),
        dp=DPConfig(enabled=True, clip_norm=1.0, noise_multiplier=1.0,
                    microbatch_size=8, quant_fraction=0.6,
                    analysis_interval=2, analysis_reps=1,
                    analysis_batch_size=8),
        optim=optim, global_batch=8, steps_per_epoch=steps_per_epoch,
        steps=12, seed=seed, epoch_executor=executor, epoch_chunk=chunk)


def _dataset(n=128):
    return ImageClassDataset(n=n, num_classes=8, image_size=16, noise=0.4)


def train_both(run_a, run_b, epochs=3, mode="dpquant"):
    out = []
    for run in (run_a, run_b):
        tr = Trainer(run, _dataset(), mode=mode, device="cpu")
        out.append((tr, tr.train(epochs)))
    return out


def assert_trees_equal(a, b):
    la = torch.utils._pytree.tree_leaves(a)
    lb = torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_scan_matches_loop_bitwise():
    """Same seed -> identical params, Adam state, losses, epsilon,
    accountant history and sampler stream, over an analysis epoch (interval
    2: epochs 0 and 2) and a cosine schedule.  The scan trainer's probe
    runner (the probe graph's program) gives the loop's eager probes' EMA
    scores, and one epoch program and one probe program serve every
    policy of the run."""
    (tr_loop, hist_loop), (tr_scan, hist_scan) = train_both(
        small_run("loop"), small_run("scan"))
    assert tr_scan.epoch_fn is not None and tr_loop.epoch_fn is None
    assert (tr_scan.scheduler.scores.tolist()
            == tr_loop.scheduler.scores.tolist())
    assert tr_scan.scheduler.n_analyses == 2
    assert len(tr_scan.epoch_fn.captured) == 1
    assert len(tr_scan.probe_fn.captured) == 1
    assert tr_loop.step == tr_scan.step == 9
    assert_trees_equal(tr_loop.params, tr_scan.params)
    assert_trees_equal(tr_loop.opt_state, tr_scan.opt_state)
    assert int(tr_scan.opt_state.count) == 9
    assert [h.loss for h in hist_loop] == [h.loss for h in hist_scan]
    assert [h.quantized_layers for h in hist_loop] == \
        [h.quantized_layers for h in hist_scan]
    assert (tr_loop.accountant.get_epsilon(1e-5)
            == tr_scan.accountant.get_epsilon(1e-5))
    # per-step charges merge into the same history as per-chunk charges
    assert (tr_loop.accountant.total_steps("train")
            == tr_scan.accountant.total_steps("train") == 9)
    assert len(tr_loop.accountant.history) == len(tr_scan.accountant.history)
    np.testing.assert_array_equal(tr_loop.sampler.sample(),
                                  tr_scan.sampler.sample())
    assert len(tr_scan.step_wall_s) == 9
    assert tr_scan.last_capture_s == 0.0          # nothing captured on CPU


def test_chunked_scan_matches_whole_epoch():
    """epoch_chunk bounds the staged batches without changing results."""
    (tr_whole, hist_whole), (tr_chunk, hist_chunk) = train_both(
        small_run("scan", chunk=0, steps_per_epoch=4),
        small_run("scan", chunk=3, steps_per_epoch=4), epochs=2)
    assert_trees_equal(tr_whole.params, tr_chunk.params)
    assert_trees_equal(tr_whole.opt_state, tr_chunk.opt_state)
    assert [h.loss for h in hist_whole] == [h.loss for h in hist_chunk]
    assert (tr_whole.accountant.get_epsilon(1e-5)
            == tr_chunk.accountant.get_epsilon(1e-5))
    # charged once per chunk: 4 + (3, 1) steps, merged into one event
    assert tr_chunk.accountant.total_steps("train") == 8


def test_scan_is_default_and_validated():
    run = small_run("scan")
    assert RunConfig(model=run.model).epoch_executor == "scan"
    assert train_cli.parse_args(["--arch", "resnet18"]).executor == "scan"
    ds = _dataset(64)
    with pytest.raises(ValueError, match="epoch_executor"):
        Trainer(dataclasses.replace(run, epoch_executor="bogus"), ds,
                device="cpu")
    with pytest.raises(NotImplementedError, match="epoch_unroll"):
        Trainer(dataclasses.replace(run, epoch_unroll=2), ds, device="cpu")
    args = train_cli.parse_args(["--arch", "resnet18", "--smoke",
                                 "--executor", "loop", "--epoch-chunk", "2"])
    built = train_cli.build_run(args)
    assert (built.epoch_executor, built.epoch_chunk,
            built.epoch_unroll) == ("loop", 2, 1)


def test_scan_with_dp_disabled():
    run = dataclasses.replace(small_run("scan", optim=OptimConfig(lr=0.5)),
                              dp=DPConfig(enabled=False, quant_fraction=0.6))
    tr = Trainer(run, _dataset(), mode="static", device="cpu")
    hist = tr.train(2)
    assert np.isfinite(hist[-1].loss)
    assert hist[-1].eps == 0.0
    assert tr.accountant.total_steps() == 0


def test_loop_after_scan_and_back_continues_the_same_run():
    """Switching executors between epochs: the scan runner copies state a
    loop epoch left in new tensors back into its static buffers."""
    ds = _dataset()
    ref = Trainer(small_run("loop"), ds, mode="static", device="cpu")
    ref.train(3)
    tr = Trainer(small_run("scan"), ds, mode="static", device="cpu")
    tr.train(1)
    runner = tr.epoch_fn
    tr.epoch_fn = None                            # epoch 1 as a loop
    tr.train(1)
    tr.epoch_fn = runner                          # epoch 2 back on scan
    tr.train(1)
    assert_trees_equal(ref.params, tr.params)
    assert_trees_equal(ref.opt_state, tr.opt_state)
    assert [h.loss for h in ref.history] == [h.loss for h in tr.history]
