"""The port's checkpointing (repro_torch.checkpoint): the cases of
``tests/test_checkpoint.py`` on trees of tensors — round trip, CRC,
retention, torn writes, the accountant in the aux payload, asynchronous
writes — plus what the port needs beyond the reference: tensors written
in place right after ``save()`` returns are saved with their values at
the call, bfloat16 leaves and an optimizer state round-trip in their
dtypes, and a failed asynchronous write raises at ``wait()``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import serialization  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.dp.accountant import RDPAccountant  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402


def make_tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "opt": (torch.zeros(3, 4),)}


def leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def test_roundtrip(tmp_path):
    tree = make_tree()
    serialization.save(tmp_path / "c.ckpt", tree, {"step": 7})
    restored, aux = serialization.restore(tmp_path / "c.ckpt", tree)
    for a, b in zip(leaves(restored), leaves(tree)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert aux["step"] == 7


def test_roundtrip_keeps_dtypes_and_the_optimizer_state(tmp_path):
    """bfloat16 crosses as float32 and comes back exactly; an AdamState
    (a NamedTuple of dicts and an int count) keeps its structure."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    tree = {"params": {"w": w.bfloat16(), "b": torch.ones(7)},
            "opt": AdamState(mu={"w": w, "b": torch.zeros(7)},
                             nu={"w": w * w, "b": torch.ones(7)},
                             count=torch.tensor(3, dtype=torch.int32))}
    serialization.save(tmp_path / "c.ckpt", tree)
    like = torch.utils._pytree.tree_map(torch.zeros_like, tree)
    restored, _ = serialization.restore(tmp_path / "c.ckpt", like)
    assert isinstance(restored["opt"], AdamState)
    for a, b in zip(leaves(restored), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_crc_detects_corruption(tmp_path):
    tree = make_tree()
    serialization.save(tmp_path / "c.ckpt", tree)
    payload = (tmp_path / "c.ckpt" / "arrays.npz").read_bytes()
    (tmp_path / "c.ckpt" / "arrays.npz").write_bytes(
        payload[:-8] + b"corrupt!")
    with pytest.raises(IOError):
        serialization.restore(tmp_path / "c.ckpt", tree)


def test_restore_refuses_another_tree(tmp_path):
    serialization.save(tmp_path / "c.ckpt", make_tree())
    other = make_tree()
    other["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(IOError, match="shape"):
        serialization.restore(tmp_path / "c.ckpt", other)
    other = make_tree()
    other["params"]["extra"] = torch.zeros(1)
    with pytest.raises(IOError, match="leaves"):
        serialization.restore(tmp_path / "c.ckpt", other)


def test_manager_retention_and_latest(tmp_path):
    m = CheckpointManager(tmp_path, keep=2, async_write=False)
    tree = make_tree()
    for step in (1, 2, 3, 4):
        t = {"params": {"w": torch.full((3, 4), float(step)),
                        "b": torch.ones(4)},
             "opt": (torch.zeros(3, 4),)}
        m.save(step, t, {"epoch": step})
    assert m.steps() == [3, 4]
    step, restored, aux = m.restore_latest(tree)
    assert step == 4
    assert aux["epoch"] == 4
    assert torch.equal(restored["params"]["w"], torch.full((3, 4), 4.0))


def test_manager_skips_corrupted_latest(tmp_path):
    m = CheckpointManager(tmp_path, keep=5, async_write=False)
    tree = make_tree()
    m.save(1, tree, {"epoch": 1})
    m.save(2, tree, {"epoch": 2})
    npz = tmp_path / "step_0000000002.ckpt" / "arrays.npz"
    npz.write_bytes(b"garbage")
    step, _, aux = m.restore_latest(tree)
    assert step == 1 and aux["epoch"] == 1   # fell back past the corrupted one


def test_accountant_in_aux_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, async_write=False)
    acc = RDPAccountant()
    acc.step(noise_multiplier=1.0, sample_rate=0.01, steps=42)
    acc.step(noise_multiplier=0.5, sample_rate=0.02, steps=1,
             label="analysis")
    m.save(10, make_tree(), {"accountant": acc.state_dict()})
    _, _, aux = m.restore_latest(make_tree())
    acc2 = RDPAccountant.from_state_dict(aux["accountant"])
    assert acc2.get_epsilon(1e-5) == acc.get_epsilon(1e-5)
    assert acc2.history[1].label == "analysis"


def test_torn_write_never_shadows_previous_checkpoint(tmp_path):
    """A writer killed mid-save leaves only a ``step_*.tmp`` staging dir:
    it is not listed as a step, restore falls back to the previous valid
    checkpoint, and a restarted manager sweeps the orphan."""
    m = CheckpointManager(tmp_path, async_write=False)
    tree = make_tree()
    m.save(1, tree, {"epoch": 1})
    torn = tmp_path / "step_0000000002.tmp"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"half-written garbage")
    assert m.steps() == [1]
    step, _, aux = m.restore_latest(tree)
    assert step == 1 and aux["epoch"] == 1
    CheckpointManager(tmp_path, async_write=False)
    assert not torn.exists()
    assert m.steps() == [1]


def test_half_built_destination_is_ignored(tmp_path):
    """A destination dir missing meta.json is not a valid step and never
    masks older checkpoints."""
    m = CheckpointManager(tmp_path, async_write=False)
    tree = make_tree()
    m.save(1, tree, {"epoch": 1})
    bad = tmp_path / "step_0000000002.ckpt"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"junk")
    assert m.steps() == [1]
    step, _, _ = m.restore_latest(tree)
    assert step == 1


def test_failed_save_cleans_staging_dir(tmp_path):
    """An exception mid-serialization removes the .tmp dir and never
    creates the destination."""
    path = tmp_path / "c.ckpt"
    with pytest.raises(TypeError):
        serialization.save(path, make_tree(), {"bad": object()})
    assert not path.exists()
    assert not path.with_suffix(".tmp").exists()


def test_async_write(tmp_path):
    m = CheckpointManager(tmp_path, async_write=True)
    m.save(5, make_tree(), {})
    m.wait()
    assert m.steps() == [5]


def test_async_save_keeps_the_values_at_the_call(tmp_path):
    """The scan executor's params are static buffers that the next replay
    overwrites in place: ``save()`` copies them before it returns, so the
    checkpoint holds the values at the call."""
    m = CheckpointManager(tmp_path, async_write=True)
    tree = make_tree()
    want = [t.clone() for t in leaves(tree)]
    m.save(3, tree, {"epoch": 0})
    for t in leaves(tree):
        t.fill_(-1.0)                      # the next replay's write-back
    m.wait()
    _, restored, _ = m.restore_latest(make_tree())
    for a, b in zip(leaves(restored), want):
        assert torch.equal(a, b)


def test_failed_async_write_raises_at_wait(tmp_path):
    m = CheckpointManager(tmp_path, async_write=True)
    (tmp_path / "step_0000000009.ckpt").write_text("a file, not a dir")
    m.save(9, make_tree(), {})
    with pytest.raises(OSError):
        m.wait()
    m.wait()                               # the error is raised once
