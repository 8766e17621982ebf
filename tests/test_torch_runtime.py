"""PyTorch port vs JAX package: the runtime modules the serving supervisor
drives (heartbeat-file failure detection, straggler detection, elastic
re-meshing), on the cases of ``tests/test_runtime.py``.  Each case runs
on the reference's module and on the port's copy, which must give the
reference's answer and each other's."""
import dataclasses
import time

import pytest

from repro.runtime import elastic as j_elastic
from repro.runtime import heartbeat as j_heartbeat
from repro.runtime import straggler as j_straggler
from repro_torch.runtime import elastic, heartbeat, straggler

IMPLS = {"jax": (j_heartbeat, j_straggler, j_elastic),
         "port": (heartbeat, straggler, elastic)}


def _beat_and_stop(hb, directory, now):
    for hid in range(4):
        hb.Heartbeat(directory, hid).beat(step=10, now=now)
    det = hb.FailureDetector(directory, deadline_s=30.0)
    first = det.dead_hosts(now=now + 1)
    for hid in (0, 1, 3):                      # host 2 stops beating
        hb.Heartbeat(directory, hid).beat(step=20, now=now + 60)
    return (first, det.dead_hosts(now=now + 61),
            det.alive_hosts(now=now + 61))


def _malformed_files(hb, directory, now):
    hb.Heartbeat(directory, 3).beat(step=1, now=now)
    # non-numeric host id, missing id, and unreadable JSON
    (directory / "host_banana.hb").write_text('{"step": 1, "t": 0}')
    (directory / "host_.hb").write_text('{"step": 1, "t": 0}')
    (directory / "host_7.hb").write_text("not json {{{")
    det = hb.FailureDetector(directory, deadline_s=30.0)
    snap = det.snapshot(now=now + 1)
    return sorted(snap), det.alive_hosts(now=now + 1), snap[3]


HEARTBEAT_CASES = {
    "failure_detection": (_beat_and_stop, ([], [2], [0, 1, 3])),
    "malformed_files_skipped": (_malformed_files, None),
}


@pytest.mark.parametrize("case", sorted(HEARTBEAT_CASES))
def test_heartbeat_matches_jax(case, tmp_path):
    fn, want = HEARTBEAT_CASES[case]
    now = time.time()
    got = {}
    for name, impl in IMPLS.items():
        (tmp_path / name).mkdir()
        got[name] = fn(impl[0], tmp_path / name, now)
    assert got["port"] == got["jax"]
    if want is not None:
        assert got["port"] == want
    else:
        assert got["port"][:2] == ([3], [3])


def _slow_host(st):
    det = st.StragglerDetector(alpha=0.5, k_sigma=2.0, patience=2)
    for _ in range(6):
        for hid in range(8):
            det.record(hid, 1.0 if hid != 5 else 3.0)  # host 5 is 3x slower
        det.update_strikes()
    return det


def _even_fleet(st):
    det = st.StragglerDetector(patience=2)
    for _ in range(5):
        for hid in range(4):
            det.record(hid, 1.0)
        det.update_strikes()
    return det


def _single_host(st):
    """A one-host fleet has no fleet stats: never flags, never crashes."""
    det = st.StragglerDetector(patience=1)
    for t in (1.0, 50.0, 1.0, 100.0):
        det.record(0, t)
        det.update_strikes()
    return det


STRAGGLER_CASES = {"slow_host": (_slow_host, [5]),
                   "no_false_positive": (_even_fleet, []),
                   "single_host_fleet": (_single_host, [])}


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_matches_jax(case):
    fn, want = STRAGGLER_CASES[case]
    dets = {name: fn(impl[1]) for name, impl in IMPLS.items()}
    assert dets["port"].stragglers() == dets["jax"].stragglers() == want
    assert {h: dataclasses.astuple(s) for h, s in dets["port"].hosts.items()} \
        == {h: dataclasses.astuple(s) for h, s in dets["jax"].hosts.items()}


def _plan(el, **kw):
    plan = el.plan_remesh(**kw)
    return None if plan is None else dataclasses.asdict(plan)


ELASTIC_CASES = {
    "keeps_tp": (dict(n_chips=512, model_parallel=16, per_replica_batch=8,
                      dataset_size=1_000_000), (32, 16)),
    "keeps_tp_after_loss": (dict(n_chips=448, model_parallel=16,
                                 per_replica_batch=8,
                                 dataset_size=1_000_000), (28, 16)),
    "two_pods": (dict(n_chips=512, model_parallel=16, per_replica_batch=8,
                      dataset_size=1_000_000, pods=2), (2, 16, 16)),
    "one_pod": (dict(n_chips=512, model_parallel=16, per_replica_batch=8,
                     dataset_size=1_000_000, pods=1), (32, 16)),
    "too_many_pods": (dict(n_chips=31, model_parallel=16,
                           per_replica_batch=8, dataset_size=1_000_000,
                           pods=2), None),
}


@pytest.mark.parametrize("case", sorted(ELASTIC_CASES))
def test_plan_remesh_matches_jax(case):
    kw, shape = ELASTIC_CASES[case]
    plans = {name: _plan(impl[2], **kw) for name, impl in IMPLS.items()}
    assert plans["port"] == plans["jax"]
    assert (None if plans["port"] is None
            else tuple(plans["port"]["shape"])) == shape


@pytest.mark.parametrize("start,failures,n_plans", [
    (512, [64, 128, 300], 3), (32, [31], 0)])
def test_degrade_sequence_matches_jax(start, failures, n_plans):
    seqs = {name: [dataclasses.asdict(p) for p in impl[2].degrade_sequence(
        start, 16, 8, 1_000_000, failures=failures)]
        for name, impl in IMPLS.items()}
    assert seqs["port"] == seqs["jax"]
    assert len(seqs["port"]) == n_plans
    with pytest.raises(ValueError, match="pods must be >= 1"):
        elastic.plan_remesh(8, 1, 1, 10, pods=0)
