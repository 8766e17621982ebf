"""PyTorch port vs JAX package: the serving engine's failure model, the
supervisor and the serve CLI's chaos mode, at the smoke size of
``tests/test_serve_engine.py`` (2 layers, d_model 32, vocab 64, float32).

Each scenario of ``tests/test_serve_faults.py`` runs on both engines with
the same weights (through numpy), prompts, explicit ``FaultPlan`` events
and injected clock, greedy (JAX's threefry draws cannot be matched), and
the two must agree on every status, token, recovery counter, dead
replica, degraded-event kind, mesh plan and slot cap.  The port's own
contract, at temperature 1.0 with a luq_fp4 logits head on every KV
format: a chaos run with all five fault kinds and the oneshot drain are
token-identical to the fault-free run.  The JAX engines are built once a
slot geometry (module fixtures) and reset between scenarios.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import ServeConfig as JServe  # noqa: E402
from repro.runtime.faults import FaultEvent as JEvent  # noqa: E402
from repro.runtime.faults import FaultPlan as JPlan  # noqa: E402
from repro.runtime.supervisor import DegradeToOneshot as JDegrade  # noqa: E402
from repro.runtime.supervisor import ServeSupervisor as JSupervisor  # noqa: E402
from repro.runtime.supervisor import run_supervised as j_run_supervised  # noqa
from repro.serve import ContinuousEngine as JEngine  # noqa: E402
from repro_torch.config import ModelConfig, QuantConfig, ServeConfig  # noqa
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime import (DegradeToOneshot, FaultEvent,  # noqa: E402
                                 FaultPlan, ServeSupervisor, run_supervised)
from repro_torch.serve import ContinuousEngine  # noqa: E402

from test_serve_engine import make_model, prompt_of, tiny_cfg  # noqa: E402

torch.set_num_threads(1)

SPECS = [(5, 8), (3, 6), (7, 8), (4, 7)]       # (prompt_len, gen)
KV_FMTS = ("none", "int8", "luq_fp4")
COUNTERS = ("faults_injected", "retried", "recovered", "shed",
            "deadline_missed", "degraded_events", "slot_faults",
            "decode_ticks")
# the reference's chaos plan: five distinct kinds
CHAOS = [("prefill_fail", 1, -1, 0), ("decode_fail", 2, -1, 0),
         ("replica_death", 3, 1, 0), ("clock_freeze", 4, -1, 6),
         ("slot_corrupt", 5, 1, 0)]


def ticking_clock(dt=0.05):
    """Deterministic injected clock: advances ``dt`` per read."""
    t = {"v": 0.0}

    def clock():
        t["v"] += dt
        return t["v"]

    return clock


@pytest.fixture(scope="module")
def jax_tiny():
    return make_model()


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    """The port's model of the same config, with the JAX weights."""
    def build(fmt="none"):
        cfg = tiny_cfg()
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        pcfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                              if k in fields})
        model = build_model(pcfg, QuantConfig(fmt=fmt, backend="ref"),
                            device="cpu")
        params = params_from_numpy(jax.tree.map(np.asarray, jax_tiny[1]),
                                   device="cpu")
        return model, params
    return build


@pytest.fixture(scope="module")
def jax_engines(jax_tiny):
    """One JAX engine a (slots, max_seq, kv_fmt): its jitted functions
    compile once; ``get`` resets it with a scenario's knobs."""
    engines = {}

    def get(max_slots, max_seq, kv_fmt="none", faults=None, **knobs):
        serve = JServe(max_slots=max_slots, max_seq=max_seq, kv_fmt=kv_fmt)
        key = (max_slots, max_seq, kv_fmt)
        if key not in engines:
            engines[key] = JEngine(*jax_tiny, serve)
        eng = engines[key]
        eng.serve = dataclasses.replace(serve, **knobs)
        eng.faults, eng.on_tick = faults, None
        eng.reset()
        return eng
    return get


def plans(events, seed=0):
    """The same explicit events as a JAX plan and a port plan."""
    return (JPlan([JEvent(*e) for e in events], seed=seed),
            FaultPlan([FaultEvent(*e) for e in events], seed=seed))


def port_engine(port_tiny, max_slots, max_seq, fmt="none", faults=None,
                **knobs):
    model, params = port_tiny(fmt)
    return ContinuousEngine(model, params, ServeConfig(
        max_slots=max_slots, max_seq=max_seq, **knobs), device="cpu",
        faults=faults)


def assert_same_outcome(jout, tout, jeng, teng):
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert tout[rid].status == jout[rid].status, rid
        assert tout[rid].tokens.tolist() == jout[rid].tokens.tolist(), rid
    # the metrics' counters and each request's record (the reference's
    # summary() raises on a request drained from the queue, see
    # test_oneshot_fallback_matches_jax)
    assert counters(teng.metrics) == counters(jeng.metrics)
    assert teng.slot_cap == jeng.slot_cap
    ts = teng.metrics.summary()
    assert {k: ts[k] for k in COUNTERS} == counters(teng.metrics)[0]


def counters(metrics):
    return ({k: getattr(metrics, k) for k in COUNTERS},
            [(rid, t.status, t.n_generated, t.retries,
              t.admitted is None, t.first_token is None)
             for rid, t in sorted(metrics.timings.items())])


def assert_same_supervision(jsup, tsup):
    assert tsup.dead == jsup.dead
    assert [e["kind"] for e in tsup.events] == \
        [e["kind"] for e in jsup.events]
    assert [e.get("lost") for e in tsup.events] == \
        [e.get("lost") for e in jsup.events]
    assert [None if p is None else dataclasses.asdict(p)
            for p in tsup.plans] == \
        [None if p is None else dataclasses.asdict(p) for p in jsup.plans]


def submit_all(engine, specs=SPECS):
    return [engine.submit(prompt_of(40 + i, pl), max_new_tokens=g)
            for i, (pl, g) in enumerate(specs)]


# --------------------------------------------------------------------------- #
# the reference's scenarios, greedy, port against JAX
# --------------------------------------------------------------------------- #
def _prefill_fail(jeng, teng):
    for eng in (jeng, teng):
        eng.submit(prompt_of(40, SPECS[0][0]), max_new_tokens=SPECS[0][1])
    return jeng.run(), teng.run()


def _retries_exhausted(jeng, teng):
    for eng in (jeng, teng):
        eng.submit(prompt_of(1, 4), max_new_tokens=4)
    return jeng.run(), teng.run()


def _clock_freeze(jeng, teng):
    for eng in (jeng, teng):
        eng.submit(prompt_of(40, SPECS[0][0]), max_new_tokens=SPECS[0][1])
    return jeng.run(clock=ticking_clock()), teng.run(clock=ticking_clock())


def _in_flight_deadline(jeng, teng):
    for eng in (jeng, teng):
        eng.submit(prompt_of(1, 4), max_new_tokens=40)
    return (jeng.run(clock=ticking_clock(0.05)),
            teng.run(clock=ticking_clock(0.05)))


def _queued_deadline(jeng, teng):
    for eng in (jeng, teng):
        eng.submit(prompt_of(1, 4), max_new_tokens=30)
        eng.submit(prompt_of(2, 4), max_new_tokens=4, deadline_s=0.5)
    return (jeng.run(clock=ticking_clock(0.05)),
            teng.run(clock=ticking_clock(0.05)))


def _bounded_queue(jeng, teng):
    for eng in (jeng, teng):
        for i in range(3):
            eng.submit(prompt_of(50 + i, 4), max_new_tokens=3)
    return jeng.run(), teng.run()


# name: (geometry, engine knobs, plan events, runner, expected statuses)
SCENARIOS = {
    "prefill_fail": ((1, 12), {}, [("prefill_fail", 0)], _prefill_fail,
                     ["ok"]),
    "retries_exhausted": ((1, 12), {"max_retries": 1},
                          [("prefill_fail", 0), ("prefill_fail", 1)],
                          _retries_exhausted, ["failed"]),
    "clock_freeze": ((1, 12), {}, [("clock_freeze", 0, -1, 3)],
                     _clock_freeze, ["ok"]),
    "in_flight_deadline": ((1, 64), {"deadline_s": 1.0}, None,
                           _in_flight_deadline, ["timed_out"]),
    "queued_deadline": ((1, 64), {}, None, _queued_deadline,
                        ["ok", "timed_out"]),
    "bounded_queue": ((1, 12), {"max_queue": 1}, None, _bounded_queue,
                      ["ok", "shed", "shed"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_scenario_matches_jax(name, jax_engines, port_tiny):
    (slots, seq), knobs, events, drive, statuses = SCENARIOS[name]
    jplan, tplan = plans(events) if events else (None, None)
    jeng = jax_engines(slots, seq, faults=jplan, **knobs)
    teng = port_engine(port_tiny, slots, seq, faults=tplan, **knobs)
    jout, tout = drive(jeng, teng)
    assert [tout[r].status for r in sorted(tout)] == statuses
    assert_same_outcome(jout, tout, jeng, teng)
    if events:
        assert tplan.log == jplan.log and not tplan.pending


def test_replica_death_through_heartbeat_files_matches_jax(
        tmp_path, jax_engines, port_tiny):
    events = [("replica_death", 1, 2)]
    jplan, tplan = plans(events)
    jeng = jax_engines(2, 16, faults=jplan)
    teng = port_engine(port_tiny, 2, 16, faults=tplan)
    sups = [cls(eng, n_replicas=3, hb_dir=tmp_path / tag, hb_deadline_s=2.0,
                faults=plan)
            for cls, eng, plan, tag in ((JSupervisor, jeng, jplan, "jax"),
                                        (ServeSupervisor, teng, tplan,
                                         "port"))]
    for eng in (jeng, teng):
        submit_all(eng, SPECS[:2])
    jout = jeng.run(clock=ticking_clock(0.5))
    tout = teng.run(clock=ticking_clock(0.5))
    assert_same_outcome(jout, tout, jeng, teng)
    assert_same_supervision(*sups)
    assert sups[1].dead == {2} and teng.slot_cap == 1
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        [f"host_{r}.hb" for r in range(3)]


def test_straggler_replica_is_evicted_as_in_jax(jax_engines, port_tiny):
    """On the real clock: every live replica records the tick's own wall,
    the slowed one 4x of it, so only that one is evicted."""
    events = [("replica_slow", 1, 5, 0, 4.0)]
    jplan, tplan = plans(events)
    jeng = jax_engines(2, 16, faults=jplan)
    teng = port_engine(port_tiny, 2, 16, faults=tplan)
    sups = [cls(eng, n_replicas=16, faults=plan, straggler_patience=2)
            for cls, eng, plan in ((JSupervisor, jeng, jplan),
                                   (ServeSupervisor, teng, tplan))]
    for eng in (jeng, teng):
        submit_all(eng, SPECS[:2])
    assert_same_outcome(jeng.run(), teng.run(), jeng, teng)
    assert_same_supervision(*sups)
    assert sups[1].dead == {5}


@pytest.mark.parametrize("kv_fmt", ["none", "int8"])
def test_chaos_run_matches_jax(kv_fmt, jax_engines, port_tiny):
    """The reference's chaos plan, five kinds, greedy."""
    jplan, tplan = plans(CHAOS, seed=11)
    jeng = jax_engines(2, 16, kv_fmt, faults=jplan, max_retries=5)
    teng = port_engine(port_tiny, 2, 16, faults=tplan, kv_fmt=kv_fmt,
                       max_retries=5)
    sups = [cls(eng, n_replicas=3, faults=plan, slot_fault_threshold=10)
            for cls, eng, plan in ((JSupervisor, jeng, jplan),
                                   (ServeSupervisor, teng, tplan))]
    for eng in (jeng, teng):
        submit_all(eng)
    jout, tout = j_run_supervised(jeng), run_supervised(teng)
    assert all(r.status == "ok" for r in tout.values())
    assert_same_outcome(jout, tout, jeng, teng)
    assert_same_supervision(*sups)
    assert teng.metrics.faults_injected == 5 and not tplan.pending


def test_oneshot_fallback_matches_jax(jax_engines, port_tiny):
    events = [("slot_corrupt", 1, 0), ("slot_corrupt", 2, 1)]
    jplan, tplan = plans(events, seed=5)
    jeng = jax_engines(2, 16, faults=jplan, max_retries=5)
    teng = port_engine(port_tiny, 2, 16, faults=tplan, max_retries=5)
    sups = [cls(eng, faults=plan, slot_fault_threshold=2)
            for cls, eng, plan in ((JSupervisor, jeng, jplan),
                                   (ServeSupervisor, teng, tplan))]
    for eng in (jeng, teng):
        submit_all(eng)
    jout, tout = j_run_supervised(jeng), run_supervised(teng)
    assert sups[1].events[-1]["kind"] == "oneshot_fallback"
    assert all(r.status == "ok" for r in tout.values())
    assert_same_outcome(jout, tout, jeng, teng)
    assert_same_supervision(*sups)


def test_degrade_to_oneshot_propagates_from_run(jax_engines, port_tiny):
    events = [("slot_corrupt", 0, 0)]
    jplan, tplan = plans(events)
    jeng = jax_engines(1, 12, faults=jplan)
    teng = port_engine(port_tiny, 1, 12, faults=tplan)
    for cls, eng, plan, err in ((JSupervisor, jeng, jplan, JDegrade),
                                (ServeSupervisor, teng, tplan,
                                 DegradeToOneshot)):
        cls(eng, faults=plan, slot_fault_threshold=1)
        eng.submit(prompt_of(1, 4), max_new_tokens=4)
        with pytest.raises(err):
            eng.run()
    assert teng.metrics.degraded_events == jeng.metrics.degraded_events == 1


@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_poison_is_the_reference_junk(kv_fmt, jax_engines, port_tiny):
    """``slot_corrupt`` writes the reference's bits into the slot (codes
    wrap in an unsigned array) and zeroes its scales."""
    jeng = jax_engines(2, 16, kv_fmt, faults=JPlan(seed=9))
    teng = port_engine(port_tiny, 2, 16, faults=FaultPlan(seed=9),
                       kv_fmt=kv_fmt)
    jeng._corrupt_slot(JEvent("slot_corrupt", 3, 1), lambda: 0.0)
    teng._corrupt_slot(FaultEvent("slot_corrupt", 3, 1), lambda: 0.0)
    assert sorted(teng.cache) == sorted(jeng.cache)
    for name, arr in teng.cache.items():
        ours = arr.float().numpy() if arr.dtype == torch.bfloat16 \
            else arr.numpy()
        np.testing.assert_array_equal(
            ours, np.asarray(jeng.cache[name]).astype(ours.dtype), name)
    assert teng.cache["k"][:, 1].any() and not teng.cache["k"][:, 0].any()


# --------------------------------------------------------------------------- #
# the port's own contract: recovery never changes tokens
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fault_free(port_tiny):
    """Fault-free tokens of the chaos workload a KV format, at temperature
    1.0 with a luq_fp4 logits head."""
    out = {}
    for kv_fmt in KV_FMTS:
        eng = port_engine(port_tiny, 2, 16, "luq_fp4", temperature=1.0,
                          seed=3, kv_fmt=kv_fmt)
        submit_all(eng)
        out[kv_fmt] = {r: v.tokens.tolist() for r, v in eng.run().items()}
    return out


@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_sampled_chaos_run_is_token_identical_to_fault_free(
        kv_fmt, tmp_path, port_tiny, fault_free):
    _, plan = plans(CHAOS, seed=11)
    eng = port_engine(port_tiny, 2, 16, "luq_fp4", faults=plan,
                      temperature=1.0, seed=3, kv_fmt=kv_fmt, max_retries=5)
    sup = ServeSupervisor(eng, n_replicas=3, hb_dir=tmp_path, faults=plan,
                          slot_fault_threshold=10)
    submit_all(eng)
    out = run_supervised(eng, clock=ticking_clock(0.5))
    assert {r: v.tokens.tolist() for r, v in out.items()} == fault_free[kv_fmt]
    assert all(r.status == "ok" for r in out.values())
    s = eng.metrics.summary()
    assert s["faults_injected"] == 5 and s["recovered"] >= 2
    assert eng.replayed_steps > 0         # a victim's prefix was replayed
    assert sup.dead == {1} and not plan.pending


@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_sampled_oneshot_drain_is_token_identical_to_fault_free(
        kv_fmt, port_tiny, fault_free):
    _, plan = plans([("slot_corrupt", 1, 0), ("decode_fail", 2)], seed=5)
    eng = port_engine(port_tiny, 2, 16, "luq_fp4", faults=plan,
                      temperature=1.0, seed=3, kv_fmt=kv_fmt, max_retries=5)
    sup = ServeSupervisor(eng, faults=plan, slot_fault_threshold=2)
    submit_all(eng)
    out = run_supervised(eng)
    assert sup.events[-1]["kind"] == "oneshot_fallback"
    assert {r: v.tokens.tolist() for r, v in out.items()} == fault_free[kv_fmt]


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_prefill_with_a_device_prompt_len_keeps_its_bits(backend, kv_fmt,
                                                         port_tiny):
    """The graphed prefill's length (a 0-d tensor: the last row gathered
    and the head's key built on the device) gives the int length's
    logits and cache bit for bit; the one row's key is the shared one."""
    model, params = port_tiny("luq_fp4")
    model = build_model(model.config, QuantConfig(fmt="luq_fp4",
                                                  backend=backend),
                        device="cpu")
    params = model.prepare(params)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    tokens[0, :5] = torch.tensor(prompt_of(3, 5))
    want, wcache = model.prefill(params, {"tokens": tokens}, prompt_len=5,
                                 kv_fmt=kv_fmt)
    got, gcache = model.prefill(params, {"tokens": tokens},
                                prompt_len=torch.tensor(5, dtype=torch.int32),
                                kv_fmt=kv_fmt)
    assert torch.equal(got, want)
    assert int(gcache["pos"]) == wcache["pos"] == 5
    for name in wcache:
        if name != "pos":
            assert torch.equal(gcache[name], wcache[name]), name
    with pytest.raises(ValueError, match="batch of one"):
        model.prefill(params, {"tokens": tokens.expand(2, 8)},
                      prompt_len=torch.tensor(5))


def test_engine_makes_one_prefill_step_a_bucket(port_tiny):
    eng = port_engine(port_tiny, 2, 16)
    for n in (1, 2, 3, 5, 7, 9):
        eng.submit(prompt_of(60 + n, n), max_new_tokens=2)
    eng.run()
    assert sorted(eng._prefills) == [2, 4, 8, 16]
    assert eng.prefill_programs == 4 and eng.prefill_replays == 0


# --------------------------------------------------------------------------- #
# the CLI's chaos mode and admission control
# --------------------------------------------------------------------------- #
def test_serve_cli_chaos_mode_writes_its_log(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    log = tmp_path / "faults.json"
    serve_cli.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--kv-fmt", "int8", "--slots", "2", "--requests", "5",
                    "--prompt-len", "6", "--gen", "6", "--fault-seed", "0",
                    "--fault-log", str(log), "--max-queue", "3"])
    out = capsys.readouterr().out
    data = json.loads(log.read_text())
    s = data["summary"]
    assert (f"recovery: {s['faults_injected']} faults injected, "
            f"{s['retried']} retries, {s['recovered']} recovered, "
            f"{s['shed']} shed, {s['deadline_missed']} deadline-missed, "
            f"{s['degraded_events']} degraded events") in out
    assert f"fault log written to {log}" in out
    assert s["shed"] == 2 and out.count(" [shed]: []") == 2
    assert data["seed"] == 0 and len(data["fired"]) + len(data["pending"]) == 4
    assert {e["kind"] for e in data["fired"]} <= {
        "prefill_fail", "decode_fail", "slot_corrupt", "clock_freeze"}
    assert out.count("request ") == 5
