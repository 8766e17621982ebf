"""PyTorch port vs JAX package: the serving path at smoke sizes.

The JAX model's params go through numpy into ``convert.params_from_numpy``,
so both sides compute with the same weights in float32 (the smoke configs'
compute dtype).  Tolerances: logits atol = rtol = 1e-4 (float32 through a
few layers, summed in another order); KV codes and scales bitwise; greedy
tokens exact, on inputs whose top-2 logit margin is asserted to exceed
the logits tolerance tenfold, so no argmax can flip within it.  The
luq_fp4 logits head draws from the port's Philox stream (keys (fold,
LOGITS_SEED)), not JAX's threefry, so it is compared with the port's own
oneshot driver (token-identical, on both backends, which draw the same
bits) and, in test_torch_quant_matmul.py, statistically and against the
JAX kernel fed the same draws.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import QuantConfig as JQuant  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.quant import backend as jqb  # noqa: E402
from repro.serve import ContinuousEngine as JEngine  # noqa: E402
from repro_torch.config import QuantConfig, ServeConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as tqb  # noqa: E402
from repro_torch.serve import (ContinuousEngine, build_oneshot_fns,  # noqa: E402
                               oneshot_generate)

torch.set_num_threads(1)

KV_FMTS = ("none", "int8", "luq_fp4")
LOGITS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_backend_override(monkeypatch):
    monkeypatch.delenv(jqb.ENV_VAR, raising=False)
    monkeypatch.delenv(tqb.ENV_VAR, raising=False)


_JAX_MODELS = {}


def jax_model(arch):
    """JAX smoke model and params, built once per arch."""
    if arch not in _JAX_MODELS:
        model = jax_build_model(jax_smoke_config(arch), JQuant(fmt="none",
                                                               backend="ref"))
        # one compiled init (the eager one compiles every op on its own)
        _JAX_MODELS[arch] = (model, jax.jit(model.init)(jax.random.PRNGKey(0)))
    return _JAX_MODELS[arch]


def port_model(arch, fmt="none", backend="cuda"):
    """The port's smoke model on the CPU with the JAX model's weights."""
    _, jparams = jax_model(arch)
    model = build_model(get_smoke_config(arch),
                        QuantConfig(fmt=fmt, backend=backend), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return model, params


def prompt_of(seed, length, vocab):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(
        np.int32)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_params_roundtrip_through_numpy():
    _, jparams = jax_model("yi-6b")
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma-7b"])
@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_prefill_logits_and_cache_match_jax(arch, kv_fmt):
    jmodel, jparams = jax_model(arch)
    model, params = port_model(arch)
    vocab = model.config.vocab_size
    tokens = np.stack([prompt_of(s, 11, vocab) for s in (1, 2)])
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            cache_len=14, kv_fmt=kv_fmt)
    tl, tc = model.prefill(model.prepare(params),
                           {"tokens": torch.from_numpy(tokens)},
                           cache_len=14, kv_fmt=kv_fmt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 11
    assert sorted(tc) == sorted(jc)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in jc:
            continue
        ours, theirs = _np(tc[name]), np.asarray(jc[name], np.float32)
        if kv_fmt == "none":
            np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(ours, theirs)


def _fill_slots(prefill, prompts, cache):
    """Prefill each prompt (B=1) into its slot of a zeroed slot cache."""
    for slot, prompt in enumerate(prompts):
        _, pc = prefill(prompt)
        for name, arr in cache.items():
            if name == "pos":
                arr[slot] = int(pc["pos"])
            else:
                arr[:, slot:slot + 1, :, :pc[name].shape[3]] = pc[name]
    return cache


@pytest.mark.parametrize("arch", ["yi-6b", "gemma-7b"])
@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_teacher_forced_decode_slots_match_jax(arch, kv_fmt):
    """Both decoders start from one slot cache with ragged positions: the
    port's prefills, which the test above holds against JAX's (codes
    bitwise), copied into JAX's cache layout."""
    jmodel, jparams = jax_model(arch)
    model, params = port_model(arch)
    params = model.prepare(params)
    vocab = model.config.vocab_size
    prompts = [prompt_of(10 + i, n, vocab) for i, n in enumerate((5, 9, 3))]
    K, S = len(prompts), 16
    spec = model.slot_cache_spec(K, S, kv_fmt=kv_fmt)
    tcache = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in spec.items()}
    _fill_slots(lambda p: model.prefill(
        params, {"tokens": torch.from_numpy(p[None])}, kv_fmt=kv_fmt),
        prompts, tcache)
    jspec = jmodel.slot_cache_spec(K, S, kv_fmt=kv_fmt)
    assert sorted(jspec) == sorted(tcache)
    jcache = {n: jnp.asarray(_np(tcache[n]).astype(s.dtype))
              for n, s in jspec.items()}
    forced = np.random.default_rng(7).integers(0, vocab, (3, K)).astype(
        np.int32)
    active = np.array([True, True, True])
    jdecode = jax.jit(lambda p, c, t, a: jmodel.decode_slots(p, c, t, a,
                                                             kv_fmt=kv_fmt))
    for tick in range(3):
        tl, tcache = model.decode_slots(params, tcache,
                                        torch.from_numpy(forced[tick]),
                                        active, kv_fmt=kv_fmt)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(forced[tick]),
                             jnp.asarray(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("kv_fmt", ["int8", "luq_fp4"])
def test_decode_slots_with_device_positions_keeps_its_logits(backend,
                                                             kv_fmt):
    """The tick's positions and the head's keys stay on the device: the
    logits equal the trunk's under the head's keys built on the host from
    the positions (one key a slot, as before), bit for bit, and the
    positions of the active slots advance in place."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf

    model, params = port_model("yi-6b", fmt="luq_fp4", backend=backend)
    params = model.prepare(params)
    vocab = model.config.vocab_size
    prompts = [prompt_of(20 + i, n, vocab) for i, n in enumerate((5, 9, 3))]
    K, S = len(prompts), 16
    spec = model.slot_cache_spec(K, S, kv_fmt=kv_fmt)
    cache = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in spec.items()}
    _fill_slots(lambda p: model.prefill(
        params, {"tokens": torch.from_numpy(p[None])}, kv_fmt=kv_fmt),
        prompts, cache)
    before = {n: t.clone() for n, t in cache.items()}
    tokens = torch.tensor([7, 8, 9], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    logits, out = model.decode_slots(params, cache, tokens, active,
                                     kv_fmt=kv_fmt)
    assert out is cache
    assert cache["pos"].tolist() == [6, 9, 4]
    h = tf._decode_trunk(params, before, tokens, before["pos"],
                         model.config, quant=model.quant, kv_fmt=kv_fmt)
    want = cm.qlogits(h, tf._head_t(params, model.config),
                      quant_cfg=model.quant,
                      folds=[2 * p + 1 for p in before["pos"].tolist()])
    assert torch.equal(logits, want)


def test_reset_keeps_the_device_buffers():
    """The decode step's inputs and the cache are zeroed in place by
    ``reset()`` (a captured decode graph holds their addresses), and the
    reset engine reproduces its tokens."""
    model, params = port_model("yi-6b", fmt="luq_fp4")
    engine = ContinuousEngine(model, params,
                              ServeConfig(max_slots=2, max_seq=16,
                                          kv_fmt="int8"), device="cpu")
    vocab = model.config.vocab_size
    rids = [engine.submit(prompt_of(90 + i, 4 + i, vocab), max_new_tokens=3)
            for i in range(3)]
    first = engine.run()
    buffers = {n: t for n, t in engine.cache.items()}
    inputs = (engine._tokens_dev, engine._active_dev)
    engine.reset()
    assert all(engine.cache[n] is t for n, t in buffers.items())
    assert (engine._tokens_dev, engine._active_dev) == inputs
    assert all(not t.any() for t in (*engine.cache.values(), *inputs))
    rids2 = [engine.submit(prompt_of(90 + i, 4 + i, vocab), max_new_tokens=3)
             for i in range(3)]
    again = engine.run()
    assert [again[r].tokens.tolist() for r in rids2] == \
        [first[r].tokens.tolist() for r in rids]


def _greedy_margin(model, params, prompt, gen, kv_fmt):
    """Greedy tokens of one request through the port's prefill/decode_step
    and the smallest top-2 logit margin along the way."""
    prefill, decode = build_oneshot_fns(model, prompt.size + gen, kv_fmt)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(prompt[None])})
    margins = []
    for step in range(gen):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        tok = logits.argmax(-1).to(torch.int32)
        if step < gen - 1:
            logits, cache = decode(params, cache, tok)
    return min(margins)


@pytest.mark.parametrize("kv_fmt", KV_FMTS)
def test_greedy_engine_tokens_match_jax_engine(kv_fmt):
    jmodel, jparams = jax_model("yi-6b")
    model, params = port_model("yi-6b")
    vocab = model.config.vocab_size
    specs = [(3, 6), (9, 3), (5, 4)]               # (prompt_len, gen)
    prompts = [prompt_of(50 + i, pl, vocab) for i, (pl, _) in enumerate(specs)]
    jeng = JEngine(jmodel, jparams, JServe(max_slots=2, max_seq=24,
                                           kv_fmt=kv_fmt))
    teng = ContinuousEngine(model, params, ServeConfig(max_slots=2, max_seq=24,
                                                       kv_fmt=kv_fmt),
                            device="cpu")
    for p, (_, g) in zip(prompts, specs):
        jeng.submit(p, max_new_tokens=g)
        teng.submit(p, max_new_tokens=g)
    jout, tout = jeng.run(), teng.run()
    prepared = model.prepare(params)
    for rid, (p, (_, g)) in enumerate(zip(prompts, specs)):
        assert tout[rid].tokens.tolist() == jout[rid].tokens.tolist()
        assert tout[rid].tokens.size == g
        assert _greedy_margin(model, prepared, p, g, kv_fmt) > 10 * LOGITS_TOL


def _oneshot_tokens(model, params, prompt, gen, kv_fmt):
    prefill, decode = build_oneshot_fns(model, prompt.size + gen, kv_fmt)
    tokens, _ = oneshot_generate(prefill, decode, model.prepare(params),
                                 {"tokens": torch.from_numpy(prompt[None])},
                                 gen)
    return tokens[0].tolist()


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("kv_fmt", ["int8", "luq_fp4"])
def test_engine_matches_oneshot_with_luq_logits(backend, kv_fmt):
    """Quantized logits head: engine and oneshot draw from the same Philox
    key for the same (position, row), so one greedy request is
    token-identical."""
    model, params = port_model("yi-6b", fmt="luq_fp4", backend=backend)
    prompt, gen = prompt_of(1, 7, model.config.vocab_size), 5
    ref = _oneshot_tokens(model, params, prompt, gen, kv_fmt)
    engine = ContinuousEngine(model, params,
                              ServeConfig(max_slots=1, max_seq=prompt.size + gen,
                                          kv_fmt=kv_fmt), device="cpu")
    rid = engine.submit(prompt, max_new_tokens=gen)
    assert engine.run()[rid].tokens.tolist() == ref


def test_prefill_bucketing_bounds_prefill_shapes():
    model, params = port_model("yi-6b")
    max_seq = 32
    engine = ContinuousEngine(model, params,
                              ServeConfig(max_slots=2, max_seq=max_seq),
                              device="cpu")
    lengths = [1, 2, 3, 5, 6, 9, 13, 17, 26]
    vocab = model.config.vocab_size
    rids = [engine.submit(prompt_of(70 + i, n, vocab), max_new_tokens=2)
            for i, n in enumerate(lengths)]
    out = engine.run()
    assert sorted(out) == rids
    assert engine.prefill_programs <= math.ceil(math.log2(max_seq))
    for i in (1, 2):   # padded prefill does not change the tokens
        assert out[rids[i]].tokens.tolist() == _oneshot_tokens(
            model, params, prompt_of(70 + i, lengths[i], vocab), 2, "none")


def test_retire_zeroes_scales_and_reused_slot_is_clean():
    model, params = port_model("yi-6b")
    vocab = model.config.vocab_size
    engine = ContinuousEngine(model, params,
                              ServeConfig(max_slots=1, max_seq=16,
                                          kv_fmt="int8"), device="cpu")
    a = engine.submit(prompt_of(60, 5, vocab), max_new_tokens=4)
    b = engine.submit(prompt_of(61, 7, vocab), max_new_tokens=3)  # reuses slot
    out = engine.run()
    assert engine.pool.admissions == [2]
    assert out[a].tokens.size == 4
    assert (engine.cache["k_scale"] == 0).all()
    assert (engine.cache["v_scale"] == 0).all()
    assert (engine.cache["k"] != 0).any()         # codes stay, scales hide them
    engine.reset()
    b2 = engine.submit(prompt_of(61, 7, vocab), max_new_tokens=3)
    assert engine.run()[b2].tokens.tolist() == out[b].tokens.tolist()


def test_eos_retires_at_its_first_occurrence():
    model, params = port_model("yi-6b")
    prompt, gen = prompt_of(1, 7, model.config.vocab_size), 8
    full = _oneshot_tokens(model, params, prompt, gen, "none")
    # the EOS id is a token whose first occurrence in the stream is index i
    i = next(i for i in range(1, gen) if full[i] not in full[:i])
    engine = ContinuousEngine(model, params,
                              ServeConfig(max_slots=1, max_seq=prompt.size + gen),
                              device="cpu")
    rid = engine.submit(prompt, max_new_tokens=gen, eos_id=full[i])
    assert engine.run()[rid].tokens.tolist() == full[:i + 1]


def test_temperature_sampling_is_deterministic_per_request_and_position():
    model, params = port_model("yi-6b")
    vocab = model.config.vocab_size
    serve = ServeConfig(max_slots=2, max_seq=16, temperature=1.0, seed=3)
    engine = ContinuousEngine(model, params, serve, device="cpu")

    def run():
        engine.reset()
        for i in range(3):
            engine.submit(prompt_of(80 + i, 4, vocab), max_new_tokens=5)
        return [r.tokens.tolist() for _, r in sorted(engine.run().items())]

    first = run()
    assert run() == first
    assert len({tuple(t) for t in first}) > 1
