"""Serving on the ``model`` mesh axis in the port (tensor parallelism of
the dense LMs, expert parallelism of the MoE LMs) against one process and
the JAX package, on the CPU over gloo.

In this process:

* layout: the port's KV cache (``kv_cache_axes``) and params
  (``param_axes``) under the rules of yi-6b, gemma-7b and arctic-480b,
  FULL and SMOKE, on the production meshes (16, 16) and (2, 16, 16),
  equal the reference's ``assign_spec`` leaf by leaf; the cache's split
  (``serve.layout.cache_split``) is its heads where they divide the axis
  and its sequence rows (``kv_seq``) where they do not;
* the split logits head: the plain ``luq_matmul`` on a vocab shard, with
  the whole head's scale, quantizes the shard as the slice of the whole
  head's quantized operand, bit for bit, and its products lie within
  1e-6 relative of the whole head's columns (one shared key, and one key
  a row);
* the sequence-split cache: ``kv_write`` of a tick's rows and of a
  prompt's rows into each shard is the whole cache's slice, bit for bit,
  the rows a shard does not hold untouched; the partial attention over
  each shard merged over the shards is the whole cache's attention
  within 1e-6 (int8, luq_fp4, none; the kernels' plain versions and the
  ``ref`` backend), a shard wholly past a slot's position included;
* ``make_host_mesh`` raises on a degree that does not divide the world.

Three launches run at once, while this process computes the one-process
and JAX references (``_RANK_SCRIPT``): two ranks as a (1, 2) mesh, four
ranks as a (1, 4) mesh, and ``launch.serve --model-parallel 2`` under
``torch.distributed.run``.  On them, in float32:

* the sharded prefill and decode logits of stablelm-3b and yi-6b on 2
  ranks (the cache split by heads), yi-6b on 4 ranks (its 2 KV heads do
  not divide: the cache split by rows) and arctic-480b's oneshot on 2
  ranks equal one process's at rtol 2e-4 / atol 2e-5 at fmt none, every
  rank holding the same gathered logits; yi-6b's also the JAX package's
  ``prefill`` / ``decode_step`` on the same params (``convert.py``);
* the luq_fp4 head within ``LUQ_LIMIT`` of one process's, and a control
  (rank 1 keyed from another seed) beyond it;
* ``ContinuousEngine`` on 2 ranks, its cache split by heads and then by
  rows (a ``sharding_overrides`` rule): the same greedy tokens on both
  ranks and as the one-process engine; ``build_serve_setup`` gives a
  rank's shapes; the supervisor raises on a model group;
* the CLI on 2 ranks prints one process's tokens.
"""
import os
import pickle
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.parallel import partitioner as jpt  # noqa: E402
from repro_torch.config import QuantConfig, ServeConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (_flatten, params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import partitioner as pt  # noqa: E402
from repro_torch.quant import kv_cache as kvc  # noqa: E402
from repro_torch.quant import philox  # noqa: E402
from repro_torch.quant.formats import luq_fp4  # noqa: E402
from repro_torch.serve import ContinuousEngine  # noqa: E402
from repro_torch.serve.layout import cache_split  # noqa: E402
from repro_torch.serve.oneshot import build_oneshot_fns  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, GEN = 2, 9, 4             # prompts, prompt length, generated steps
CACHE = 16                      # cache rows: 4 a rank on 4 ranks
TOL = dict(rtol=2e-4, atol=2e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)     # test_torch_serve.py's LOGITS_TOL
# relative L2 of the sharded luq_fp4 logits against one process's: three
# times the CPU reading (1.9e-7: float32 order; the head's shards are the
# whole head's columns bit for bit, the trunk's row-parallel sums round in
# another order); the control reads 0.36
LUQ_LIMIT = 6e-7
KV_FMTS = ("none", "int8", "luq_fp4")
# (name, arch, ranks, kv_fmt): the oneshot cases against one process
CASES = ([(f"{a} {m} {k}", a, m, k) for a in ("stablelm-3b", "yi-6b")
          for m in (2,) for k in KV_FMTS]
         + [(f"yi-6b 4 {k}", "yi-6b", 4, k) for k in KV_FMTS]
         + [("arctic-480b 2 none", "arctic-480b", 2, "none")])
ENGINE_PROMPTS = (5, 12, 3, 9, 7)        # prompt lengths, 3 slots
ENGINE_SEQ, ENGINE_GEN = 16, 5
CLI_ARGV = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--quant-fmt",
            "luq_fp4", "--kv-fmt", "int8", "--slots", "2", "--requests",
            "3", "--prompt-len", "6", "--gen", "4"]


# --------------------------------------------------------------------------- #
# in this process: layouts, the split head, the split cache
# --------------------------------------------------------------------------- #
class FakeMesh:
    """Duck-typed mesh (axis_names + devices.shape), as the reference's
    partitioner test has it."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


def _axes_leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _axes_leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", tuple(value)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma-7b", "arctic-480b"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_cache_and_param_layouts_match_jax(arch, size):
    jcfg = jax_config(arch) if size == "full" else jax_smoke(arch)
    cfg = get_config(arch) if size == "full" else get_smoke_config(arch)
    jmodel = jax_build_model(jcfg, JQuantConfig(fmt="none"))
    jshapes = {k: tuple(v.shape) for k, v in _flatten(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))}
    jmod = jmoe if jcfg.family == "moe_lm" else jtfm
    jaxes = dict(_axes_leaves(jmod.param_axes(jcfg)))
    model = build_model(cfg, device="cpu")
    rules = pt.merge_rules(pt.DEFAULT_RULES, cfg.sharding_overrides)
    jrules = jpt.merge_rules(jpt.DEFAULT_RULES, jcfg.sharding_overrides)
    batch, seq = 128, 32_768
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        fake = FakeMesh(mesh.devices.shape, mesh.axis_names)
        specs = pt.tree_specs(model.param_axes(), jshapes, mesh, rules)
        for name, shape in jshapes.items():
            assert tuple(specs[name]) == tuple(jpt.assign_spec(
                jaxes[name], shape, fake, jrules)), (name, multi)
        for kv_fmt in ("none", "int8"):
            axes = model.cache_axes(kv_fmt)
            assert axes == jtfm.kv_cache_axes(jcfg, kv_fmt)
            with_axes = {k: v for k, v in axes.items() if v is not None}
            L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
            shapes = {k: (L, batch, KV, seq, hd)[:len(v)]
                      for k, v in with_axes.items()}
            got = pt.tree_specs(with_axes, shapes, mesh, rules)
            for name, shape in shapes.items():
                want = jpt.assign_spec(with_axes[name], shape, fake, jrules)
                assert tuple(got[name]) == tuple(want), (name, multi)
            split = cache_split(model, mesh, rules, batch, seq, kv_fmt)
            model_dims = [a for a, e in zip(axes["k"], got["k"])
                          if "model" in pt.entry_axes(e)]
            assert [split] == (model_dims or [None])
            # a rank's cache is its local_slice: heads where they divide
            degree = mesh.shape["model"]
            assert split == ("kv_heads" if KV % degree == 0 else "kv_seq")
            local = pt.local_shape(pt.param_spec(got["k"]), shapes["k"],
                                   mesh)
            assert local[2:4] == ((KV // degree, seq) if split == "kv_heads"
                                  else (KV, seq // degree))


def test_sharding_overrides_move_the_cache_to_kv_seq():
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg, device="cpu")
    mesh = FakeMesh((1, 2), ("data", "model"))
    rules = pt.DEFAULT_RULES
    assert cache_split(model, mesh, rules, 4, 16) == "kv_heads"
    moved = pt.merge_rules(rules, (("kv_heads", ()),))
    assert cache_split(model, mesh, moved, 4, 16) == "kv_seq"
    assert cache_split(model, mesh, moved, 4, 15) is None


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("keys", ["shared", "per_row"])
def test_split_head_is_the_whole_heads_slice(parts, keys):
    gen = torch.Generator().manual_seed(parts)
    K, N, R = 24, 96, 3
    b = torch.randn(K, N, generator=gen)
    a = torch.randn(R, K, generator=gen)
    key = (21, 17)
    kk = key if keys == "shared" else [(2 * p + 1, 17) for p in (3, 5, 8)]
    alpha_b = b.abs().amax()
    alpha_a = a.abs().amax() if keys == "shared" else a.abs().amax(dim=1)
    whole = ops.luq_matmul(a, b, kk, alpha_a, alpha_b)
    eye = torch.eye(K)
    n = N // parts
    for i in range(parts):
        cols = slice(i * n, (i + 1) * n)
        shard = b[:, cols].contiguous()
        # the group's MAX of the shards' maxima is the whole head's scale
        alpha = torch.stack([b[:, j * n:(j + 1) * n].abs().amax()
                             for j in range(parts)]).amax()
        assert torch.equal(alpha, alpha_b)
        # one-hot rows quantize exactly: the product is Q(b)'s rows
        qb = ref.luq_matmul_keys_ref(eye, shard, key, torch.ones(()), alpha,
                                     cols=(i * n, N))
        ub = philox.uniforms_2d(key, 1, K, N, N, 0)
        assert torch.equal(qb, luq_fp4(b, ub, alpha_b)[:, cols])
        got = ops.luq_matmul(a, shard, kk, alpha_a, alpha, cols=(i * n, N))
        torch.testing.assert_close(got, whole[:, cols], rtol=1e-6,
                                   atol=1e-6 * whole.abs().max().item())


def _kv_inputs(fmt, gen, n0=3, n1=2, s=128, hd=8):
    codes = [torch.randint(-100, 100, (n0, n1, s, kvc.code_spec(fmt, hd)[1]),
                           generator=gen).to(kvc.code_spec(fmt, hd)[0]
                                             or torch.float32)
             for _ in range(2)]
    scales = ([(torch.rand(n0, n1, s, generator=gen) * 5).to(kvc.SCALE_DTYPE)
               for _ in range(2)] if fmt != "none" else [None, None])
    return codes + scales


@pytest.mark.parametrize("fmt", KV_FMTS)
@pytest.mark.parametrize("parts", [2, 4])
def test_sequence_split_kv_write_is_the_whole_caches_slice(fmt, parts):
    gen = torch.Generator().manual_seed(7)
    n0, n1, s, hd = 3, 2, 128, 8
    stale = _kv_inputs(fmt, gen, n0, n1, s, hd)
    rows = s // parts
    for wpos, t in ((torch.tensor([5, 70, 140]), 1), (None, 100)):
        k = torch.randn(n0, n1, t, hd, generator=gen)
        v = torch.randn(n0, n1, t, hd, generator=gen)
        whole = [None if c is None else c.clone() for c in stale]
        kvc.kv_write(fmt, k, v, *whole, wpos)
        for r in range(parts):
            sl = slice(r * rows, (r + 1) * rows)
            shard = [None if c is None else c[:, :, sl].clone()
                     for c in stale]
            ref.kv_quant_write_ref(k, v, *shard, fmt, wpos, r * rows, s)
            for got, want in zip(shard, whole):
                if got is not None:
                    assert torch.equal(got, want[:, :, sl]), (r, wpos)
            if fmt != "none":
                again = [c[:, :, sl].clone() for c in stale]
                ops.kv_quant_write(k, v, *again, fmt, wpos, r * rows, s)
                assert all(torch.equal(a, b) for a, b in zip(again, shard))


@pytest.mark.parametrize("fmt", KV_FMTS)
@pytest.mark.parametrize("parts", [2, 4])
def test_sequence_split_attention_merges_to_the_whole_caches(fmt, parts):
    gen = torch.Generator().manual_seed(11 + parts)
    Bq, KV, g, s, hd = 3, 2, 4, 128, 8
    xk = torch.randn(Bq, KV, s, hd, generator=gen)
    xv = torch.randn(Bq, KV, s, hd, generator=gen)
    kc, ks = kvc.kv_quant(fmt, xk)
    vc, vs = kvc.kv_quant(fmt, xv)
    q = torch.randn(Bq, KV * g, hd, generator=gen)
    # a slot in the first shard alone, one in the middle, one past the end
    pos = torch.tensor([5, s // 2 + 3, s + 7], dtype=torch.int32)
    scale = hd ** -0.5
    want = kvc.ref_decode_attn(fmt, q, kc, vc, ks, vs, pos, n_kv=KV,
                               scale=scale)
    rows = s // parts
    parts_ref, parts_kernel = [], []
    for r in range(parts):
        sl = slice(r * rows, (r + 1) * rows)
        sh = [None if t is None else t[:, :, sl].contiguous()
              for t in (kc, vc, ks, vs)]
        parts_ref.append(kvc.ref_decode_attn_partial(
            fmt, q, *sh, pos, n_kv=KV, scale=scale, row0=r * rows))
        if fmt != "none":
            parts_kernel.append(ops.decode_attn_split(
                q, *sh, pos, fmt=fmt, n_kv=KV, scale=scale, row0=r * rows,
                seq_len=s))
    got = kvc.attn_merge(torch.stack(parts_ref)).reshape(Bq, KV * g, hd)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if fmt != "none":
        got = ops.decode_attn_merge(torch.stack(parts_kernel), pos, batch=Bq,
                                    n_kv=KV, group=g, head_dim=hd, rows=rows,
                                    seq_len=s)
        torch.testing.assert_close(got, ref.decode_attn_ref(
            q, kc, vc, ks, vs, pos, fmt=fmt, n_kv=KV, scale=scale),
            rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_make_host_mesh_raises_on_a_degree_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(2)
    assert make_host_mesh(1).shape == {"data": 1, "model": 1}


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #
_RANK_SCRIPT = textwrap.dedent('''
    import contextlib, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.config import QuantConfig, RunConfig, ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import (init_distributed, make_compat_mesh,
                                         make_host_mesh)
    from repro_torch.launch.steps import build_serve_setup
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import partitioner as pt
    from repro_torch.runtime.supervisor import ServeSupervisor
    from repro_torch.serve import ContinuousEngine
    from repro_torch.serve.layout import serve_layout
    from repro_torch.serve.oneshot import build_oneshot_fns

    inp = pickle.load(open(sys.argv[1], "rb"))
    spawn = sys.argv[3]
    init_distributed("cpu")
    rank = dist.get_rank()
    world = dist.get_world_size()
    mesh = make_compat_mesh((1, world), ("data", "model"))
    out = {"checks": {}, "logits": {}, "tokens": {}}

    def check(name, ok):
        out["checks"][name] = bool(ok)

    @contextlib.contextmanager
    def other_key(on):
        """The logits head keyed from another seed (a control)."""
        seed = cm.LOGITS_SEED
        if on:
            cm.LOGITS_SEED = seed + 7919
        try:
            yield
        finally:
            cm.LOGITS_SEED = seed

    def oneshot(arch, fmt, kv_fmt, control=False):
        cfg = get_smoke_config(arch)
        model = build_model(cfg, QuantConfig(fmt=fmt, backend="cuda"),
                            device="cpu")
        params = params_from_numpy(inp["params"][arch], device="cpu")
        layout = serve_layout(model, mesh, {k: tuple(v.shape) for k, v in
                                            params.items()},
                              inp["B"], inp["cache"], kv_fmt)
        prefill, decode = build_oneshot_fns(model, inp["cache"], kv_fmt,
                                            layout=layout)
        local = model.prepare(layout.shard(params))
        tokens = torch.from_numpy(inp["tokens"][arch])
        logits = []
        with other_key(control and layout.model_axis.index == 1):
            lg, cache = prefill(local, {"tokens": tokens})
            logits.append(lg)
            for t in inp["feed"][arch]:
                lg, cache = decode(local, cache, torch.from_numpy(t))
                logits.append(lg)
        return torch.stack(logits), layout, cache

    def same_on_every_rank(t):
        hi = t.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        lo = -t
        dist.all_reduce(lo, op=dist.ReduceOp.MAX)
        return torch.equal(hi, t) and torch.equal(-lo, t)

    for name, arch, ranks, kv_fmt in inp["cases"]:
        if ranks != world:
            continue
        logits, layout, cache = oneshot(arch, "none", kv_fmt)
        out["logits"][name] = logits
        check(f"{name}: every rank holds the gathered logits",
              same_on_every_rank(logits))
        out.setdefault("kv_split", {})[name] = layout.kv_split
        cfg = get_smoke_config(arch)
        want_rows = inp["cache"] // (world if layout.kv_split == "kv_seq"
                                     else 1)
        want_kv = cfg.n_kv_heads // (world if layout.kv_split == "kv_heads"
                                     else 1)
        check(f"{name}: the cache is this rank's shard",
              tuple(cache["k"].shape[2:4]) == (want_kv, want_rows))

    if spawn == "two":
        for control in (False, True):
            logits, _, _ = oneshot("yi-6b", "luq_fp4", "int8", control)
            out["logits"]["yi-6b luq_fp4" + (" control" if control
                                             else "")] = logits
        # the engine: greedy, the luq_fp4 head and an int8 cache
        cfg = get_smoke_config("yi-6b")
        model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"),
                            device="cpu")
        params = params_from_numpy(inp["params"]["yi-6b"], device="cpu")
        serve = ServeConfig(max_slots=3, max_seq=inp["engine_seq"],
                            max_new_tokens=inp["engine_gen"], kv_fmt="int8")
        # the cache split by heads (the rules' choice), then by rows (a
        # sharding_overrides rule moves it)
        import dataclasses
        for split, c in (("kv_heads", cfg), ("kv_seq", dataclasses.replace(
                cfg, sharding_overrides=(("kv_heads", ()),)))):
            engine = ContinuousEngine(
                build_model(c, QuantConfig(fmt="luq_fp4", backend="cuda"),
                            device="cpu"), params, serve, device="cpu",
                mesh=mesh)
            check(f"engine: the cache split by {split}",
                  engine.layout.kv_split == split)
            for p in inp["engine_prompts"]:
                engine.submit(p)
            res = engine.run()
            out["tokens"][f"engine {split}"] = {r: v.tokens.tolist()
                                                for r, v in res.items()}
        check("engine: no graph on the CPU",
              engine.decode_replays == 0 and engine.prefill_replays == 0
              and not engine._eager)
        check("engine: holds its shard",
              engine.params["blocks.wq"].shape[2] * world
              == cfg.padded_heads)
        try:
            ServeSupervisor(engine)
            check("supervisor raises on a model group", False)
        except NotImplementedError:
            check("supervisor raises on a model group", True)
        # build_serve_setup on the mesh: this rank's shapes
        run = RunConfig(model=cfg, quant=QuantConfig(fmt="luq_fp4"),
                        global_batch=4, seq_len=16)
        setup = build_serve_setup(model, run, mesh, 4, 16, "int8")
        p, cache, tok = setup.decode_abstract
        check("build_serve_setup: the rank's params and cache",
              p["blocks.wq"].shape[2] * world == cfg.padded_heads
              and cache["k"].shape[2] * world == cfg.n_kv_heads
              and tok.shape == (4,) and setup.layout.kv_split == "kv_heads")
        local = setup.shard(params)
        lg, _ = setup.prefill_fn(model.prepare(local), {
            "tokens": torch.from_numpy(inp["tokens"]["yi-6b"])})
        check("build_serve_setup: its prefill runs on the shards",
              lg.shape == (inp["B"], cfg.padded_vocab))
    else:
        try:
            make_host_mesh(3)
            check("make_host_mesh(3) raises on 4 ranks", False)
        except ValueError:
            check("make_host_mesh(3) raises on 4 ranks", True)
    pickle.dump(out if rank == 0 else {"checks": out["checks"],
                                       "tokens": out["tokens"]},
                open(sys.argv[2], "wb"))
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **extra)


def _spawn(script, path, out_dir, name, world):
    env = _env(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    return [subprocess.Popen(
        [sys.executable, str(script), str(path), str(out_dir / f"{name}{r}"),
         name], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _oneshot(params, arch, fmt, kv_fmt, tokens, feed):
    """One process's prefill and decode logits."""
    model = build_model(get_smoke_config(arch),
                        QuantConfig(fmt=fmt, backend="cuda"), device="cpu")
    prefill, decode = build_oneshot_fns(model, CACHE, kv_fmt)
    p = model.prepare(params_from_numpy(params, device="cpu"))
    lg, cache = prefill(p, {"tokens": torch.from_numpy(tokens)})
    out = [lg]
    for t in feed:
        lg, cache = decode(p, cache, torch.from_numpy(t))
        out.append(lg)
    return torch.stack(out)


def _jax_logits(jparams, tokens, feed):
    """The JAX package's yi-6b prefill and decode_step logits."""
    jmodel = jax_build_model(jax_smoke("yi-6b"), JQuantConfig(fmt="none",
                                                              backend="ref"))
    lg, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                               cache_len=CACHE)
    out = [np.asarray(lg)]
    for t in feed:
        lg, cache = jmodel.decode_step(jparams, cache, jnp.asarray(t))
        out.append(np.asarray(lg))
    return np.stack(out)


def _engine_tokens(params, prompts):
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"),
                        device="cpu")
    engine = ContinuousEngine(
        model, params_from_numpy(params, device="cpu"),
        ServeConfig(max_slots=3, max_seq=ENGINE_SEQ,
                    max_new_tokens=ENGINE_GEN, kv_fmt="int8"), device="cpu")
    for p in prompts:
        engine.submit(p)
    return {r: v.tokens.tolist() for r, v in engine.run().items()}


def _cli_requests(text: str) -> dict:
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^request (\d+): (\[.*\])$", text, re.M)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mp")
    # yi-6b from the JAX package's init (the JAX comparison), the others
    # from the port's
    jmodel = jax_build_model(jax_smoke("yi-6b"), JQuantConfig(fmt="none",
                                                              backend="ref"))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = {"yi-6b": jax.tree.map(np.asarray, jparams)}
    tokens, feed = {}, {}
    for i, arch in enumerate(("stablelm-3b", "arctic-480b", "yi-6b")):
        cfg = get_smoke_config(arch)
        if arch != "yi-6b":
            params[arch] = params_to_numpy(build_model(
                cfg, QuantConfig(fmt="none"), device="cpu").init(i))
        rng = np.random.default_rng(i)
        tokens[arch] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
        feed[arch] = [rng.integers(0, cfg.vocab_size, (B,)).astype(np.int64)
                      for _ in range(GEN)]
    rng = np.random.default_rng(9)
    vocab = get_smoke_config("yi-6b").vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in ENGINE_PROMPTS]
    inp = {"B": B, "cache": CACHE, "params": params, "tokens": tokens,
           "feed": feed, "cases": CASES, "engine_prompts": prompts,
           "engine_seq": ENGINE_SEQ, "engine_gen": ENGINE_GEN}
    path = tmp / "inputs.pkl"
    path.write_bytes(pickle.dumps(inp))
    script = tmp / "rank.py"
    script.write_text(_RANK_SCRIPT)
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.serve",
         *CLI_ARGV, "--model-parallel", "2"], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = (_spawn(script, path, tmp, "two", 2)
             + _spawn(script, path, tmp, "four", 4) + [cli])
    try:
        one = {name: _oneshot(params[arch], arch, "none", kv, tokens[arch],
                              feed[arch]) for name, arch, _, kv in CASES}
        one["yi-6b luq_fp4"] = _oneshot(params["yi-6b"], "yi-6b", "luq_fp4",
                                        "int8", tokens["yi-6b"],
                                        feed["yi-6b"])
        jlogits = _jax_logits(jparams, tokens["yi-6b"], feed["yi-6b"])
        engine = _engine_tokens(params["yi-6b"], prompts)
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_cli.main(CLI_ARGV)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = {name: [pickle.loads((tmp / f"{name}{r}").read_bytes())
                   for r in range(world)]
            for name, world in (("two", 2), ("four", 4))}
    return {"one": one, "jax": jlogits, "engine": engine, "outs": outs,
            "cli": (_cli_requests(logs[-1]), _cli_requests(buf.getvalue()))}


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def test_every_rank_check_passes(spawned):
    for name, outs in spawned["outs"].items():
        for r, out in enumerate(outs):
            assert out["checks"] and all(out["checks"].values()), (
                name, r, {k: v for k, v in out["checks"].items() if not v})


@pytest.mark.parametrize("name, arch, ranks, kv_fmt", CASES)
def test_sharded_serving_matches_one_process(spawned, name, arch, ranks,
                                             kv_fmt):
    out = spawned["outs"]["two" if ranks == 2 else "four"][0]
    want_split = ("kv_seq" if ranks == 4 else "kv_heads")
    assert out["kv_split"][name] == want_split
    torch.testing.assert_close(out["logits"][name], spawned["one"][name],
                               **TOL)


def test_sharded_yi6b_matches_jax(spawned):
    for name in ("yi-6b 2 none", "yi-6b 4 none"):
        got = spawned["outs"]["two" if " 2 " in name else "four"][0]
        np.testing.assert_allclose(got["logits"][name].numpy(),
                                   spawned["jax"], **JAX_TOL)


def test_luq_head_within_limit_and_control_beyond(spawned):
    out = spawned["outs"]["two"][0]["logits"]
    want = spawned["one"]["yi-6b luq_fp4"]
    rel = _rel_l2(out["yi-6b luq_fp4"], want)
    ctrl = _rel_l2(out["yi-6b luq_fp4 control"], want)
    assert rel <= LUQ_LIMIT < ctrl, (rel, ctrl)


@pytest.mark.parametrize("split", ["kv_heads", "kv_seq"])
def test_engine_tokens_agree_across_ranks_and_with_one_process(spawned,
                                                               split):
    ranks = [o["tokens"][f"engine {split}"] for o in spawned["outs"]["two"]]
    assert ranks[0] == ranks[1]
    assert ranks[0] == spawned["engine"]
    assert len(ranks[0]) == len(ENGINE_PROMPTS)


def test_cli_on_two_ranks_prints_one_process_tokens(spawned):
    sharded, one = spawned["cli"]
    assert sharded and sharded == one
