"""The ``model`` mesh axis in the port (tensor parallelism of the dense
LMs, expert parallelism of the MoE LMs) against one process and the JAX
package, on the CPU over gloo.

Layout: ``partitioner.tree_specs`` of stablelm-3b, yi-6b and arctic-480b,
FULL and SMOKE, on the production meshes (16, 16) and (2, 16, 16), equals
the reference's ``assign_spec`` leaf by leaf (its ``param_axes``, shapes
from ``jax.eval_shape``); the port's layout keeps only the model axis
(``param_spec``).  The quantizer: a shard's rows rounded by
``ops.luq_round`` (the plain version here) under the index map of every
split dim equal the slice of the whole tensor's ``luq_quant``, bit for
bit, on maps that keep Philox groups whole and on maps that do not.  The
noise: a split leaf's noise is the slice of the whole leaf's draw.

Two spawns run at once, while this process computes the one-process
references and the JAX step (``_RANK_SCRIPT``; every rank's own checks
inside): two ranks as a (1, 2) mesh, and four ranks as a (data 2, model
2) mesh and then a (1, 4) mesh.  On them:

* ``vmap(grad)`` through ``copy_to_model`` / ``reduce_from_model`` /
  ``max_over_model`` equals the unsharded per-example gradients, and a
  split ``fake_quant`` (whole and one row per example, under ``vmap``
  too) equals the slice of the whole tensor's, bit for bit;
* the gathered clipped sums and metrics of ``TrainSetup.grad_fn``:
  stablelm-3b-smoke in both engines on (1, 2) and (2, 2), yi-6b-smoke
  (its 2 KV heads replicated over 4 model ranks) on (1, 4), arctic-smoke
  on (1, 2), against one process.  At fmt none in float32, rtol 2e-4,
  atol 2e-5 (metrics too).  At luq_fp4 the sums within the relative-L2
  limits of ``LUQ_LIMITS``: LUQ's step function turns the row-parallel
  sums' float32 order into flipped codes (``ROADMAP.md`` section 3), and
  a control with the model group's other ranks keyed from another seed
  must lie beyond each limit;
* arctic's dropped (token, slot) pairs are one process's, bitwise;
* each rank holds only its blocks: its param bytes are the sum of its
  ``local_slice`` shapes; after a step the replicated leaves are the same
  bits over the model group, and every leaf over the data group;
* one step (fmt none, float32, vmap, no noise) gathered on (1, 2) equals
  the reference's step on the same params and batch;
* a checkpoint written on (1, 2) (whole trees) restores on one process
  to the gathered params' bits;
* BERT on a model-parallel mesh raises.
"""
import dataclasses
import os
import pickle
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

from repro.config import DPConfig as JDPConfig  # noqa: E402
from repro.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.mesh import make_compat_mesh as jmesh  # noqa: E402
from repro.launch.steps import build_train_setup as jsetup  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.parallel import partitioner as jpt  # noqa: E402
from repro_torch.config import DPConfig, OptimConfig  # noqa: E402
from repro_torch.config import QuantConfig, RunConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (_flatten, params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.dp.noise import add_gaussian_noise  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import partitioner as pt  # noqa: E402
from repro_torch.quant.fake_quant import _index_map  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, CLIP, LR = 4, 16, 0.05, 0.1
SUM_TOL = dict(rtol=2e-4, atol=2e-5)
# relative L2 of the sharded clipped sums against one process's at
# luq_fp4, three times the readings on a CPU (stablelm-3b 4.2e-7 ghost and
# 2.0e-7 vmap, arctic-smoke 2.1e-7, yi-6b 1.6e-7: float32 order, no
# flipped code at these params and tokens); each control reads 1.21-1.33
LUQ_LIMITS = {"stablelm-3b ghost": 1.3e-6, "stablelm-3b vmap": 6e-7,
              "yi-6b vmap": 5e-7, "arctic-480b vmap": 6.5e-7}
# (name, arch, grad mode, fmt, clip backend) by spawn and mesh
CASES = {
    "two": [("stablelm-3b ghost none", "stablelm-3b", "ghost", "none", "ref"),
            ("stablelm-3b vmap none", "stablelm-3b", "vmap", "none", "ref"),
            ("stablelm-3b ghost luq_fp4", "stablelm-3b", "ghost", "luq_fp4",
             "ref"),
            ("stablelm-3b vmap luq_fp4", "stablelm-3b", "vmap", "luq_fp4",
             "fused"),
            ("arctic-480b vmap none", "arctic-480b", "vmap", "none", "fused"),
            ("arctic-480b vmap luq_fp4", "arctic-480b", "vmap", "luq_fp4",
             "ref")],
    "four22": [("stablelm-3b vmap none (2, 2)", "stablelm-3b", "vmap",
                "none", "fused"),
               ("stablelm-3b ghost none (2, 2)", "stablelm-3b", "ghost",
                "none", "ref")],
    "four14": [("yi-6b ghost none", "yi-6b", "ghost", "none", "ref"),
               ("yi-6b vmap luq_fp4", "yi-6b", "vmap", "luq_fp4", "fused")],
}
ARCHS = ("stablelm-3b", "yi-6b", "arctic-480b")


def _run(cfg, mode, fmt, clip_backend, mp=1, sigma=0.0):
    return RunConfig(model=cfg, quant=QuantConfig(fmt=fmt, backend="cuda"),
                     dp=DPConfig(grad_mode=mode, clip_norm=CLIP,
                                 noise_multiplier=sigma, microbatch_size=2,
                                 ghost_microbatch=2,
                                 clip_backend=clip_backend),
                     optim=OptimConfig(name="sgd", lr=LR), global_batch=B,
                     seq_len=S, model_parallel=mp)


# --------------------------------------------------------------------------- #
# in this process
# --------------------------------------------------------------------------- #
class FakeMesh:
    """Duck-typed mesh (axis_names + devices.shape), as the reference's
    partitioner test has it."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_tree_specs_match_jax(arch, size):
    jcfg = jax_config(arch) if size == "full" else jax_smoke(arch)
    cfg = get_config(arch) if size == "full" else get_smoke_config(arch)
    jmodel = jax_build_model(jcfg, JQuantConfig(fmt="none"))
    jshapes = {k: tuple(v.shape) for k, v in _flatten(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))}
    jmod = jmoe if jcfg.family == "moe_lm" else jtfm
    jaxes = dict(_axes_leaves(jmod.param_axes(jcfg)))
    model = build_model(cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in steps.eval_shape(
        lambda: model.init(0), device="cpu").items()}
    assert shapes == jshapes
    axes = model.param_axes()
    assert set(axes) == set(shapes)
    rules = pt.merge_rules(pt.DEFAULT_RULES, cfg.sharding_overrides)
    jrules = jpt.merge_rules(jpt.DEFAULT_RULES, jcfg.sharding_overrides)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        fake = FakeMesh(mesh.devices.shape, mesh.axis_names)
        specs = pt.tree_specs(axes, shapes, mesh, rules)
        for name, shape in shapes.items():
            want = tuple(jpt.assign_spec(jaxes[name], shape, fake,
                                         jrules))
            assert tuple(specs[name]) == want, (name, multi)
            assert pt.param_spec(specs[name]) == tuple(
                "model" if "model" in pt.entry_axes(e) else None
                for e in want)


def _axes_leaves(tree, prefix=""):
    """``(dotted name, logical axes)`` of the reference's nested axes."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _axes_leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", tuple(value)


# shapes (rows form: one whole tensor or one row per leading entry), the
# split dim, ranks: maps that keep Philox groups whole (inner a multiple
# of 4) and maps that do not
QUANT_CASES = [((3, 6, 4, 8), 2, 2), ((2, 10, 80), 2, 2), ((2, 9, 6, 5), 1, 3),
               ((4, 12, 7), 2, 4), ((2, 3, 5), 2, 5), ((6, 14), 1, 2)]


@pytest.mark.parametrize("shape, dim, parts", QUANT_CASES)
@pytest.mark.parametrize("rows", ["whole", "per_example"])
@pytest.mark.parametrize("codes", [False, True])
def test_sharded_luq_quant_is_the_slice(shape, dim, parts, rows, codes):
    gen = torch.Generator().manual_seed(sum(shape) + dim)
    x = torch.randn(shape, generator=gen)
    key = (97, 0x4C550003)
    r = 1 if rows == "whole" else shape[0]
    whole = ref.luq_quant_ref(x.reshape(r, -1), key, codes).reshape(shape)
    alpha = x.reshape(r, -1).abs().amax(dim=1)
    n = shape[dim] // parts
    whole_groups = []
    for i in range(parts):
        index = [slice(None)] * len(shape)
        index[dim] = slice(i * n, (i + 1) * n)
        shard = x[tuple(index)].contiguous()
        imap = _index_map(shard.shape, (dim, i * n, shape[dim]))
        whole_groups.append(all(v % 4 == 0 for v in imap))
        got = ops.luq_round(shard.reshape(r, -1), key, alpha, imap,
                            codes=codes).reshape(shard.shape)
        assert torch.equal(got, whole[tuple(index)]), i
        assert torch.equal(ops.luq_row_max(shard.reshape(r, -1)),
                           shard.reshape(r, -1).abs().amax(dim=1))


def test_quant_cases_take_both_paths():
    """The cases above include maps that keep groups of 4 whole (the
    kernel's vector path) and maps that do not (its element path)."""
    kinds = set()
    for shape, dim, parts in QUANT_CASES:
        n = shape[dim] // parts
        for i in range(parts):
            sub = list(shape)
            sub[dim] = n
            imap = _index_map(tuple(sub), (dim, i * n, shape[dim]))
            kinds.add(all(v % 4 == 0 for v in imap))
    assert kinds == {True, False}


def test_split_leaf_noise_is_the_slice_of_the_whole_draw():
    whole = {"a": torch.zeros(6, 4), "b": torch.zeros(3), "c": torch.zeros(2, 8)}
    gen = torch.Generator().manual_seed(5)
    want = add_gaussian_noise(whole, clip_norm=0.5, noise_multiplier=1.3,
                              batch_size=4, generator=gen)
    for i in range(2):
        index = {"a": (slice(3 * i, 3 * i + 3), slice(None)),
                 "c": (slice(None), slice(4 * i, 4 * i + 4))}
        local = {"a": torch.zeros(3, 4), "b": torch.zeros(3),
                 "c": torch.zeros(2, 4)}
        gen.manual_seed(5)
        got = add_gaussian_noise(
            local, clip_norm=0.5, noise_multiplier=1.3, batch_size=4,
            generator=gen, layout={k: (whole[k].shape, v)
                                   for k, v in index.items()})
        for k in whole:
            assert torch.equal(got[k], want[k][index.get(k, ...)]), k


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #
_RANK_SCRIPT = textwrap.dedent('''
    import contextlib, os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from torch.func import grad, vmap
    from repro_torch.config import (DPConfig, OptimConfig, QuantConfig,
                                    RunConfig)
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import init_distributed, make_compat_mesh
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import axes as pax
    from repro_torch.parallel import partitioner as pt
    from repro_torch.parallel.collectives import (
        copy_to_model, max_over_model, reduce_from_model, replicas_agree)
    from repro_torch.quant import fake_quant

    inp = pickle.load(open(sys.argv[1], "rb"))
    spawn = sys.argv[3]
    B, S, CLIP, LR = inp["B"], inp["S"], inp["clip"], inp["lr"]
    init_distributed("cpu")
    rank = dist.get_rank()
    out = {"checks": {}, "sums": {}, "metrics": {}}

    def check(name, ok):
        out["checks"][name] = bool(ok)

    def run_of(cfg, mode, fmt, clip_backend, mp):
        return RunConfig(model=cfg, quant=QuantConfig(fmt=fmt, backend="cuda"),
                         dp=DPConfig(grad_mode=mode, clip_norm=CLIP,
                                     noise_multiplier=0.0, microbatch_size=2,
                                     ghost_microbatch=2,
                                     clip_backend=clip_backend),
                         optim=OptimConfig(name="sgd", lr=LR),
                         global_batch=B, seq_len=S, model_parallel=mp)

    @contextlib.contextmanager
    def other_key(on):
        """The quantizers keyed from another seed (a control)."""
        key = fake_quant.stream_key
        if on:
            fake_quant.stream_key = lambda seed, fold: key(
                (seed + 7919) % 2 ** 32, fold)
        try:
            yield
        finally:
            fake_quant.stream_key = key

    def held_bytes(local, setup, mesh):
        """Whether this rank holds exactly its blocks."""
        want = sum(int(np.prod(pt.local_shape(setup.param_specs[k],
                                              setup.param_shapes[k], mesh)))
                   * t.element_size() for k, t in local.items())
        return sum(t.numel() * t.element_size()
                   for t in local.values()) == want

    def case(name, arch, mode, fmt, clip_backend, mesh):
        cfg = get_smoke_config(arch)
        model = build_model(cfg, QuantConfig(fmt=fmt, backend="cuda"),
                            device="cpu")
        setup = build_train_setup(
            model, run_of(cfg, mode, fmt, clip_backend,
                          mesh.shape["model"]), mesh)
        params = params_from_numpy(inp["params"][arch], device="cpu")
        local = setup.shard(params)
        check(f"{name}: holds its blocks", held_bytes(local, setup, mesh))
        check(f"{name}: split", setup.model_parallel)
        batch = {"tokens": torch.from_numpy(inp["tokens"][arch])}
        flags = torch.ones(cfg.policy_len())
        grads, metrics = setup.grad_fn(local, batch, flags)
        out["sums"][name] = {k: v.float() for k, v in
                             setup.unshard(grads).items()}
        out["metrics"][name] = {k: float(v) for k, v in metrics.items()}
        if fmt == "luq_fp4":
            with other_key(mesh.model_group().index != 0):
                ctrl, _ = setup.grad_fn(local, batch, flags)
            out["sums"][name + " control"] = {
                k: v.float() for k, v in setup.unshard(ctrl).items()}
        # one step: the replicated leaves the same bits over the model
        # group, every leaf over the data group
        p2, _, _ = setup.step_fn(local, setup.opt_init_fn(local), batch, 3,
                                 flags, torch.tensor(LR))
        rep = [p2[k] for k, s in setup.param_specs.items()
               if not pt.split_dims(s)]
        check(f"{name}: replicated leaves agree",
              replicas_agree(rep, mesh.model_group()))
        data = mesh.axis_group(("data",))
        check(f"{name}: data replicas agree",
              replicas_agree(list(p2.values()), data))
        return setup, model, local

    def collectives(mesh):
        """vmap(grad) through the model collectives, and a split
        fake_quant, against the unsharded computation."""
        gen = torch.Generator().manual_seed(11)
        d, f, n = 6, 8, 5
        w1, w2 = torch.randn(d, f, generator=gen), torch.randn(f, d, generator=gen)
        xs = torch.randn(n, 3, d, generator=gen)
        m = mesh.model_group()
        cols = slice(m.index * f // m.size, (m.index + 1) * f // m.size)

        def loss(w1, w2, x, split):
            h = copy_to_model(x) if split else x
            y = torch.tanh(h @ w1) @ w2
            y = reduce_from_model(y) if split else y
            top = max_over_model(y.amax(-1)) if split else y.amax(-1).detach()
            return (y - top[..., None]).square().sum()

        g1 = vmap(grad(loss, argnums=(0, 1)), in_dims=(None, None, 0, None))
        with pax.partitioning_context(m):
            a1, a2 = g1(w1[:, cols], w2[cols], xs, True)
        b1, b2 = g1(w1, w2, xs, False)
        check("collectives: vmap(grad)",
              torch.allclose(a1, b1[:, :, cols], rtol=1e-5, atol=1e-6)
              and torch.allclose(a2, b2[:, cols], rtol=1e-5, atol=1e-6))
        # fake_quant on a shard: whole, one row per example, under vmap
        x = torch.randn(3, 4, f, 5, generator=gen)
        part = x[:, :, cols].contiguous()
        split = [2, cols.start, f]
        ok = True
        with pax.partitioning_context(m):
            for fn, kw in ((fake_quant.fake_quant, {}),
                           (fake_quant.fake_quant_rows, {})):
                got = fn(part, "luq_fp4", "cuda", 5, 3, None, split)
                want = fn(x, "luq_fp4", "cuda", 5, 3, None, None)
                ok &= torch.equal(got, want[:, :, cols])
            got = vmap(lambda t: fake_quant.fake_quant(
                t, "luq_fp4", "cuda", 5, 3, None, [1, cols.start, f]),
                randomness="same")(part)
        want = vmap(lambda t: fake_quant.fake_quant(
            t, "luq_fp4", "cuda", 5, 3, None, None),
            randomness="same")(x)
        ok &= torch.equal(got, want[:, :, cols])
        check("collectives: split fake_quant is the slice", ok)

    def dropped(mesh, arch):
        """arctic's overflow masks in a sharded forward, and rank 0's in
        one process's."""
        cfg = get_smoke_config(arch)
        model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
        setup = build_train_setup(
            model, run_of(cfg, "vmap", "none", "ref", mesh.shape["model"]),
            mesh)
        params = params_from_numpy(inp["params"][arch], device="cpu")
        seen = []
        orig = moe._positions

        def spy(ids, n_experts, capacity):
            pos, over = orig(ids, n_experts, capacity)
            seen.append(over.clone())
            return pos, over

        moe._positions = spy
        batch = {"tokens": torch.from_numpy(inp["tokens"][arch])}
        flags = torch.zeros(cfg.policy_len())
        with pax.partitioning_context(mesh.model_group()):
            model.loss_fn(setup.shard(params), batch, flags)
        sharded, seen[:] = list(seen), []
        model.loss_fn(params, batch, flags)
        moe._positions = orig
        check("arctic: dropped pairs are one process's",
              len(seen) == len(sharded) and all(
                  torch.equal(a, b) for a, b in zip(sharded, seen)))
        out["dropped"] = float(torch.cat([s.reshape(-1) for s in seen])
                               .float().mean())

    def checkpoint(mesh):
        from repro_torch.data.synthetic import TokenDataset
        from repro_torch.train_loop import Trainer
        cfg = get_smoke_config("stablelm-3b")
        run = RunConfig(model=cfg, quant=QuantConfig(fmt="none"),
                        dp=DPConfig(grad_mode="ghost", clip_norm=CLIP,
                                    ghost_microbatch=2),
                        optim=OptimConfig(name="momentum", lr=LR,
                                          momentum=0.9),
                        global_batch=B, seq_len=S, steps_per_epoch=1,
                        epoch_executor="loop", model_parallel=2)
        tr = Trainer(run, TokenDataset(32, cfg.vocab_size, S), mode="static",
                     device="cpu", checkpoint_dir=inp["ckpt"], mesh=mesh)
        tr.train(1)
        tr.ckpt.wait()
        out["ckpt_params"] = tr.setup.unshard(tr.params)
        out["ckpt_opt"] = tr.setup.unshard(tr.opt_state)
        check("checkpoint: blocks held", held_bytes(tr.params, tr.setup,
                                                    mesh))

    if spawn == "two":
        mesh = make_compat_mesh((1, 2), ("data", "model"))
        collectives(mesh)
        for c in inp["cases"]["two"]:
            setup, model, local = case(*c, mesh)
        dropped(mesh, "arctic-480b")
        # one step at fmt none, float32, vmap, no noise, gathered
        cfg = get_smoke_config("stablelm-3b")
        model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
        setup = build_train_setup(model, run_of(cfg, "vmap", "none", "ref",
                                                2), mesh)
        local = setup.shard(params_from_numpy(inp["params"]["stablelm-3b"],
                                              device="cpu"))
        p2, _, m = setup.step_fn(
            local, setup.opt_init_fn(local),
            {"tokens": torch.from_numpy(inp["tokens"]["stablelm-3b"])}, 0,
            torch.zeros(cfg.policy_len()), torch.tensor(LR))
        out["step"] = (setup.unshard(p2), {k: float(v) for k, v in m.items()})
        checkpoint(mesh)
    else:
        mesh = make_compat_mesh((2, 2), ("data", "model"))
        for c in inp["cases"]["four22"]:
            case(*c, mesh)
        mesh = make_compat_mesh((1, 4), ("data", "model"))
        for c in inp["cases"]["four14"]:
            case(*c, mesh)
    pickle.dump(out if rank == 0 else {"checks": out["checks"]},
                open(sys.argv[2], "wb"))
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script, path, out_dir, name, world):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    return [subprocess.Popen(
        [sys.executable, str(script), str(path), str(out_dir / f"{name}{r}"),
         name], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _one_process(inp):
    """The one-process clipped sums and metrics of every case."""
    out = {}
    for cases in inp["cases"].values():
        for name, arch, mode, fmt, clip_backend in cases:
            cfg = get_smoke_config(arch)
            model = build_model(cfg, QuantConfig(fmt=fmt, backend="cuda"),
                                device="cpu")
            setup = steps.build_train_setup(
                model, _run(cfg, mode, fmt, clip_backend))
            grads, metrics = setup.grad_fn(
                params_from_numpy(inp["params"][arch], device="cpu"),
                {"tokens": torch.from_numpy(inp["tokens"][arch])},
                torch.ones(cfg.policy_len()))
            out[name] = ({k: v.float() for k, v in grads.items()},
                         {k: float(v) for k, v in metrics.items()})
    return out


def _jax_step(params, tokens):
    """The reference's vmap step on a (1, 1) mesh, fmt none, no noise."""
    cfg = dataclasses.replace(jax_smoke("stablelm-3b"), remat=False)
    model = jax_build_model(cfg, JQuantConfig(fmt="none"))
    run = JRunConfig(model=cfg, quant=JQuantConfig(fmt="none"),
                     dp=JDPConfig(enabled=True, clip_norm=CLIP,
                                  noise_multiplier=0.0, microbatch_size=2),
                     optim=JOptimConfig(name="sgd", lr=LR),
                     global_batch=B, seq_len=S)
    setup = jsetup(model, run, jmesh((1, 1), ("data", "model")))
    p, _, m = jax.jit(setup.step_fn)(
        params, setup.opt_init_fn(params), {"tokens": jnp.asarray(tokens)},
        jnp.uint32(0), jnp.zeros((cfg.policy_len(),), jnp.float32),
        jnp.float32(LR))
    return jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    params, tokens = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)
        params[arch] = params_to_numpy(
            build_model(cfg, QuantConfig(fmt="none"), device="cpu").init(i))
        tokens[arch] = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int64)
    inp = {"B": B, "S": S, "clip": CLIP, "lr": LR, "params": params,
           "tokens": tokens, "cases": CASES, "ckpt": str(tmp / "ck")}
    path = tmp / "inputs.pkl"
    path.write_bytes(pickle.dumps(inp))
    script = tmp / "rank.py"
    script.write_text(_RANK_SCRIPT)
    procs = (_spawn(script, path, tmp, "two", 2)
             + _spawn(script, path, tmp, "four", 4))
    try:
        one = _one_process(inp)
        jstep = _jax_step(params["stablelm-3b"], tokens["stablelm-3b"])
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = {name: [pickle.loads((tmp / f"{name}{r}").read_bytes())
                   for r in range(world)]
            for name, world in (("two", 2), ("four", 4))}
    return {"inp": inp, "one": one, "jstep": jstep, "outs": outs,
            "ckpt": tmp / "ck"}


def _rel_l2(got: dict, want: dict) -> float:
    dn = sum((got[k] - want[k]).square().sum().item() for k in want)
    wn = sum(want[k].square().sum().item() for k in want)
    return (dn / wn) ** 0.5


def _result(spawned, name):
    """(sums, metrics) of a case gathered by its spawn's rank 0."""
    spawn = "two" if any(name == c[0] for c in CASES["two"]) else "four"
    out = spawned["outs"][spawn][0]
    return out["sums"], out["metrics"]


def test_every_rank_check_passes(spawned):
    for name, outs in spawned["outs"].items():
        for r, out in enumerate(outs):
            assert out["checks"] and all(out["checks"].values()), (
                name, r, {k: v for k, v in out["checks"].items() if not v})


@pytest.mark.parametrize("name", [c[0] for cases in CASES.values()
                                  for c in cases if c[3] == "none"])
def test_sharded_sums_match_one_process(spawned, name):
    sums, metrics = _result(spawned, name)
    want, wmetrics = spawned["one"][name]
    assert set(sums[name]) == set(want)
    for k in want:
        torch.testing.assert_close(sums[name][k], want[k], **SUM_TOL,
                                   msg=lambda m, k=k: f"{name} {k}: {m}")
    for k, v in wmetrics.items():
        np.testing.assert_allclose(metrics[name][k], v, err_msg=k,
                                   **SUM_TOL)


@pytest.mark.parametrize("name", [c[0] for cases in CASES.values()
                                  for c in cases if c[3] == "luq_fp4"])
def test_sharded_luq_sums_within_limit_and_control_beyond(spawned, name):
    sums, metrics = _result(spawned, name)
    want, wmetrics = spawned["one"][name]
    limit = LUQ_LIMITS[name.replace(" luq_fp4", "")]
    rel = _rel_l2(sums[name], want)
    ctrl = _rel_l2(sums[name + " control"], want)
    assert rel <= limit < ctrl, (name, rel, limit, ctrl)
    np.testing.assert_allclose(metrics[name]["loss"], wmetrics["loss"],
                               **SUM_TOL)


def test_gathered_step_matches_jax(spawned):
    got, metrics = spawned["outs"]["two"][0]["step"]
    want, wmetrics = spawned["jstep"]
    want = params_from_numpy(want, device="cpu")
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **SUM_TOL,
                                   msg=lambda m, k=k: f"{k}: {m}")
    np.testing.assert_allclose(metrics["loss"], wmetrics["loss"], rtol=2e-4)


def test_checkpoint_restores_on_one_process(spawned):
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.train_loop import Trainer
    out = spawned["outs"]["two"][0]
    cfg = get_smoke_config("stablelm-3b")
    run = RunConfig(model=cfg, quant=QuantConfig(fmt="none"),
                    dp=DPConfig(grad_mode="ghost", clip_norm=CLIP,
                                ghost_microbatch=2),
                    optim=OptimConfig(name="momentum", lr=LR, momentum=0.9),
                    global_batch=B, seq_len=S, steps_per_epoch=1,
                    epoch_executor="loop")
    tr = Trainer(run, TokenDataset(32, cfg.vocab_size, S), mode="static",
                 device="cpu", checkpoint_dir=spawned["ckpt"])
    assert tr.restore_latest() == 0
    for k, v in out["ckpt_params"].items():
        assert torch.equal(tr.params[k], v), k
    for k, v in out["ckpt_opt"].items():
        assert torch.equal(tr.opt_state[k], v), k


def test_model_parallel_family_without_param_axes_raises():
    cfg = get_smoke_config("bert-snli")
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    mesh = FakeMesh((1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.build_train_setup(model, RunConfig(model=cfg), mesh)
