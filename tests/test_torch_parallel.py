"""Data parallelism in the port (``repro_torch.parallel``,
``repro_torch.launch.mesh``, the sharded ghost driver, the data-parallel
vmap engine) against the JAX package's, on the CPU over gloo.

The partitioner: every case of ``tests/test_partitioner.py`` through both
packages' ``assign_spec`` on the same duck-typed mesh.  Validation: the
reference's errors for ``ghost_sharded``, ``partial_accum``, a family
without ``param_axes`` on a model axis of degree > 1, and the scan
executor under gloo on CUDA.

One spawn of four gloo ranks as a (pod 2, data 2) mesh
(``_RANK_SCRIPT``) runs, while this process compiles the JAX references:

* the sharded ghost driver on the reference test's model
  (``tests/test_ghost_sharded.py``: 2 layers, d_model 32, float32, B 8,
  S 16, clip 0.8, pass-1 chunks of one example), at a format registered
  in both packages as the identity (every fold of every projection
  through the hooks; the two packages draw LUQ's uniforms from other
  streams, so luq_fp4 is not a float32 comparison across them), against
  JAX's ``ghost_clipped_grad_sum``: sums rtol 2e-4, atol 2e-5, metrics
  rtol 1e-4, atol 1e-6; at luq_fp4 against the port's unsharded driver,
  at the same tolerances;
* two steps of ``build_train_setup`` on the mesh under the loop and the
  scan executor: at the identity format without noise against JAX's
  steps on a (1, 1) mesh, at luq_fp4 with noise (sigma 0.5) against the
  port's one-process steps, rtol 2e-4, atol 2e-4;
* the vmap step of ``tests/test_collectives.py`` (the gemma-7b smoke
  config, fmt none, microbatch 2, so each rank takes 2 examples of the
  global microbatch of 8) with ``partial_accum`` off and on: the loss
  within 2e-3 of JAX's, the new params within rtol 1e-5 of the port's
  one-process step;
* the MoE family's vmap step (arctic-smoke, fmt none, microbatch 1 a
  data shard) under the FULL config's ``sharding_overrides``, which lay
  the microbatch over ``data`` alone, so the two pods compute the same
  examples: the new params within rtol 1e-5 of one process's step;
* ``compressed_psum_pods``: relative error in (0, 0.02), the same result
  on every rank, exact when the partials are multiples of the scale;
* every rank's params the same bits after each run of steps;
* the DP noise's variance that of one process (noise added on every rank
  before the reduction would multiply it by the world size or its
  square).

A preemption requested on one rank stops all four at the same step, with
one checkpoint.

The train CLI under ``torch.distributed.run`` with two ranks and with one,
all four runs at once (stablelm-3b smoke, ghost, ``--ghost-sharded on``;
ResNet-18 smoke, vmap, with a DPQuant analysis): loss within rtol 2e-4,
epsilon and k exactly.

The non-default ``microbatch_mode`` and ``grad_accum_dtype`` on one
process, each engine's step against JAX's.
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

import repro.dp.ghost as jghost  # noqa: E402
from repro.config import DPConfig as JDPConfig  # noqa: E402
from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.dp.engine import validate_grad_mode as jvalidate  # noqa: E402
from repro.launch.mesh import make_compat_mesh as jmesh  # noqa: E402
from repro.launch.steps import build_train_setup as jsetup  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.parallel import partitioner as jpt  # noqa: E402
from repro.quant import backend as jbackend  # noqa: E402
from repro_torch.config import DPConfig, ModelConfig  # noqa: E402
from repro_torch.config import OptimConfig, QuantConfig  # noqa: E402
from repro_torch.config import RunConfig  # noqa: E402
from repro_torch.dp.engine import validate_grad_mode  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.parallel import partitioner as pt  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
QFMT = "identity_for_tests"         # registered as the identity in both
GHOST_CFG = dict(name="g", family="dense_lm", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                 vocab_size=128, compute_dtype="float32", remat=True)
B, S, CLIP, SIGMA, LR, STEPS = 8, 16, 0.8, 0.5, 0.1, 2
VMAP_B, VMAP_SEED = 8, 5
MOE_B = 8
SUM_TOL = dict(rtol=2e-4, atol=2e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)


class FakeMesh:
    """Duck-typed mesh (axis_names + devices.shape), as the reference's
    partitioner test has it."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


M = FakeMesh((2, 16, 16), ("pod", "data", "model"))
SP = FakeMesh((16, 16), ("data", "model"))
EXPERT_RULES = (("experts", (("pod", "model"), ("model",))),
                ("expert_mlp", (("data",),)))
# every case of tests/test_partitioner.py: (logical, shape, mesh, overrides)
SPEC_CASES = {
    "batch_pod_data": (("batch", "seq"), (256, 4096), M, ()),
    "batch_fallback_data_only": (("batch", "seq"), (16, 128), M, ()),
    "batch_indivisible_unsharded": (("batch", "seq"), (1, 524288), M, ()),
    "kv_cache_head_parallel": (
        ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
        (28, 128, 16, 32768, 256), M, ()),
    "kv_cache_seq_parallel": (
        ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
        (48, 128, 4, 32768, 128), M, ()),
    "axis_used_once_per_tensor": (("heads", "kv_seq"), (16, 32768), M, ()),
    "missing_axis_skipped": (("batch",), (256,), SP, ()),
    "override_rules_multi_pod": (
        ("layers", "experts", "embed", "expert_mlp"),
        (61, 384, 7168, 2048), M, EXPERT_RULES),
    "override_rules_single_pod": (("experts", "embed", "expert_mlp"),
                                  (384, 7168, 2048), SP, EXPERT_RULES),
    "tree_axes_w": (("embed", "mlp"), (4, 8),
                    FakeMesh((1, 1), ("data", "model")), ()),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_assign_spec_matches_jax(case):
    logical, shape, mesh, overrides = SPEC_CASES[case]
    want = jpt.assign_spec(logical, shape, mesh,
                           jpt.merge_rules(jpt.DEFAULT_RULES, overrides))
    got = pt.assign_spec(logical, shape, mesh,
                         pt.merge_rules(pt.DEFAULT_RULES, overrides))
    assert isinstance(got, pt.Spec)
    assert tuple(got) == tuple(want)


def test_assign_spec_rank_mismatch_raises_as_jax():
    with pytest.raises(ValueError):
        jpt.assign_spec(("batch",), (4, 4), M, jpt.DEFAULT_RULES)
    with pytest.raises(ValueError, match="rank"):
        pt.assign_spec(("batch",), (4, 4), M, pt.DEFAULT_RULES)


def test_local_slice_follows_the_mesh_coordinates():
    """Block i of n along a dim split over ("pod", "data"), i the rank's
    coordinates row-major, as a NamedSharding lays it out."""
    mesh = FakeMesh((2, 2, 1), ("pod", "data", "model"))
    entry = pt.assign_spec(("batch",), (8,), mesh, pt.DEFAULT_RULES)[0]
    assert entry == ("pod", "data")
    blocks = []
    for pod in range(2):
        for data in range(2):
            mesh.coords = {"pod": pod, "data": data, "model": 0}
            blocks.append(pt.local_slice(entry, 8, mesh))
    assert blocks == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert pt.local_slice(None, 8, mesh) == slice(0, 8)


@pytest.mark.parametrize("field, value, match", [
    ("ghost_sharded", "sideways", "ghost_sharded"),
    ("partial_accum", True, "partial_accum")])
def test_grad_mode_validation_matches_jax(field, value, match):
    for validate, cfg in ((jvalidate, JDPConfig), (validate_grad_mode,
                                                   DPConfig)):
        with pytest.raises(ValueError, match=match):
            validate(cfg(grad_mode="ghost", **{field: value}))


def test_model_axis_raises():
    """``ghost_sharded='on'`` on a model-parallel mesh raises the
    reference's error; a family without ``param_axes`` (BERT) on a mesh
    with a model axis of degree > 1 raises "not ported", never trains
    replicated."""
    from repro_torch.configs import get_smoke_config
    cfg = ModelConfig(**GHOST_CFG)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    mesh = FakeMesh((2, 2), ("data", "model"))
    run = RunConfig(model=cfg, dp=DPConfig(grad_mode="ghost",
                                           ghost_sharded="on"))
    # the reference's message (src/repro/launch/steps.py); its setup
    # needs a real mesh of 4 devices to reach the check
    with pytest.raises(ValueError, match=re.escape(
            "dp.ghost_sharded='on' requires params replicated over the "
            "data axes (model axis degree 1); use 'auto'/'off' on "
            "model-parallel meshes")):
        steps.build_train_setup(model, run, mesh)
    bert = get_smoke_config("bert-snli")
    bmodel = build_model(bert, QuantConfig(fmt="none"), device="cpu")
    for gs in ("auto", "off"):
        run = RunConfig(model=bert, dp=DPConfig(ghost_sharded=gs))
        with pytest.raises(NotImplementedError, match="not ported"):
            steps.build_train_setup(bmodel, run, mesh)


def test_scan_under_gloo_on_cuda_raises(monkeypatch):
    """gloo's collectives cannot be captured in a CUDA graph: the scan
    executor refuses a multi-rank mesh on CUDA under gloo when made."""
    monkeypatch.setattr(steps.dist, "get_backend", lambda *a: "gloo")
    setup = steps.TrainSetup(step_fn=None, opt_init_fn=None, noise_gen=None,
                             mesh=FakeMesh((2, 1), ("data", "model")))
    with pytest.raises(RuntimeError, match="loop executor"):
        steps.EpochRunner(setup, "cuda")


@pytest.mark.parametrize("grad_mode, field, value", [
    ("vmap", "microbatch_mode", "single"),
    ("vmap", "grad_accum_dtype", "bfloat16"),
    ("ghost", "grad_accum_dtype", "bfloat16")])
def test_dp_knobs_match_jax(grad_mode, field, value):
    """The non-default ``microbatch_mode`` and ``grad_accum_dtype``: one
    step of the port against JAX's on a (1, 1) mesh (fmt none, no noise),
    rtol 2e-4, atol 2e-4; and each takes effect (microbatch 1, or other
    params than the float32 sum gives)."""
    jcfg, cfg = JModelConfig(**GHOST_CFG), ModelConfig(**GHOST_CFG)
    params = _numpy_params(jcfg, 3)
    tokens = np.random.default_rng(3).integers(
        0, GHOST_CFG["vocab_size"], (B, S)).astype(np.int32)
    kw = dict(grad_mode=grad_mode, clip_norm=CLIP, noise_multiplier=0.0,
              microbatch_size=4)
    jrun = JRunConfig(model=jcfg, quant=JQuantConfig(fmt="none"),
                      dp=JDPConfig(**kw, **{field: value}),
                      optim=JOptimConfig(name="sgd", lr=LR),
                      global_batch=B, seq_len=S)
    jset = jsetup(jax_build_model(jcfg, jrun.quant), jrun,
                  jmesh((1, 1), ("data", "model")))
    want, _, _ = jax.jit(jset.step_fn)(
        params, jset.opt_init_fn(params), {"tokens": jnp.asarray(tokens)},
        jnp.uint32(0), jnp.zeros((jcfg.policy_len(),), jnp.float32),
        jnp.float32(LR))
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    got, multiple = {}, {}
    for name, extra in (("knob", {field: value}), ("default", {})):
        run = RunConfig(model=cfg, quant=QuantConfig(fmt="none"),
                        dp=DPConfig(**kw, **extra),
                        optim=OptimConfig(name="sgd", lr=LR),
                        global_batch=B, seq_len=S)
        setup = steps.build_train_setup(model, run)
        p = _flat(params)
        got[name], _, _ = setup.step_fn(
            p, setup.opt_init_fn(p), {"tokens": torch.from_numpy(tokens)},
            0, torch.zeros(cfg.policy_len()), torch.tensor(LR))
        multiple[name] = setup.batch_multiple
    _close(got["knob"], _flat(jax.tree.map(np.asarray, want)), field,
           **STEP_TOL)
    if field == "microbatch_mode":
        assert multiple == {"knob": 1, "default": 4}
    else:
        assert any(not torch.equal(got["knob"][k], got["default"][k])
                   for k in got["default"])


def test_unknown_microbatch_mode_raises():
    cfg = ModelConfig(**GHOST_CFG)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    run = RunConfig(model=cfg, dp=DPConfig(microbatch_mode="pairs"))
    with pytest.raises(ValueError, match="microbatch_mode"):
        steps.build_train_setup(model, run)


# --------------------------------------------------------------------------- #
# four gloo ranks
# --------------------------------------------------------------------------- #
_RANK_SCRIPT = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,
                                    QuantConfig, RunConfig)
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dp import ghost
    from repro_torch.launch.mesh import init_distributed, make_compat_mesh
    from repro_torch.launch.steps import EpochRunner, build_train_setup
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import compressed_psum_pods
    from repro_torch.parallel.collectives import replicas_agree
    from repro_torch.quant import backend as qbackend

    inp = pickle.load(open(sys.argv[1], "rb"))
    QFMT = inp["qfmt"]
    qbackend._REGISTRY[("quantize", QFMT, "ref")] = (
        lambda rows, key: rows.clone())
    qbackend._REGISTRY[("ghost_norm", QFMT, "ref")] = (
        lambda x, g, kx, kg: ghost._matpair_sq_norm(x, g))
    init_distributed("cpu")
    mesh = make_compat_mesh((2, 2), ("pod", "data"))
    world = mesh.axis_group(mesh.axis_names)
    out = {"agree": {}}

    def agree(name, tensors):
        out["agree"][name] = replicas_agree(list(tensors), world)

    cfg = ModelConfig(**inp["ghost_cfg"])
    tokens = torch.from_numpy(inp["tokens"])
    flags = torch.ones(cfg.policy_len())

    def ghost_sums(fmt):
        backend = "ref" if fmt == QFMT else "cuda"
        model = build_model(cfg, QuantConfig(fmt=fmt, backend=backend),
                            device="cpu")
        params = params_from_numpy(inp["ghost_params"], device="cpu")
        pel = lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h)
        kw = dict(clip_norm=inp["clip"], hooked_mask=model.ghost_mask(params),
                  aux=model.ghost_aux(flags), ghost_microbatch=1)
        batch = {"tokens": tokens}
        sharded = ghost.sharded_ghost_clipped_grad_sum(
            pel, params, batch, mesh=mesh, **kw)
        agree(f"ghost {fmt}", sharded[0].values())
        if fmt == QFMT:
            return sharded
        return sharded, ghost.ghost_clipped_grad_sum(pel, params, batch, **kw)

    out["ghost"] = {QFMT: ghost_sums(QFMT), "luq_fp4": ghost_sums("luq_fp4")}

    def run_steps(fmt, sigma, m, executor):
        backend = "ref" if fmt == QFMT else "cuda"
        run = RunConfig(model=cfg, quant=QuantConfig(fmt=fmt, backend=backend),
                        dp=DPConfig(grad_mode="ghost", clip_norm=inp["clip"],
                                    noise_multiplier=sigma),
                        optim=OptimConfig(name="sgd", lr=inp["lr"]),
                        global_batch=inp["B"], seq_len=inp["S"])
        model = build_model(cfg, run.quant, device="cpu")
        setup = build_train_setup(model, run, m)
        assert setup.ghost_sharded == (m is not None)
        p = params_from_numpy(inp["ghost_params"], device="cpu")
        o = setup.opt_init_fn(p)
        batches = torch.from_numpy(inp["step_tokens"])
        lrs = torch.full((len(batches),), inp["lr"])
        if executor == "scan":
            p, o, _ = EpochRunner(setup, "cpu")(
                p, o, {"tokens": batches}, list(range(len(batches))), flags,
                lrs)
        else:
            for i in range(len(batches)):
                p, o, _ = setup.step_fn(p, o, {"tokens": batches[i]}, i,
                                        flags, lrs[i])
        if m is not None:
            agree(f"steps {fmt} {executor}", p.values())
        return p

    out["steps"] = {
        (QFMT, ex): run_steps(QFMT, 0.0, mesh, ex) for ex in ("loop", "scan")}
    out["steps"].update({
        ("luq_fp4", ex): run_steps("luq_fp4", inp["sigma"], mesh, ex)
        for ex in ("loop", "scan")})
    out["steps"][("luq_fp4", "one process")] = run_steps(
        "luq_fp4", inp["sigma"], None, "loop")

    # the noise's variance: one step at lr 1 from the same params
    run = RunConfig(model=cfg, quant=QuantConfig(fmt="none"),
                    dp=DPConfig(grad_mode="ghost", clip_norm=inp["clip"],
                                noise_multiplier=1.0),
                    optim=OptimConfig(name="sgd", lr=1.0),
                    global_batch=inp["B"], seq_len=inp["S"])
    model = build_model(cfg, run.quant, device="cpu")
    p0 = params_from_numpy(inp["ghost_params"], device="cpu")
    for name, m in (("mesh", mesh), ("one process", None)):
        setup = build_train_setup(model, run, m)
        p1, _, _ = setup.step_fn(p0, setup.opt_init_fn(p0), {"tokens": tokens},
                                 7, flags, torch.tensor(1.0))
        upd = torch.cat([(p0[k] - p1[k]).reshape(-1) for k in p0])
        out.setdefault("noise_var", {})[name] = float(
            (upd * inp["B"]).var())

    # the vmap engine: gemma-7b smoke, fmt none, microbatch 2
    gcfg = get_smoke_config("gemma-7b")
    gmodel = build_model(gcfg, QuantConfig(fmt="none"), device="cpu")
    gtok = {"tokens": torch.from_numpy(inp["vmap_tokens"])}
    gflags = torch.zeros(gcfg.policy_len())
    out["vmap"] = {}
    for name, m, partial in (("mesh", mesh, False),
                             ("mesh partial", mesh, True),
                             ("one process", None, False)):
        run = RunConfig(model=gcfg, quant=QuantConfig(fmt="none"),
                        dp=DPConfig(microbatch_size=2, partial_accum=partial),
                        optim=OptimConfig(name="sgd", lr=0.1),
                        global_batch=inp["vmap_B"], seq_len=16)
        setup = build_train_setup(gmodel, run, m)
        gp = params_from_numpy(inp["vmap_params"], device="cpu")
        p2, _, metrics = setup.step_fn(gp, setup.opt_init_fn(gp), gtok,
                                       inp["vmap_seed"], gflags,
                                       torch.tensor(0.1))
        if m is not None:
            agree(f"vmap {name}", p2.values())
        out["vmap"][name] = (p2, {k: float(v) for k, v in metrics.items()})

    # the MoE family under its FULL config's rules: the microbatch over
    # "data" alone, the two pods computing the same examples, the clipped
    # sums reduced over the data group
    mcfg = dataclasses.replace(
        get_smoke_config("arctic-480b"),
        sharding_overrides=get_config("arctic-480b").sharding_overrides)
    mmodel = build_model(mcfg, QuantConfig(fmt="none"), device="cpu")
    mtok = {"tokens": torch.from_numpy(inp["moe_tokens"])}
    out["moe"] = {}
    for name, m in (("mesh", mesh), ("one process", None)):
        run = RunConfig(model=mcfg, quant=QuantConfig(fmt="none"),
                        dp=DPConfig(microbatch_size=1, clip_norm=0.5),
                        optim=OptimConfig(name="sgd", lr=0.1),
                        global_batch=len(inp["moe_tokens"]), seq_len=12)
        setup = build_train_setup(mmodel, run, m)
        mp = params_from_numpy(inp["moe_params"], device="cpu")
        p2, _, metrics = setup.step_fn(mp, setup.opt_init_fn(mp), mtok, 3,
                                       torch.zeros(mcfg.policy_len()),
                                       torch.tensor(0.1))
        if m is not None:
            agree("moe", p2.values())
        out["moe"][name] = (p2, {k: float(v) for k, v in metrics.items()})

    # compressed_psum_pods: this pod's partial, then partials on the grid
    pod = mesh.coords["pod"]
    parts = [torch.from_numpy(inp["pod_partials"][i]) for i in range(2)]
    got = compressed_psum_pods({"g": parts[pod]}, mesh, 3)["g"]
    agree("compressed", [got])
    grid = [torch.from_numpy(inp["grid_partials"][i]) for i in range(2)]
    exact = compressed_psum_pods({"g": grid[pod]}, mesh, 3)["g"]
    out["compressed"] = (got, exact)

    # a preemption requested on rank 1 alone (as a signal reaches one
    # process) stops every rank at the same step, with one checkpoint
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.runtime.preemption import Preempted, PreemptionHandler
    from repro_torch.train_loop import Trainer
    plan = FaultPlan([FaultEvent("preempt", 1)]) if mesh.rank == 1 else None
    run = RunConfig(model=cfg, quant=QuantConfig(fmt="none"),
                    dp=DPConfig(grad_mode="ghost", clip_norm=inp["clip"]),
                    global_batch=inp["B"], seq_len=inp["S"],
                    steps_per_epoch=3, epoch_executor="loop")
    tr = Trainer(run, TokenDataset(64, cfg.vocab_size, inp["S"]),
                 mode="static", device="cpu", checkpoint_dir=inp["ckpt"],
                 preemption=PreemptionHandler(faults=plan), mesh=mesh)
    try:
        tr.train(1)
        out["agree"]["preempted together"] = False
    except Preempted as p:
        out["agree"]["preempted together"] = p.step == 1

    if mesh.rank == 0:
        pickle.dump(out, open(sys.argv[2], "wb"))
    else:
        pickle.dump({"agree": out["agree"]}, open(sys.argv[2], "wb"))
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **extra)


def _numpy_params(cfg, seed):
    """Params of the JAX model's shapes from numpy, N(0, 0.1^2)."""
    model = jax_build_model(cfg, JQuantConfig(fmt="none"))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


@pytest.fixture(scope="module")
def identity_format():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda x, key=None: x)
        mp.setitem(jbackend._REGISTRY, ("ghost_norm", QFMT, "ref"),
                   lambda xm, gm, kx, kg: jghost._matpair_sq_norm(xm, gm))
        yield QFMT


def _jax_ghost(params, tokens):
    """JAX's unsharded ghost driver at the identity format."""
    model = jax_build_model(JModelConfig(**GHOST_CFG), JQuantConfig(fmt=QFMT))
    qflags = jnp.ones((GHOST_CFG["n_layers"],), jnp.float32)

    def loss_one(p, ex, r):
        return model.loss_fn(p, jax.tree.map(lambda x: x[None], ex), r,
                             qflags)

    def pel(p, b, r):
        return model.per_example_loss(p, b, r, qflags)

    fn = jax.jit(lambda p, b: jghost.ghost_clipped_grad_sum(
        loss_one, pel, p, b, clip_norm=CLIP, rng=jax.random.PRNGKey(42),
        hooked_mask=model.ghost_mask(p), aux=model.ghost_aux(qflags)))
    grads, metrics = fn(params, {"tokens": jnp.asarray(tokens)})
    return (jax.tree.map(np.asarray, grads),
            {k: float(v) for k, v in metrics.items()})


def _jax_steps(params, step_tokens):
    """JAX's ghost steps on a (1, 1) mesh at the identity format, without
    noise (its threefry draws are not the port's)."""
    cfg = JModelConfig(**GHOST_CFG)
    model = jax_build_model(cfg, JQuantConfig(fmt=QFMT))
    run = JRunConfig(model=cfg, quant=JQuantConfig(fmt=QFMT),
                     dp=JDPConfig(enabled=True, grad_mode="ghost",
                                  clip_norm=CLIP, noise_multiplier=0.0),
                     optim=JOptimConfig(name="sgd", lr=LR),
                     global_batch=B, seq_len=S)
    setup = jsetup(model, run, jmesh((1, 1), ("data", "model")))
    step = jax.jit(setup.step_fn)
    p, o = params, setup.opt_init_fn(params)
    qflags = jnp.ones((cfg.policy_len(),), jnp.float32)
    for i in range(len(step_tokens)):
        p, o, _ = step(p, o, {"tokens": jnp.asarray(step_tokens[i])},
                       jnp.uint32(i), qflags, jnp.float32(LR))
    return jax.tree.map(np.asarray, p)


def _jax_vmap_loss(params, tokens):
    """The loss of the reference's vmap step (tests/test_collectives.py)."""
    cfg = jax_smoke_config("gemma-7b")
    model = jax_build_model(cfg, JQuantConfig(fmt="none"))
    run = JRunConfig(model=cfg, quant=JQuantConfig(fmt="none"),
                     dp=JDPConfig(enabled=True, microbatch_size=2),
                     optim=JOptimConfig(name="sgd", lr=0.1),
                     global_batch=VMAP_B, seq_len=16)
    setup = jsetup(model, run, jmesh((1, 1), ("data", "model")))
    _, _, m = jax.jit(setup.step_fn)(
        params, setup.opt_init_fn(params), {"tokens": jnp.asarray(tokens)},
        jnp.uint32(VMAP_SEED), jnp.zeros((cfg.n_layers,), jnp.float32),
        jnp.float32(0.1))
    return float(m["loss"])


def _close(got: dict, want: dict, what: str, **tol):
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].detach().numpy(), np.asarray(w),
            err_msg=f"{what} {name}", **tol)


def _flat(tree) -> dict:
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(tree, device="cpu")


def test_four_gloo_ranks(tmp_path, identity_format):
    rng = np.random.default_rng(0)
    ghost_params = _numpy_params(JModelConfig(**GHOST_CFG), 1)
    vmap_params = _numpy_params(jax_smoke_config("gemma-7b"), 2)
    tokens = rng.integers(0, GHOST_CFG["vocab_size"], (B, S)).astype(np.int32)
    step_tokens = rng.integers(0, GHOST_CFG["vocab_size"],
                               (STEPS, B, S)).astype(np.int32)
    vmap_tokens = rng.integers(0, jax_smoke_config("gemma-7b").vocab_size,
                               (VMAP_B, 16)).astype(np.int32)
    moe_cfg = jax_smoke_config("arctic-480b")
    moe_params = _numpy_params(moe_cfg, 4)
    moe_tokens = rng.integers(0, moe_cfg.vocab_size,
                              (MOE_B, 12)).astype(np.int32)
    scale = 2.0 ** -3
    grid = rng.integers(-126, 127, (2, 64, 32)).astype(np.float32)
    grid[0, 0, 0] = 127                    # the pod-wide max is 127 x scale
    inp = {"qfmt": QFMT, "ghost_cfg": GHOST_CFG, "clip": CLIP, "lr": LR,
           "sigma": SIGMA, "B": B, "S": S,
           "ghost_params": ghost_params, "tokens": tokens,
           "step_tokens": step_tokens, "vmap_params": vmap_params,
           "vmap_tokens": vmap_tokens, "vmap_B": VMAP_B,
           "vmap_seed": VMAP_SEED, "moe_params": moe_params,
           "moe_tokens": moe_tokens,
           "pod_partials": rng.standard_normal((2, 64, 32)).astype(np.float32),
           "grid_partials": grid * scale, "ckpt": str(tmp_path / "ck")}
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps(inp))
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(path), str(tmp_path / f"out{r}")],
        env=_env(RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        # the references, compiled while the ranks run
        jgrads, jmetrics = _jax_ghost(ghost_params, tokens)
        jparams = _jax_steps(ghost_params, step_tokens)
        jloss = _jax_vmap_loss(vmap_params, vmap_tokens)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = [pickle.loads((tmp_path / f"out{r}").read_bytes())
            for r in range(4)]
    for r, o in enumerate(outs):
        assert o["agree"] and all(o["agree"].values()), (r, o["agree"])
    out = outs[0]
    assert [p.name for p in (tmp_path / "ck").iterdir()] == [
        "step_0000000001.ckpt"]

    # the sharded ghost driver against JAX's, and against the port's own
    got, metrics = out["ghost"][QFMT]
    _close(got, _flat(jgrads), "ghost sums", **SUM_TOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k,
                                   **METRIC_TOL)
    assert jmetrics["clip_fraction"] > 0
    (got, metrics), (want, wmetrics) = out["ghost"]["luq_fp4"]
    _close(got, want, "ghost luq_fp4 sums", **SUM_TOL)
    for k, v in wmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), err_msg=k,
                                   **METRIC_TOL)

    # two steps, loop and scan
    for ex in ("loop", "scan"):
        _close(out["steps"][QFMT, ex], _flat(jparams), f"steps {ex}",
               **STEP_TOL)
        _close(out["steps"]["luq_fp4", ex],
               out["steps"]["luq_fp4", "one process"],
               f"luq_fp4 steps {ex}", **STEP_TOL)

    # the noise is added once, after the reduction
    var = out["noise_var"]
    assert abs(var["mesh"] / (1.0 * CLIP) ** 2 - 1) < 0.05, var
    assert abs(var["mesh"] / var["one process"] - 1) < 1e-3, var

    # the vmap engine, partial_accum off and on
    want, _ = out["vmap"]["one process"]
    for name in ("mesh", "mesh partial"):
        got, metrics = out["vmap"][name]
        assert abs(metrics["loss"] - jloss) < 2e-3, (name, metrics, jloss)
        _close(got, want, name, rtol=1e-5, atol=0.0)

    # the MoE step, its batch over "data" alone: the same update as one
    # process (a reduction over the world would count each example twice)
    want, wmetrics = out["moe"]["one process"]
    got, metrics = out["moe"]["mesh"]
    _close(got, want, "moe", rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(metrics["loss"], wmetrics["loss"], rtol=1e-6)
    assert wmetrics["clip_fraction"] > 0

    # int8 compression over the pods
    got, exact = out["compressed"]
    parts = inp["pod_partials"].sum(axis=0)
    rel = np.linalg.norm(got.numpy() - parts) / np.linalg.norm(parts)
    assert 0 < rel < 0.02, rel
    np.testing.assert_array_equal(exact.numpy(),
                                  inp["grid_partials"].sum(axis=0))


CLI_CASES = {
    # the sharded ghost driver
    "ghost": (["--arch", "stablelm-3b", "--grad-mode", "ghost",
               "--ghost-sharded", "on", "--batch", "4",
               "--ghost-microbatch", "2", "--seq-len", "16"], {2: [], 1: []}),
    # the vmap engine: 32 examples a rank of each global microbatch of 64
    # (one rank: 64), and the DPQuant probe batch (32) rounded up to it
    "vmap": (["--arch", "resnet18", "--batch", "64"],
             {2: ["--microbatch", "32"], 1: ["--microbatch", "64"]}),
}


def test_cli_two_ranks_match_one(tmp_path):
    """``torch.distributed.run`` with two ranks and with one, every case of
    ``CLI_CASES`` at once: the same loss to rtol 2e-4, the same epsilon
    and k; with two, rank 0 alone prints, and writes the epoch's
    checkpoint."""
    runs = [(case, n) for case in sorted(CLI_CASES) for n in (2, 1)]
    procs = {}
    for case, n in runs:
        args, per_world = CLI_CASES[case]
        ck = ["--checkpoint-dir", str(tmp_path / case)] if n == 2 else []
        procs[case, n] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), "-m", "repro_torch.launch.train",
             "--smoke", "--device", "cpu", "--executor", "loop",
             "--epochs", "1", "--steps-per-epoch", "2", "--dataset-size",
             "256", *args, *per_world[n], *ck],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    lines = {}
    try:
        for run, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, (run, err[-4000:])
            lines[run] = re.findall(
                r"epoch 0: loss=(\S+) eps=(\S+) k=(\d+)", out)
    finally:
        for p in procs.values():
            p.kill()
    for case in CLI_CASES:
        # rank 0 alone prints
        assert len(lines[case, 2]) == len(lines[case, 1]) == 1, lines
        (loss2, eps2, k2), = lines[case, 2]
        (loss1, eps1, k1), = lines[case, 1]
        np.testing.assert_allclose(float(loss2), float(loss1), rtol=2e-4,
                                   err_msg=case)
        assert (eps2, k2) == (eps1, k1), case
        assert [p.name for p in (tmp_path / case).iterdir()] == [
            "step_0000000002.ckpt"]
