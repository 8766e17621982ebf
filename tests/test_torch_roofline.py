"""The port's analysis tooling (``repro_torch.launch.roofline``,
``op_analysis``, ``dryrun``) against the JAX package's
(``repro.launch.roofline``, ``hlo_analysis``, ``dryrun``) and against
analytic counts, on the CPU: traces run on ``meta`` tensors, which take
the kernel wrappers' traced route as fake CUDA tensors do (a CPU build of
torch cannot trace a backward on fake CUDA tensors: the card's test is in
``test_torch_cuda_kernels.py``)."""
import dataclasses
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import (SHAPES, QuantConfig, RunConfig,  # noqa: E402
                                resolve_device, traced_device)
from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, op_analysis as oa  # noqa: E402
from repro_torch.launch import roofline, train  # noqa: E402
from repro_torch.launch.steps import (TensorSpec, build_serve_setup,  # noqa: E402
                                      eval_shape)
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

RESNET_ARGV = ["--arch", "resnet18", "--smoke", "--mode", "dpquant", "--fmt",
               "luq_fp4", "--backend", "cuda", "--clip-backend", "fused",
               "--batch", "16", "--microbatch", "4"]
LM_ARGV = ["--arch", "stablelm-3b", "--smoke", "--mode", "dpquant", "--fmt",
           "luq_fp4", "--backend", "cuda", "--grad-mode", "ghost",
           "--clip-backend", "ref", "--ghost-microbatch", "2", "--batch", "4",
           "--seq-len", "16"]


@pytest.fixture(autouse=True)
def _no_tf32():
    """float32 without TF32, as the train CLI runs it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _run(argv):
    return train.build_run(train.parse_args(argv))


# --------------------------------------------------------------------------- #
# roofline: the card's terms and the kernels' bounds
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cls", ["bf16", "f32", "tf32"])
def test_derive_gives_one_second_a_term_at_the_cards_peaks(cls):
    """The reference's ``test_roofline_terms`` figures scaled to the H100:
    a peak's worth of FLOPs of each class, the memory rate's bytes and
    NVLink's wire bytes (an all-reduce's twice its buffer) take 1 s each."""
    terms = roofline.derive({
        "flops_by_class": {cls: roofline.PEAK_FLOPS[cls]},
        "bytes": roofline.HBM_BW,
        "collectives": {"all-reduce": roofline.LINK_BW / 2},
        "collective_wire_bytes": roofline.LINK_BW})
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}, 3.35e12, 450e9)
    assert abs(terms.compute_s - 1.0) < 1e-9
    assert abs(terms.memory_s - 1.0) < 1e-9
    assert abs(terms.collective_s - 1.0) < 1e-9
    assert abs(terms.bound_s - 1.0) < 1e-9


# the bounds PERF.md records (kernel table), by their shapes
RECORDED_BOUNDS = {
    "luq_quant 1 x 2,359,296 f32": (
        "luq_quant", dict(rows=1, n=2_359_296, elem=4),
        0.0056341397014925375),
    "clip 64 x 11,190,891": (
        "clip_and_sum", dict(rows=64, n=11_190_891), 0.8685468405970149),
    "luq_matmul decode 4 x 4096 x 64000, 4 keys": (
        "luq_matmul", dict(rows=4, k=4096, n=64000, keys=4),
        0.6896053872053872),
    "decode_attn int8": (
        "decode_attn_fused", dict(batch=4, kv_heads=4, group=8, head_dim=128,
                                  code_dim=128,
                                  live_rows=64 + 301 + 701 + 1024),
        0.000687966567164179),
    "ghost_norm q/k/v/o": (
        "ghost_norm_sq", dict(batch=4, t=256, dx=2560, dg=2560, elem_x=2,
                              elem_g=2), 0.0031300823880597013),
    "kv_quant decode int8": (
        "kv_quant_write", dict(rows=2 * 4 * 4, head_dim=128, code_dim=128,
                               elem=2, slots=4), 3.6967164179104476e-06),
}


@pytest.mark.parametrize("row", sorted(RECORDED_BOUNDS))
def test_kernel_cost_reproduces_the_recorded_bounds(row):
    name, shape, want = RECORDED_BOUNDS[row]
    got, _ = roofline.bound(roofline.kernel_cost(name, **shape), 1980.0)
    assert got == pytest.approx(want, rel=1e-9)


def test_chip_smoke_keeps_no_bound_formula():
    text = open(os.path.join(os.path.dirname(__file__), "..",
                             "chip_smoke.py")).read()
    for name in ("LUQ_OPS", "PHILOX_INT_OPS", "HBM_BYTES_PER_S",
                 "INT32_LANES", "F32_FLOPS_PER_S", "def bound("):
        assert name not in text


# --------------------------------------------------------------------------- #
# op_analysis against the reference's HLO analysis
# --------------------------------------------------------------------------- #
def _reference_flops(fn, *shapes):
    jax = pytest.importorskip("jax")
    from repro.launch.hlo_analysis import analyze
    sds = [jax.ShapeDtypeStruct(s, jax.numpy.float32) for s in shapes]
    return analyze(jax.jit(fn).lower(*sds).compile().as_text())["flops"]


def _traced(fn, *shapes):
    with oa.fake_device() as dev:
        return oa.trace(fn, *(torch.zeros(s, device=dev) for s in shapes))


def test_plain_matmul_flops_equal_the_reference():
    got = _traced(lambda a, b: a @ b, (256, 512), (512, 128))
    want = _reference_flops(lambda a, b: a @ b, (256, 512), (512, 128))
    assert got["flops"] == want == 2 * 256 * 512 * 128
    assert got["flops_by_class"] == {"f32": want}
    assert got["bytes"] == 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert got["warnings"] == {}


def test_conv_flops_equal_the_reference():
    import jax

    def ref_conv(x, w):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                            ("NHWC", "HWIO", "NHWC"))
        return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                            dimension_numbers=dn)

    want = _reference_flops(ref_conv, (2, 16, 16, 8), (3, 3, 8, 4))
    got = _traced(lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
                  (2, 8, 16, 16), (4, 8, 3, 3))
    assert got["flops"] == want == 2 * 2 * 16 * 16 * 4 * 3 * 3 * 8


def test_grouped_conv_backward_counts_each_group_once():
    """A conv's backward costs the forward's multiply-adds a gradient; a
    grouped conv's weight gradient too (the vmap engine's per-example
    convs are grouped, one group an example)."""
    def step(x, w):
        x.requires_grad_()
        w.requires_grad_()
        y = torch.nn.functional.conv2d(x, w, padding=1, groups=4)
        y.sum().backward()

    got = _traced(step, (2, 16, 8, 8), (8, 4, 3, 3))
    macs = 2 * 8 * 8 * 8 * 4 * 3 * 3
    # forward, input and weight gradients, and the sum's reduction
    assert got["flops_by_class"]["f32"] == 3 * 2 * macs + 2 * 8 * 8 * 8


def test_a_python_loop_counts_every_trip():
    def loop(x, w):
        for _ in range(10):
            x = x @ w
        return x

    def nested(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    one = 2 * 128 ** 3
    assert _traced(loop, (128, 128), (128, 128))["flops"] == 10 * one
    assert _traced(nested, (128, 128), (128, 128))["flops"] == 12 * one


def test_bytes_count_views_nothing_and_broadcasts_once():
    def f(x, b):
        y = x.t().t().reshape(-1)         # views
        return y * b.expand(64 * 32)      # one read of b's element

    got = _traced(f, (32, 64), (1,))
    assert got["bytes"] == 4 * (32 * 64 + 1 + 32 * 64)
    assert got["flops"] == 32 * 64


def test_trip_extrapolation_equals_the_full_trace():
    """A SMOKE ResNet-18 vmap step of 4 trips (microbatches): its trips 2
    and 3, extrapolated, are the whole step's trace; so are its kernel
    calls: every trip quantizes every conv's six operands (the stem's
    four) and clips once."""
    run = _run(RESNET_ARGV)
    assert oa.train_trips(run) == (4, 4)
    full = oa._trace_train(run)
    two, three = (oa._trace_train(dataclasses.replace(run, global_batch=4 * t))
                  for t in (2, 3))
    ext = oa.extrapolate(two, three, 4, at=2)
    for key in ("flops", "bytes", "int_ops", "peak_bytes", "ops",
                "flops_by_class", "kernels", "warnings"):
        assert ext[key] == full[key], key
    convs = resnet.conv_layers(run.model)
    assert oa.kernel_calls(full) == {
        "luq_matmul": 0, "kv_quant_write": 0, "decode_attn_fused": 0,
        "luq_quant": 4 * (6 * sum(convs) - 2), "clip_and_sum": 4,
        "ghost_norm_sq": 0}


# --------------------------------------------------------------------------- #
# kernel calls of the port's steps against analytic counts
# --------------------------------------------------------------------------- #
def test_ghost_lm_step_kernel_calls_are_analytic():
    """stablelm-3b SMOKE in ghost mode, pass 1 in 2 chunks: every layer's 7
    projections take one ghost norm a chunk; every projection quantizes 6
    operands in pass 1's chunks and in pass 2 (tapped passes quantize the
    wgrad operands for the norm in the kernel instead: 4 a projection)."""
    run = _run(LM_ARGV)
    res = oa.analyze_train(run)
    L = run.model.n_layers
    calls = oa.kernel_calls(res)
    assert calls["ghost_norm_sq"] == 7 * L * 2
    assert calls["clip_and_sum"] == calls["luq_matmul"] == 0
    assert calls["luq_quant"] > 0
    assert res["warnings"] == {}


@pytest.mark.parametrize("kv_fmt", ["int8", "luq_fp4"])
def test_decode_tick_kernel_calls_are_analytic(kv_fmt):
    """A yi-6b SMOKE decode tick over 4 slots: one K+V write and one
    attention a layer, one logits head."""
    from repro_torch.serve.slots import init_slot_cache
    cfg = get_smoke_config("yi-6b")
    with oa.fake_device() as dev:
        model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"),
                            device=dev)
        params = model.prepare(model.init(0))
        cache = init_slot_cache(model, 4, 32, kv_fmt=kv_fmt)
        tokens = torch.zeros((4,), dtype=torch.int32, device=dev)
        active = torch.ones((4,), dtype=torch.bool, device=dev)
        with torch.no_grad():
            res = oa.trace(lambda *a: model.decode_slots(*a, kv_fmt=kv_fmt),
                           params, cache, tokens, active)
    assert oa.kernel_calls(res) == {
        "luq_matmul": 1, "kv_quant_write": cfg.n_layers,
        "decode_attn_fused": cfg.n_layers, "luq_quant": 0,
        "clip_and_sum": 0, "ghost_norm_sq": 0}
    head = res["kernels"]["luq_matmul"]
    want = roofline.kernel_cost("luq_matmul", rows=4, k=cfg.d_model,
                                n=cfg.padded_vocab, keys=4)
    assert head["bytes"] == want.bytes and head["int_ops"] == want.int_ops


def test_kernel_wrappers_raise_on_fake_tensors_outside_an_analysis():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(2, 8, device="meta")
        with pytest.raises(RuntimeError, match="outside an analysis"):
            ops.luq_quant(x, (3, 5))
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.luq_quant(torch.empty(2, 8, device="meta"), (3, 5))


def test_only_a_named_trace_gets_past_the_gpu_check(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with traced_device("cuda"):
        assert resolve_device(None) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_collectives_count_buffer_and_wire_bytes():
    """``all_reduce_sum`` over two ranks of a fake process group: one
    all-reduce of the concatenated buffer, wire bytes twice it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.parallel.collectives import all_reduce_sum

    class Axis:
        group = None

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        Axis.group = dist.group.WORLD
        with oa.fake_device() as dev:
            tree = {"a": torch.zeros(3, 4, device=dev),
                    "b": torch.zeros(5, device=dev)}
            res = oa.trace(all_reduce_sum, tree, Axis)
    finally:
        dist.destroy_process_group()
    assert res["collectives"] == {"all-reduce": 4.0 * 17}
    assert res["collective_wire_bytes"] == 2 * 4.0 * 17
    terms = roofline.derive(res)
    assert terms.collective_s == 2 * 4.0 * 17 / roofline.LINK_BW


# --------------------------------------------------------------------------- #
# parameters and MODEL_FLOPS against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_params_and_model_flops_equal_the_reference(arch):
    jax = pytest.importorskip("jax")
    from repro.config import QuantConfig as JQuantConfig
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import roofline as jroof
    from repro.models.registry import build_model as jax_build

    jcfg = jax_smoke(arch)
    jparams = jax.eval_shape(jax_build(jcfg, JQuantConfig()).init,
                             jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    with oa.fake_device() as dev:
        model = build_model(cfg, QuantConfig(), device=dev)
        params = eval_shape(lambda: model.init(0), device=dev)
    assert roofline.count_params(params) == jroof.count_params(jparams)
    assert (roofline.active_params(cfg, params)
            == jroof.active_params(jcfg, jparams))
    for kind, B, S in (("train", 8, 64), ("prefill", 2, 128),
                       ("decode", 4, 256)):
        assert roofline.model_flops(cfg, params, kind, B, S, 4) == \
            jroof.model_flops(jcfg, jparams, kind, B, S, 4)


# --------------------------------------------------------------------------- #
# the serve setup and the dry-run
# --------------------------------------------------------------------------- #
def test_serve_setup_checks_kv_fmt_and_gives_abstract_inputs():
    cfg = get_smoke_config("yi-6b")
    run = RunConfig(model=cfg)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    setup = build_serve_setup(model, run, None, 2, 32, kv_fmt="int8")
    params, batch = setup.prefill_abstract
    assert batch == {"tokens": TensorSpec((2, 32), torch.int32)}
    assert params["embed"] == TensorSpec(
        (cfg.padded_vocab, cfg.d_model), torch.float32)
    _, cache, token = setup.decode_abstract
    assert token == TensorSpec((2,), torch.int32)
    # the abstract cache is the prefill's: one decode step runs on it
    real = model.prepare(model.init(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 31))
    _, got = setup.prefill_fn(real, {"tokens": prompt})
    flat = {k: TensorSpec(tuple(v.shape), v.dtype)
            if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    assert flat == cache
    logits, _ = setup.decode_fn(real, got, prompt[:, -1])
    assert logits.shape == (2, cfg.padded_vocab)
    mamba = build_model(get_smoke_config("mamba2-130m"), QuantConfig(),
                        device="cpu")
    with pytest.raises(ValueError, match="does not support kv_fmt"):
        build_serve_setup(mamba, run, None, 2, 32, kv_fmt="int8")


def test_cell_skip_reason_matches_the_reference():
    jax = pytest.importorskip("jax")
    jax.devices()                  # the device count is fixed from here on
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.config import SHAPES as JSHAPES
        from repro.configs import get_config as jget
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from repro_torch.configs import get_config
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])
    for arch in ASSIGNED_ARCHS:
        for name in SHAPES:
            assert (dryrun.cell_skip_reason(get_config(arch), SHAPES[name])
                    == jdry.cell_skip_reason(jget(arch), JSHAPES[name]))


def test_dryrun_card_cell_is_ok_and_production_cells_skip(tmp_path):
    rec = dryrun.run_cell("yi-6b", "decode_32k", "card",
                          overrides={"attn_chunk_q": 32768})
    assert rec["status"] == "ok", rec
    r = rec["roofline"]
    assert r["dominant"] == "memory" and r["bound_s"] == r["memory_s"] > 0
    assert rec["fits"] is (rec["peak_bytes"] <= 80e9)
    # the logits head: one launch a kMaxRows of the 128 rows
    assert rec["kernels"]["luq_matmul"]["calls"] == math.ceil(
        SHAPES["decode_32k"].global_batch / ops.LUQ_MATMUL_MAX_ROWS)
    assert rec["n_devices"] == 1 and rec["n_params"] > 0
    # the production meshes: one rank's shard program in a fake world of
    # 256 or 512 ranks, its model-group collectives counted (the train
    # step at full width, cut to 2 layers here for the test's time; the
    # decode step whole through the CLI)
    import json
    for mesh, devices in (("single", 256), ("multi", 512)):
        cell = dryrun.run_cell("yi-6b", "train_4k", mesh,
                               overrides={"n_layers": 2})
        assert cell["status"] == "ok", cell
        assert cell["n_devices"] == devices
        assert cell["collectives"]["all-reduce"] > 0
        assert cell["fits"] is (cell["peak_bytes"] <= 80e9)
        assert cell["roofline"]["collective_s"] > 0
    for arch in ("yi-6b", "whisper-medium"):
        assert dryrun.main(["--arch", arch, "--shape", "decode_32k",
                            "--mesh", "both", "--out", str(tmp_path)]) == 0
    for mesh, devices in (("single", 256), ("multi", 512)):
        cell = json.loads((tmp_path / f"yi-6b__decode_32k__{mesh}.json")
                          .read_text())
        assert cell["status"] == "ok" and cell["n_devices"] == devices
        # the vocab shards' logits gathered, the row-parallel sums reduced
        assert set(cell["collectives"]) == {"all-gather", "all-reduce"}
        # the logits head on the rank's 4,000 of 64,000 columns
        assert cell["kernels"]["luq_matmul"]["calls"] == math.ceil(
            SHAPES["decode_32k"].global_batch // (devices // 16)
            / ops.LUQ_MATMUL_MAX_ROWS)
        cell = json.loads((tmp_path / f"whisper-medium__decode_32k__{mesh}"
                           ".json").read_text())
        assert cell["status"] == "skipped"
        assert "param_axes" in cell["reason"]
