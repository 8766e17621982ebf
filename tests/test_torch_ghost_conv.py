"""Ghost-mode DP-SGD of the CNNs in the port (``repro_torch.dp.ghost``'s
conv tap, its per-layer fallback for dilated and grouped convs and the
norm-only fallback of the GroupNorm and head leaves) against the JAX
package's ``make_ghost_qconv`` and ghost engine, and against the port's
own vmap engine.

The same numpy inputs go through both packages.  At luq_fp4 both draw
the port's Philox streams: the JAX package's quantizer is replaced, for
this module, by LUQ's plain rounding (``repro.kernels.ref.luq_quant_ref``)
fed ``philox.uniforms(stream_key(seed, fold), 0, n)`` of the (seed, fold)
its key was folded from, over the port's element order (NCHW
activations, OIHW weights).  Tolerances, the JAX package's
(``tests/test_dp_ghost.py``): per-example norms and conv taps rtol 1e-4;
clipped sums rtol 2e-4, atol 2e-5.  The whole-ResNet sums at luq_fp4 are
held at atol 2e-4 of each leaf's largest entry: XLA's and PyTorch's
convolutions sum in another order, and a value at a LUQ step's edge
rounds either way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

import repro.dp.ghost as jghost  # noqa: E402
from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.ref import luq_quant_ref  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.quant import backend as jbackend  # noqa: E402
from repro.quant.fake_quant import qconv2d as jqconv2d  # noqa: E402
from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,  # noqa: E402
                                QuantConfig, RunConfig)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import _flatten, params_from_numpy  # noqa: E402
from repro_torch.data.synthetic import ImageClassDataset  # noqa: E402
from repro_torch.dp import ghost  # noqa: E402
from repro_torch.dp.clip import per_example_clipped_grad_sum  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.quant import philox  # noqa: E402
from repro_torch.train_loop import Trainer  # noqa: E402

torch.set_num_threads(1)

QFMT = "identity_for_tests"         # registered as the identity (fixture)
NORM_TOL = dict(rtol=1e-4, atol=0.0)
SUM_TOL = dict(rtol=2e-4, atol=2e-5)
BASIC = dict(name="rn-basic", family="resnet", resnet_blocks=(1, 1),
             num_classes=10, image_size=8, compute_dtype="float32")
BOTTLENECK = dict(name="rn-bottleneck", family="resnet",
                  resnet_blocks=(8, 1), num_classes=10, image_size=8,
                  compute_dtype="float32")


# --------------------------------------------------------------------------- #
# the JAX package's quantizers fed the port's draws
# --------------------------------------------------------------------------- #
def _jax_key(seed: int, fold: int) -> np.ndarray:
    """The key ``repro.quant.fake_quant._maybe_quant`` draws with."""
    return np.asarray(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(0), seed), fold))


def philox_luq(seeds, n: int):
    """A JAX ``quantize`` op for luq_fp4 that rounds with the port's draws:
    the (seed, fold) whose key it is handed picks the uniforms of
    ``fq.stream_key(seed, fold)`` (``n`` of them, at least every
    operand's size), and a 4-d operand is rounded in the port's element
    order, NCHW for an activation or cotangent, OIHW for a weight (folds
    1 and 2).  A key of no listed seed rounds nothing."""
    pairs = [(s, f) for s in seeds for f in range(6)]
    keys = jnp.asarray(np.stack([_jax_key(s, f) for s, f in pairs]))
    uniforms = jnp.asarray(np.stack([
        philox.uniforms(fq.stream_key(s, f), 0, n).numpy() for s, f in pairs]))
    weight = jnp.asarray([f in (1, 2) for _, f in pairs])

    def rounded(v, u, perm):
        t = jnp.transpose(v, perm)
        flat = t.reshape(-1)
        q = luq_quant_ref(flat, u[:flat.size], jnp.max(jnp.abs(flat)))
        return jnp.transpose(q.reshape(t.shape), np.argsort(perm))

    def quantize(v, key):
        match = jnp.all(keys == key[None], axis=1)
        i = jnp.argmax(match)
        u = uniforms[i]
        if v.ndim == 4:
            q = jnp.where(weight[i], rounded(v, u, (3, 2, 0, 1)),
                          rounded(v, u, (0, 3, 1, 2)))
        else:
            q = rounded(v, u, tuple(range(v.ndim)))
        return jnp.where(jnp.any(match), q, v)

    return quantize


@pytest.fixture(scope="module")
def formats():
    """``QFMT`` as the identity in both packages; the JAX package's
    luq_fp4 on the port's Philox draws (the seeds of the basic ResNet
    and of the layer tests, operands up to 3 x 3 x 128 x 128)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda x, key=None: x)
        mp.setitem(qbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda rows, key: rows.clone())
        mp.setitem(jbackend._REGISTRY, ("quantize", "luq_fp4", "ref"),
                   philox_luq((0, 3, 5, 7, 11, 12, 22, 23, 25),
                              3 * 3 * 128 * 128))
        yield


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _assert_sums_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **(tol or SUM_TOL))


# --------------------------------------------------------------------------- #
# (a) one conv's tap against make_ghost_qconv
# --------------------------------------------------------------------------- #
# (H, W, Cin, Cout, kernel, stride): T^2 against kh kw Cin Cout picks the
# route; stride 2 on an even size pads (0, 1)
LAYERS = {
    "direct": (8, 8, 4, 6, 3, 1),             # T^2 4096 > 216
    "direct-stride2": (8, 8, 4, 6, 3, 2),     # 256 > 216, pads (0, 1)
    "gram": (4, 4, 16, 16, 3, 1),             # 256 <= 2304
    "gram-stride2": (7, 8, 8, 12, 3, 2),      # 16^2 <= 864, pads (1,1)/(0,1)
    "gram-1x1-stride2": (8, 8, 16, 32, 1, 2),  # 256 <= 512
}
B_LAYER = 3


def _layer_inputs(name):
    h, w, cin, cout, k, stride = LAYERS[name]
    rng = np.random.default_rng(sum(LAYERS[name]))
    x = rng.standard_normal((B_LAYER, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B_LAYER, -(-h // stride), -(-w // stride),
                             cout)).astype(np.float32)
    return x, wt, g, k, stride


@pytest.mark.parametrize("fmt", ["none", QFMT, "luq_fp4"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_conv_tap_matches_make_ghost_qconv(formats, layer, fmt):
    x, wt, g, k, stride = _layer_inputs(layer)
    gram = ghost.gram_route_wins(g.shape[1] * g.shape[2], k * k * x.shape[3],
                                 wt.shape[3])
    assert gram == layer.startswith("gram")
    dn = jax.lax.conv_dimension_numbers(x.shape, wt.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    gq = jghost.make_ghost_qconv(fmt, True, True, True, (stride, stride),
                                 "SAME", tuple(dn), (k, k), "ref")

    def tap_one(xe, ge):
        return jax.grad(lambda tap: jnp.sum(
            gq(xe[None], jnp.asarray(wt), jnp.uint32(5), jnp.float32(1.0),
               tap) * ge[None]))(jnp.float32(0.0))

    want = np.asarray(jax.jit(jax.vmap(tap_one))(x, g))
    tap = torch.zeros(B_LAYER, requires_grad=True)
    y = fq.qconv2d(_nchw(x), torch.from_numpy(wt), seed=5, flag=True,
                   stride=stride, fmt=fmt, backend="ref", per_example=True,
                   tap=tap, tap_norm=ghost._conv_tap_sq_norm)
    (y * _nchw(g)).sum().backward()
    np.testing.assert_allclose(tap.grad.numpy(), want, **NORM_TOL)
    # the tap is the squared norm of each example's own wgrad
    if fmt != "luq_fp4":
        w_oihw = torch.from_numpy(wt).permute(3, 2, 0, 1)
        geo = fq._geometry(_nchw(x), w_oihw, stride)
        own = torch.stack([fq._conv_weight(_nchw(x[i:i + 1]), w_oihw.shape,
                                           _nchw(g[i:i + 1]), geo)
                           .square().sum() for i in range(B_LAYER)])
        np.testing.assert_allclose(tap.grad.numpy(), own.numpy(), **NORM_TOL)


@pytest.mark.parametrize("h,w,k,stride", [(8, 8, 3, 1), (8, 8, 3, 2),
                                          (7, 8, 3, 2), (8, 8, 1, 2),
                                          (9, 7, 3, 2)])
def test_conv_patches_are_the_unfold_columns(h, w, k, stride):
    """The batched patches are ``F.unfold``'s columns of the "SAME"-padded
    input, bit for bit (asymmetric pads included)."""
    x = torch.randn(3, 4, h, w, generator=torch.Generator().manual_seed(h))
    geo = fq._geometry(x, torch.zeros(6, 4, k, k), stride)
    want = torch.nn.functional.unfold(
        fq._pad(x, geo), geo.kernel, padding=fq._sym_padding(geo),
        stride=stride).transpose(1, 2)
    assert torch.equal(ghost._conv_patches(x, geo), want)


def test_unquantized_tapped_conv_still_taps():
    """A layer whose flag is off runs through the tap (its weight still
    has a per-example norm) and computes the plain conv."""
    x, wt, g, k, stride = _layer_inputs("direct-stride2")
    tap = torch.zeros(B_LAYER, requires_grad=True)
    y = fq.qconv2d(_nchw(x), torch.from_numpy(wt), seed=5, flag=False,
                   stride=stride, fmt="luq_fp4", per_example=True, tap=tap,
                   tap_norm=ghost._conv_tap_sq_norm)
    plain = fq.qconv2d(_nchw(x), torch.from_numpy(wt), seed=5, flag=False,
                       stride=stride)
    assert torch.equal(y.detach(), plain)
    (y * _nchw(g)).sum().backward()
    assert (tap.grad > 0).all()
    with pytest.raises(ValueError, match="tap_norm"):
        fq.qconv2d(_nchw(x), torch.from_numpy(wt), seed=5, flag=True,
                   tap=tap)


# --------------------------------------------------------------------------- #
# (b) the dilated / grouped toy model of tests/test_dp_ghost.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(11)
    params = {"w1": (rng.standard_normal((3, 3, 4, 8)) * 0.2)
              .astype(np.float32),
              "w2": (rng.standard_normal((3, 3, 4, 8)) * 0.2)
              .astype(np.float32)}
    x = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    return params, x


def _jax_toy(params, x, fmt, clip):
    """The reference's ghost and vmap clipped sums of the toy."""
    from repro.dp.clip import per_example_clipped_grad_sum as jclip_sum

    def loss(p, ex, rng):
        del rng
        h = jqconv2d(ex["x"][None], p["w1"], seed=jnp.uint32(3),
                     flag=jnp.float32(1.0), fmt=fmt, rhs_dilation=(2, 2))
        h = jqconv2d(jax.nn.relu(h), p["w2"], seed=jnp.uint32(7),
                     flag=jnp.float32(1.0), fmt=fmt, feature_groups=2)
        return jnp.sum(h.mean(axis=(1, 2)) ** 2)

    def pel(p, b, rng):
        return jax.vmap(lambda ex: loss(p, ex, rng))(b)

    p = {k: jnp.asarray(v) for k, v in params.items()}
    b = {"x": jnp.asarray(x)}
    gv, _ = jax.jit(lambda p, b: jclip_sum(
        loss, p, b, clip_norm=clip, microbatch_size=4,
        rng=jax.random.PRNGKey(9)))(p, b)
    gg, mg = jax.jit(lambda p, b: jghost.ghost_clipped_grad_sum(
        loss, pel, p, b, clip_norm=clip, rng=jax.random.PRNGKey(9),
        hooked_mask={"w1": True, "w2": True}))(p, b)
    conv = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    return ({k: conv(v) for k, v in gv.items()},
            {k: conv(v) for k, v in gg.items()}, float(mg["grad_norm_max"]))


@pytest.mark.parametrize("fmt", ["none", "luq_fp4"])
def test_dilated_grouped_layers_fall_back_per_layer(formats, toy, fmt):
    """A dilated conv and a grouped one: each layer's tap is the norm of
    each example's own wgrad; the port's ghost sum equals the reference's
    ghost and vmap sums."""
    params_np, x = toy

    def pel(p, b, hooks):
        conv = fq.qconv2d if hooks is None else hooks.qconv2d
        h = conv(b["x"], p["w1"], seed=3, flag=True, fmt=fmt, backend="ref",
                 dilation=2)
        h = conv(torch.relu(h), p["w2"], seed=7, flag=True, fmt=fmt,
                 backend="ref", groups=2)
        return h.mean(dim=(2, 3)).square().sum(dim=1)

    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    batch = {"x": _nchw(x)}
    mask = {"w1": True, "w2": True}
    _, norms = ghost.ghost_per_example_norms(pel, params, batch,
                                             hooked_mask=mask)
    clip = float(norms.median())
    gsum, metrics = ghost.ghost_clipped_grad_sum(pel, params, batch,
                                                 clip_norm=clip,
                                                 hooked_mask=mask)
    jv, jg, jmax = _jax_toy(params_np, x, fmt, clip)
    _assert_sums_close(gsum, jg)
    _assert_sums_close(gsum, jv)
    np.testing.assert_allclose(float(metrics["grad_norm_max"]), jmax,
                               rtol=1e-4)
    # the port's vmap engine: each example's own gradient
    vsum, _ = per_example_clipped_grad_sum(
        lambda p, ex: pel(p, {k: v[None] for k, v in ex.items()}, None)[0],
        params, batch, clip_norm=clip, microbatch_size=4)
    _assert_sums_close(gsum, vsum)


def test_per_example_conv_weight_is_each_examples_wgrad():
    """The batch folded into the groups gives each example's own wgrad,
    for a dilated, a grouped and a strided conv."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 4, 9, 8))
                         .astype(np.float32))
    for stride, dilation, groups in ((1, 2, 1), (1, 1, 2), (2, 2, 2)):
        w = torch.zeros(6, 4 // groups, 3, 3)
        geo = fq._geometry(x, w, stride, dilation, groups)
        g = torch.from_numpy(rng.standard_normal(
            (3, 6, -(-9 // stride), -(-8 // stride))).astype(np.float32))
        got = ghost._per_example_conv_weight(x, g, geo)
        for i in range(3):
            want = fq._conv_weight(x[i:i + 1], w.shape, g[i:i + 1], geo)
            torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# (c) a basic ResNet against the reference's ghost engine
# --------------------------------------------------------------------------- #
B_NET = 4


def _numpy_params(jmodel, seed):
    """Params of the JAX model's shapes from numpy: convs and head
    He-scaled, GroupNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def leaf(path, s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(cfg, n, seed):
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    return {"image": rng.standard_normal((n, s, s, 3)).astype(np.float32),
            "label": rng.integers(0, cfg.num_classes, n).astype(np.int32)}


def _port_ghost(model, params, batch, clip, chunk=0, flags=None):
    if flags is None:
        flags = (True,) * model.config.policy_len()
    pel = lambda p, b, h: model.per_example_loss(p, b, flags,  # noqa: E731
                                                 hooks=h)
    mask = model.ghost_mask(params)
    losses, norms = ghost.ghost_per_example_norms(pel, params, batch,
                                                  hooked_mask=mask,
                                                  microbatch=chunk)
    gsum, metrics = ghost.ghost_clipped_grad_sum(
        pel, params, batch, clip_norm=clip, hooked_mask=mask,
        ghost_microbatch=chunk)
    return losses, norms, gsum, metrics


# the policy of the device-flag cases: the stem and the last block
MIXED = (True, False, True)


@pytest.fixture(scope="module")
def basic_reference(formats):
    """The reference's pass-1 norms and clipped sums of the basic ResNet
    at fmt none and luq_fp4, every layer quantized, and (under ``(QFMT,
    "mixed")``) at the identity format, the layers of ``MIXED``
    quantized; computed once."""
    jcfg = JModelConfig(**BASIC)
    jmodel = jax_build_model(jcfg, JQuantConfig(fmt="none"))
    params_np = _numpy_params(jmodel, 3)
    batch_np = _images(jcfg, B_NET, 4)
    assert len(MIXED) == jcfg.policy_len()
    # a clip norm between the middle two per-example norms (the port's
    # pass 1 at fmt none), so some examples are clipped
    port = build_model(ModelConfig(**BASIC), QuantConfig(fmt="none"),
                       device="cpu")
    _, probe, _, _ = _port_ghost(
        port, params_from_numpy(params_np, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, 1.0)
    clip = float(probe.sort().values[1:3].mean())
    out = {}
    # every layer at fmt none and luq_fp4; the layers of MIXED at QFMT
    for tag, fmt, policy in (("none", "none", None),
                             ("luq_fp4", "luq_fp4", None),
                             ((QFMT, "mixed"), QFMT, MIXED)):
        model = jax_build_model(jcfg, JQuantConfig(fmt=fmt))
        flags = jnp.asarray(policy or (True,) * jcfg.policy_len(),
                            jnp.float32)

        def loss_one(p, ex, r, model=model, flags=flags):
            return model.loss_fn(p, jax.tree.map(lambda v: v[None], ex), r,
                                 flags)

        def pel(p, b, r, model=model, flags=flags):
            return model.per_example_loss(p, b, r, flags)

        grads, losses, norms = jax.jit(lambda p, b: jghost._two_pass(
            loss_one, pel, p, b, clip_norm=clip, rng=jax.random.PRNGKey(0),
            hooked_mask=model.ghost_mask(p), aux=None,
            ghost_microbatch=0))(params_np,
                                 {k: jnp.asarray(v)
                                  for k, v in batch_np.items()})
        out[tag] = (clip, params_from_numpy(jax.tree.map(np.asarray, grads),
                                            device="cpu"),
                    np.asarray(losses), np.asarray(norms))
    return params_np, batch_np, out


@pytest.mark.parametrize("fmt,device_flags", [
    ("none", False), ("luq_fp4", False), (QFMT, True)])
def test_basic_resnet_ghost_matches_jax(basic_reference, fmt, device_flags):
    """Every layer quantized by host flags; or, at the identity format,
    the layers of ``MIXED`` by the trainer's float32 flags tensor, read
    on the device (every conv through the quantized function, the flags
    deciding which fold quantizes), against the reference's program
    under the same flags."""
    params_np, batch_np, ref = basic_reference
    flags = None
    if device_flags:
        flags = torch.tensor(MIXED, dtype=torch.float32)
    clip, jgrads, jlosses, jnorms = ref[(fmt, "mixed") if device_flags
                                        else fmt]
    model = build_model(ModelConfig(**BASIC),
                        QuantConfig(fmt=fmt, backend="ref"), device="cpu")
    params = params_from_numpy(params_np, device="cpu")
    batch = {"image": torch.from_numpy(batch_np["image"]),
             "label": torch.from_numpy(batch_np["label"])}
    losses, norms, gsum, metrics = _port_ghost(model, params, batch, clip,
                                               flags=flags)
    assert 0 < float(metrics["clip_fraction"]) < 1
    np.testing.assert_allclose(norms.numpy(), jnorms, **NORM_TOL)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    if fmt != "luq_fp4":
        _assert_sums_close(gsum, jgrads)
        return
    for name, want in jgrads.items():
        scale = float(want.abs().max())
        np.testing.assert_allclose(gsum[name].numpy(), want.numpy(),
                                   rtol=0, atol=2e-4 * scale, err_msg=name)


# --------------------------------------------------------------------------- #
# (d) the other CNNs: ghost against the port's own vmap engine
# --------------------------------------------------------------------------- #
def _port_numpy_params(model, seed):
    """The port's params as in ``_numpy_params``: convs and head
    He-scaled, GroupNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.init(0).items():
        if t.dim() >= 2:
            a = rng.standard_normal(t.shape) * np.sqrt(
                2.0 / np.prod(t.shape[:-1]))
        else:
            a = (1.0 if name.endswith(".scale") else 0.0) \
                + 0.1 * rng.standard_normal(t.shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _vmap_engine(model, params, batch, clip, flags=None):
    if flags is None:
        flags = (True,) * model.config.policy_len()

    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)

    grads = vmap(grad(loss_one), in_dims=(None, 0),
                 randomness="same")(params, batch)
    norms = torch.sqrt(sum(g.square().sum(dim=tuple(range(1, g.dim())))
                           for g in grads.values()))
    gsum, _ = per_example_clipped_grad_sum(
        loss_one, params, batch, clip_norm=clip,
        microbatch_size=batch["label"].shape[0])
    return norms, gsum


CNNS = {"bottleneck": lambda: ModelConfig(**BOTTLENECK),
        "densenet": lambda: get_smoke_config("densenet121")}


@pytest.mark.parametrize("fmt", ["none", "luq_fp4"])
@pytest.mark.parametrize("case", sorted(CNNS))
def test_ghost_matches_the_vmap_engine(case, fmt):
    """The bottleneck ResNet (every projection kind) and DenseNet, every
    layer quantized, on the ``ref`` backend.  At fmt none the clip norm
    lies between the per-example norms; at luq_fp4 above all of them:
    pass 2 quantizes the clipped cotangent ``s g``, and ``Q(s g) = s
    Q(g)`` holds only where ``s g`` is exact (``repro_torch.dp.ghost``,
    "Floating point"), here for s = 1."""
    cfg = CNNS[case]()
    model = build_model(cfg, QuantConfig(fmt=fmt, backend="ref"),
                        device="cpu")
    params = _port_numpy_params(model, 7)
    b = _images(cfg, B_NET, 8)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    vnorms, _ = _vmap_engine(model, params, batch, 1.0)
    clip = (float(vnorms.sort().values[1:3].mean()) if fmt == "none"
            else 2 * float(vnorms.max()))
    _, vsum = _vmap_engine(model, params, batch, clip)
    _, norms, gsum, metrics = _port_ghost(model, params, batch, clip)
    assert (0 < float(metrics["clip_fraction"]) < 1) == (fmt == "none")
    np.testing.assert_allclose(norms.numpy(), vnorms.numpy(), **NORM_TOL)
    _assert_sums_close(gsum, vsum)


def test_ghost_matches_the_vmap_engine_under_device_flags():
    """As above for DenseNet at luq_fp4 on the ``cuda`` backend (the
    kernels' plain versions), every other layer quantized by the
    trainer's float32 flags tensor, read on the device by both
    engines."""
    cfg = CNNS["densenet"]()
    model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"),
                        device="cpu")
    params = _port_numpy_params(model, 7)
    batch = {k: torch.from_numpy(v) for k, v in _images(cfg, B_NET,
                                                          8).items()}
    flags = torch.tensor([float(i % 2 == 0)
                          for i in range(cfg.policy_len())])
    vnorms, _ = _vmap_engine(model, params, batch, 1.0, flags)
    clip = 2 * float(vnorms.max())
    _, vsum = _vmap_engine(model, params, batch, clip, flags)
    _, norms, gsum, _ = _port_ghost(model, params, batch, clip, flags=flags)
    np.testing.assert_allclose(norms.numpy(), vnorms.numpy(), **NORM_TOL)
    _assert_sums_close(gsum, vsum)


# --------------------------------------------------------------------------- #
# (e) chunking, (f) masks and state, (g) loop and scan
# --------------------------------------------------------------------------- #
def test_ghost_microbatch_changes_nothing():
    """Pass 1 in chunks of 1 and 2 against the whole batch at fmt none:
    per-example norms within 1e-5 (a conv of another batch shape sums in
    another order), clipped sums within rtol 1e-5 and atol 1e-5 of each
    leaf's largest entry (the clip factors move by ulps)."""
    cfg = ModelConfig(**BASIC)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    params = _port_numpy_params(model, 2)
    batch = {k: torch.from_numpy(v) for k, v in _images(cfg, 4, 5).items()}
    whole = _port_ghost(model, params, batch, clip=4.0)
    for chunk in (1, 2):
        part = _port_ghost(model, params, batch, clip=4.0, chunk=chunk)
        np.testing.assert_allclose(part[1].numpy(), whole[1].numpy(),
                                   rtol=1e-5)
        for name, want in whole[2].items():
            np.testing.assert_allclose(
                part[2][name].numpy(), want.numpy(), rtol=1e-5,
                atol=1e-5 * float(want.abs().max()), err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        _port_ghost(model, params, batch, clip=4.0, chunk=3)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "densenet121"])
def test_masks_and_state_bytes_equal_the_reference(arch):
    """The full configs: the hooked mask leaf for leaf (every conv and
    projection), the fallback leaves and ``per_example_state_bytes``."""
    jmodel = jax_build_model(jax_config(arch), JQuantConfig(fmt="none"))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jmask = jmodel.ghost_mask(shapes)
    want = jghost.per_example_state_bytes(shapes, jmask, 256)
    model = build_model(get_config(arch), QuantConfig(fmt="none"),
                        device="cpu")
    params = model.init(0)
    mask = model.ghost_mask(params)
    assert mask == {k: bool(v) for k, v in _flatten(jmask)}
    assert ghost.per_example_state_bytes(params, mask, 256) == want
    assert 0 < want["params_nonhooked"] < want["params_total"] // 10


def test_a_leaf_that_no_hook_covers_must_be_tapped():
    """A fallback leaf the loss does not hand to ``GhostHooks.leaf``
    raises, and so does one it takes twice."""
    cfg = ModelConfig(**BASIC)
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in _images(cfg, 2, 1).items()}
    flags = (True,) * cfg.policy_len()
    mask = dict(model.ghost_mask(params), **{"stages.0.0.conv1": False})
    with pytest.raises(NotImplementedError, match="stages.0.0.conv1"):
        ghost.ghost_per_example_norms(
            lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h),
            params, batch, hooked_mask=mask)
    hooks = ghost.GhostHooks(tap=torch.zeros(2, requires_grad=True),
                             fallback=frozenset({"head.b"}))
    hooks.leaf("head.b", params["head.b"], 2)
    with pytest.raises(ValueError, match="twice"):
        hooks.leaf("head.b", params["head.b"], 2)


def _ghost_run(executor):
    model = ModelConfig(name="cnn", family="resnet", resnet_blocks=(1, 1),
                        num_classes=8, image_size=16,
                        compute_dtype="float32")
    return RunConfig(
        model=model, quant=QuantConfig(fmt="luq_fp4"),
        dp=DPConfig(clip_norm=1.0, noise_multiplier=1.0, microbatch_size=8,
                    grad_mode="ghost", ghost_microbatch=4,
                    quant_fraction=0.6, analysis_interval=2,
                    analysis_reps=1, analysis_batch_size=8),
        optim=OptimConfig(name="momentum", lr=0.1, schedule="cosine"),
        global_batch=8, steps_per_epoch=3, steps=6,
        epoch_executor=executor)


def test_loop_equals_scan_for_a_cnn_ghost_trainer():
    """Two epochs of 3 steps under DPQuant, ghost mode, luq_fp4: the scan
    executor's params, momentum, losses and epsilon bit for bit the
    loop's."""
    ds = ImageClassDataset(n=128, num_classes=8, image_size=16, noise=0.4)
    out = []
    for executor in ("loop", "scan"):
        tr = Trainer(_ghost_run(executor), ds, mode="dpquant", device="cpu")
        out.append((tr, tr.train(2)))
    (a, ha), (b, hb) = out
    assert [h.loss for h in ha] == [h.loss for h in hb]
    assert [h.eps for h in ha] == [h.eps for h in hb]
    assert [h.quantized_layers for h in ha] == [h.quantized_layers
                                                for h in hb]
    for x, y in zip(torch.utils._pytree.tree_leaves((a.params, a.opt_state)),
                    torch.utils._pytree.tree_leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)
