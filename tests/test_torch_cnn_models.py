"""PyTorch port vs JAX package: the bottleneck ResNet (ResNet-50's blocks)
and DenseNet (repro_torch.models.resnet, repro_torch.models.densenet).

The same numpy params and images go through both packages.  Forward and
loss agree at fmt ``none`` and, with every layer quantized, at a format
registered as the identity in both packages (the quantized conv's path
with nothing rounded), within atol 1e-5 (float32 convolutions and
GroupNorm, summed in another order).  The full configs have the
reference's parameter count, leaf shapes, policy length and convs per
policy layer; DenseNet's last policy layer quantizes no conv in either
package.

The bottleneck config is the test's own: blocks (8, 1) (a sum above 8,
so bottleneck blocks; an expansion-4 projection at stride 1 and a
stride-2 projection).  The reference's resnet50 SMOKE config, blocks
(2, 2, 2, 2), sums to 8 and builds basic blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import densenet as jdensenet  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro.quant import backend as jbackend  # noqa: E402
from repro_torch.config import ModelConfig, QuantConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import densenet, resnet  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402

torch.set_num_threads(1)

QFMT = "identity_for_tests"
B = 3
BOTTLENECK = dict(name="rn-bottleneck", family="resnet",
                  resnet_blocks=(8, 1), num_classes=10, image_size=8,
                  compute_dtype="float32")


def numpy_params(init, cfg, seed):
    """Params of the reference's shapes from numpy: convs and the head
    He-scaled, GroupNorm scales 1 + N(0, 0.1^2) and biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


CASES = {
    "bottleneck": (jresnet, JModelConfig(**BOTTLENECK),
                   ModelConfig(**BOTTLENECK)),
    "densenet": (jdensenet, jax_smoke_config("densenet121"),
                 get_smoke_config("densenet121")),
}


@pytest.fixture(scope="module")
def identity_format():
    """``QFMT`` registered in both packages as the identity quantizer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda x, key=None: x)
        mp.setitem(qbackend._REGISTRY, ("quantize", QFMT, "ref"),
                   lambda rows, key: rows.clone())
        yield QFMT


@pytest.mark.parametrize("fmt", ["none", QFMT])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_loss_match_jax(case, fmt, identity_format):
    jmod, jcfg, cfg = CASES[case]
    params = numpy_params(jmod.init_params, jcfg, seed=7)
    rng = np.random.default_rng(1)
    s = cfg.image_size
    image = rng.standard_normal((B, s, s, 3)).astype(np.float32)
    label = rng.integers(0, cfg.num_classes, B).astype(np.int32)
    quantized = fmt != "none"
    jflags = jnp.full((jcfg.policy_len(),), float(quantized), jnp.float32)
    jquant = JQuantConfig(fmt=fmt)

    @jax.jit
    def reference(p, x, y):
        return (jmod.forward(p, x, jflags, jcfg, jquant),
                jmod.loss_fn(p, {"image": x, "label": y}, None, jflags, jcfg,
                             jquant))

    want, want_loss = reference(params, image, label)
    want, want_loss = np.asarray(want), float(want_loss)

    model = build_model(cfg, QuantConfig(fmt=fmt), device="cpu")
    tparams = params_from_numpy(params, device="cpu")
    assert set(tparams) == set(model.init(0))                # same leaves
    assert {k: tuple(v.shape) for k, v in model.init(0).items()} == \
        {k: tuple(v.shape) for k, v in tparams.items()}
    flags = (quantized,) * cfg.policy_len()
    timage = torch.from_numpy(image)
    logits = model.forward(tparams, timage, flags)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)
    loss = model.loss_fn(tparams, {"image": timage,
                                   "label": torch.from_numpy(label)}, flags)
    np.testing.assert_allclose(float(loss), want_loss, rtol=0, atol=1e-5)


def test_bottleneck_blocks_and_projections():
    cfg = ModelConfig(**BOTTLENECK)
    assert cfg.policy_len() == 10
    params = resnet.init_params(0, cfg, "cpu")
    assert tuple(params["stages.0.0.conv1"].shape) == (1, 1, 64, 64)
    assert tuple(params["stages.0.0.conv3"].shape) == (1, 1, 64, 256)
    assert tuple(params["stages.0.0.proj"].shape) == (1, 1, 64, 256)
    assert "stages.0.1.proj" not in params             # 256 -> 256, stride 1
    assert tuple(params["stages.1.0.conv2"].shape) == (3, 3, 128, 128)
    assert tuple(params["stages.1.0.proj"].shape) == (1, 1, 256, 512)
    assert resnet.conv_layers(cfg) == [1, 4] + [3] * 7 + [4]
    # the reference's resnet50 SMOKE config builds basic blocks
    smoke = get_smoke_config("resnet50")
    assert "stages.0.0.conv3" not in resnet.init_params(0, smoke, "cpu")


def _reference_convs(jmod, jcfg):
    """Quantized convs of each policy layer in the reference's forward,
    counted by the flag index each ``qconv2d`` call receives (traced by
    ``jax.eval_shape``, nothing computed)."""
    counts = np.zeros(jcfg.policy_len(), int)
    orig = jmod.qconv2d

    def counting(x, w, *, flag, **kw):
        counts[int(flag)] += 1
        return orig(x, w, flag=jnp.float32(0.0), **kw)

    flags = np.arange(jcfg.policy_len(), dtype=np.float32)
    shapes = jax.eval_shape(lambda k: jmod.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    s = jcfg.image_size
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "qconv2d", counting)
        jax.eval_shape(lambda p, x: jmod.forward(
            p, x, flags, jcfg, JQuantConfig(fmt="none")), shapes,
            jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32))
    return counts.tolist(), shapes


@pytest.mark.parametrize("arch,n_params,policy_len", [
    ("resnet50", 23_588_459, 17), ("densenet121", 6_990_251, 62)])
def test_full_config_matches_the_reference(arch, n_params, policy_len):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mod, jmod = {"resnet50": (resnet, jresnet),
                 "densenet121": (densenet, jdensenet)}[arch]
    assert cfg.policy_len() == jcfg.policy_len() == policy_len
    convs, jshapes = _reference_convs(jmod, jcfg)
    assert mod.conv_layers(cfg) == convs
    params = mod.init_params(0, cfg, "cpu")
    want = {k: tuple(v.shape) for k, v in params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jshapes),
        device="cpu").items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert sum(t.numel() for t in params.values()) == n_params
    if arch == "densenet121":
        # the stem shares layer 0 with the first dense layer; the last
        # index reads no conv
        assert convs[0] == 3 and convs[-1] == 0 and sum(convs) == 120
    logits = mod.forward(params, torch.zeros(1, 32, 32, 3),
                         (False,) * policy_len, cfg, QuantConfig(fmt="none"))
    assert logits.shape == (1, 43) and torch.isfinite(logits).all()


def test_densenet_last_flag_is_dead_in_both_packages():
    """At luq_fp4, setting only the last policy flag changes no logit in
    either package; setting the first one does."""
    jcfg, cfg = jax_smoke_config("densenet121"), get_smoke_config("densenet121")
    assert jcfg.policy_len() == cfg.policy_len() == 6
    params = numpy_params(jdensenet.init_params, jcfg, seed=3)
    image = np.random.default_rng(2).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    n = cfg.policy_len()
    last = tuple(i == n - 1 for i in range(n))
    first = tuple(i == 0 for i in range(n))

    forward = jax.jit(lambda p, x, fl: jdensenet.forward(
        p, x, fl, jcfg, JQuantConfig(fmt="luq_fp4")))

    def jlogits(flags):
        return np.asarray(forward(params, image,
                                  jnp.asarray(flags, jnp.float32)))

    base = jlogits((False,) * n)
    np.testing.assert_array_equal(jlogits(last), base)
    assert not np.array_equal(jlogits(first), base)

    model = build_model(cfg, QuantConfig(fmt="luq_fp4"), device="cpu")
    tp = params_from_numpy(params, device="cpu")
    timage = torch.from_numpy(image)
    tbase = model.forward(tp, timage, (False,) * n)
    assert torch.equal(model.forward(tp, timage, last), tbase)
    assert not torch.equal(model.forward(tp, timage, first), tbase)
    assert densenet.conv_layers(cfg) == [3, 2, 1, 2, 2, 0]
