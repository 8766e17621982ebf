"""PyTorch port vs JAX package: the ResNet family (repro_torch.models.resnet)
and the weight conversion of its nested parameter tree.

The JAX package's SMOKE ResNet-18 parameters (blocks (1, 1): a stride-2
stage, so the asymmetric "SAME" padding is exercised) cross as numpy and
the port reproduces the logits and the loss at fmt ``none`` within
atol 1e-5 (float32 convolutions and GroupNorm, summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.config import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.config import QuantConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_smoke():
    """The JAX package's SMOKE params, a batch, and its logits and loss."""
    cfg = jax_smoke_config("resnet18")
    # one compiled init (the eager one compiles every op on its own)
    params = jax.jit(jresnet.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    image = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    label = rng.integers(0, cfg.num_classes, 4).astype(np.int32)
    flags = jnp.zeros((cfg.policy_len(),), jnp.float32)
    quant = JQuantConfig(fmt="none")
    logits = jresnet.forward(params, jnp.asarray(image), flags, cfg, quant)
    loss = jresnet.loss_fn(params, {"image": jnp.asarray(image),
                                    "label": jnp.asarray(label)},
                           None, flags, cfg, quant)
    return {"params": jax.tree.map(np.asarray, params), "image": image,
            "label": label, "logits": np.asarray(logits),
            "loss": float(loss)}


def test_smoke_forward_and_loss_match_jax(jax_smoke):
    cfg = get_smoke_config("resnet18")
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    params = params_from_numpy(jax_smoke["params"], device="cpu")
    assert set(params) == set(model.init(0))                 # same leaves
    flags = (False,) * cfg.policy_len()
    image = torch.from_numpy(jax_smoke["image"])
    logits = model.forward(params, image, flags)
    np.testing.assert_allclose(logits.numpy(), jax_smoke["logits"],
                               rtol=0, atol=1e-5)
    loss = model.loss_fn(params, {"image": image, "label":
                                  torch.from_numpy(jax_smoke["label"])}, flags)
    np.testing.assert_allclose(float(loss), jax_smoke["loss"], rtol=0,
                               atol=1e-5)
    # fmt none ignores the policy: a quantized layer changes nothing
    again = model.forward(params, image, (True,) * cfg.policy_len())
    torch.testing.assert_close(again, logits, rtol=0, atol=0)


def test_convert_round_trips_the_nested_lists(jax_smoke):
    tree = jax_smoke["params"]
    flat = params_from_numpy(tree, device="cpu")
    assert "stages.1.0.conv1" in flat and "stages.1.0.proj_gn.scale" in flat
    back = params_to_numpy(flat)
    assert isinstance(back["stages"], list)
    assert isinstance(back["stages"][1], list)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_full_config_has_the_reference_parameter_count():
    cfg = get_config("resnet18")
    assert (cfg.resnet_blocks, cfg.num_classes, cfg.image_size,
            cfg.policy_len()) == ((2, 2, 2, 2), 43, 32, 9)
    params = resnet.init_params(0, cfg, "cpu")
    jparams = jax.eval_shape(lambda k: jresnet.init_params(
        k, jax_config("resnet18")), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jparams),
        device="cpu").items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert sum(t.numel() for t in params.values()) == 11_190_891
    assert resnet.conv_layers(cfg) == [1, 2, 2, 3, 2, 3, 2, 3, 2]
    logits = resnet.forward(params, torch.zeros(1, 32, 32, 3),
                            (False,) * 9, cfg, QuantConfig(fmt="none"))
    assert logits.shape == (1, 43) and torch.isfinite(logits).all()
