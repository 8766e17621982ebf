"""PyTorch port vs JAX package: the LUQ-FP4 quantizer and the fake-quantized
convolution (repro_torch.kernels luq_quant, repro_torch.quant.fake_quant).

Kernel level, bitwise: the port's plain version of ``luq_quant`` (what its
CUDA kernel is held to on the card) against the JAX package's Pallas
kernel ``luq_quant_2d`` in interpret mode and its ``luq_quant_ref`` under
``vmap``, on the same numpy inputs and uniforms, edge values included.

Above the kernel the port draws its own uniforms, so ``qconv2d`` is held
statistically: its mean over many streams lies within 5 standard errors
of the unquantized convolution (fixed, non-degenerate shapes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.func import vmap  # noqa: E402

from repro.kernels.luq_quant import luq_quant_2d  # noqa: E402
from repro.kernels.ref import luq_quant_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402

torch.set_num_threads(1)

ALPHA = 4.0


def _edge_rows(rng, rows, n):
    """(rows, n) float32 with alpha = 4 in every row and the rounding's
    edges mixed in: exact powers of two times alpha, one ulp below them
    (towards zero), their negatives and zeros."""
    x = np.clip(rng.standard_normal((rows, n)), -3.5, 3.5).astype(np.float32)
    levels = (ALPHA * 2.0 ** -np.arange(0, 9)).astype(np.float32)
    below = np.nextafter(levels, np.float32(0))
    edges = np.concatenate([levels, -levels, below, -below,
                            np.zeros(4, np.float32)])
    x[:, 0] = ALPHA
    x[:, 1:1 + edges.size] = edges
    return x


def test_plain_version_matches_the_pallas_kernel_bitwise():
    rng = np.random.default_rng(0)
    x = _edge_rows(rng, 8, 256)
    u = rng.random((8, 256), dtype=np.float32)
    jk = np.asarray(luq_quant_2d(jnp.asarray(x), jnp.asarray(u),
                                 jnp.float32(ALPHA), block=(8, 128),
                                 interpret=True))
    ours = ops.luq_quant(torch.from_numpy(x), torch.from_numpy(u),
                         torch.full((8,), ALPHA)).numpy()
    np.testing.assert_array_equal(ours, jk)
    assert len(np.unique(np.abs(ours))) > 5          # many grid levels hit


def test_plain_version_of_an_all_zero_tensor_is_zero():
    x = np.zeros((8, 128), np.float32)
    u = np.random.default_rng(1).random((8, 128), dtype=np.float32)
    jk = np.asarray(luq_quant_2d(jnp.asarray(x), jnp.asarray(u),
                                 jnp.float32(0.0), block=(8, 128),
                                 interpret=True))
    ours = ops.luq_quant(torch.from_numpy(x), torch.from_numpy(u),
                         torch.zeros(8)).numpy()
    np.testing.assert_array_equal(ours, jk)
    assert not ours.any()


def test_per_row_alpha_with_shared_uniforms_matches_vmapped_reference():
    """Rows of a microbatch: each its own alpha (one row all zero), one
    draw shared by every row, as the JAX package's vmap DP path computes
    with an unbatched key."""
    rng = np.random.default_rng(2)
    x = _edge_rows(rng, 6, 300) * rng.random((6, 1)).astype(np.float32)
    x[3] = 0.0
    u = rng.random(300, dtype=np.float32)
    alpha = np.abs(x).max(axis=1)
    want = np.asarray(jax.vmap(lambda xr, a: luq_quant_ref(
        xr, jnp.asarray(u), a))(jnp.asarray(x), jnp.asarray(alpha)))
    ours = ops.luq_quant(torch.from_numpy(x), torch.from_numpy(u),
                         torch.from_numpy(alpha)).numpy()
    np.testing.assert_array_equal(ours, want)
    # the backend's quantize op computes the per-row alpha itself
    q, actual = qbackend.get_quantizer("luq_fp4", "cuda")
    assert actual == "cuda"
    np.testing.assert_array_equal(
        q(torch.from_numpy(x), torch.from_numpy(u)).numpy(), want)


def test_quantize_op_falls_back_to_ref_for_formats_without_a_kernel(
        monkeypatch):
    monkeypatch.delenv(qbackend.ENV_VAR, raising=False)
    assert qbackend.get_quantizer("luq_fp4", "cuda")[1] == "cuda"
    for fmt in ("int4", "fp8_e4m3", "bf16", "none"):
        assert qbackend.get_quantizer(fmt, "cuda")[1] == "ref"
    # int4 is per row too: each row on its own max|row| / 7 grid
    q, _ = qbackend.get_quantizer("int4", "cuda")
    rows = torch.tensor([[7.0, 3.5, -7.0], [0.7, 0.1, 0.0]])
    out = q(rows, torch.full((3,), 0.5))       # rounds up when u < frac
    torch.testing.assert_close(out, torch.tensor([[7.0, 3.0, -7.0],
                                                  [0.7, 0.1, 0.0]]))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fake_quant_under_vmap_is_per_example_with_one_shared_draw(
        monkeypatch, backend):
    monkeypatch.delenv(qbackend.ENV_VAR, raising=False)
    x = torch.randn(5, 3, 4, 4) * torch.arange(1, 6).reshape(5, 1, 1, 1)
    got = vmap(lambda ex: fq.fake_quant(ex, "luq_fp4", backend, 7, 2),
               randomness="same")(x)
    rows = x.reshape(5, -1)
    u = fq.uniforms(7, 2, rows.shape[1], "cpu")
    want = ref.luq_quant_ref(rows, u, rows.abs().amax(dim=1))
    torch.testing.assert_close(got.reshape(5, -1), want, rtol=0, atol=0)
    # outside vmap the tensor is quantized whole: one scale, one draw
    whole = fq.fake_quant(x, "luq_fp4", backend, 7, 2)
    uw = fq.uniforms(7, 2, x.numel(), "cpu")
    torch.testing.assert_close(
        whole.reshape(1, -1),
        ref.luq_quant_ref(x.reshape(1, -1), uw, x.abs().amax().reshape(1)),
        rtol=0, atol=0)


def test_streams_are_fixed_per_seed_and_fold_and_do_not_collide():
    a = fq.uniforms(3, 1, 64, "cpu")
    assert torch.equal(a, fq.uniforms(3, 1, 64, "cpu"))       # step-invariant
    others = [fq.uniforms(s, f, 64, "cpu") for s, f in
              ((4, 0), (3, 0), (3, 2), (2, 2), (4, 1))]
    assert all(not torch.equal(a, o) for o in others)


@pytest.mark.parametrize("size,stride", [(8, 1), (8, 2), (7, 2)])
def test_same_padding_matches_xla(size, stride):
    """The conv at fmt none equals the JAX package's "SAME" conv, whose
    stride-2 3x3 case pads (0, 1) on an even input."""
    rng = np.random.default_rng(size + stride)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = fq.qconv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w), seed=0, flag=True, stride=stride,
                     fmt="none")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_qconv2d_luq_fp4_is_unbiased_over_streams(monkeypatch):
    """E[Q(x) * Q(w)] = x * w: the mean over 400 seeds (independent
    streams) lies within 5 standard errors (+1e-4) of the exact conv at
    every output."""
    monkeypatch.delenv(qbackend.ENV_VAR, raising=False)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=gen)
    w = torch.randn(3, 3, 4, 5, generator=gen)
    exact = F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)
    draws = torch.stack([fq.qconv2d(x, w, seed=s, flag=True, fmt="luq_fp4",
                                    backend="cuda") for s in range(400)])
    mean, se = draws.mean(0), draws.std(0) / 400 ** 0.5
    assert ((mean - exact).abs() <= 5 * se + 1e-4).all()
    assert (draws[0] != exact).any()               # it did quantize


def test_qconv2d_backward_quantizes_six_operands_per_conv(monkeypatch):
    """Under the DP engine's vmap one quantized conv calls the quantizer
    six times: four over the examples' rows (x fold 0, g folds 3 and 5,
    x fold 4) and two on the weight whole (folds 1 and 2); a conv whose
    flag is off calls it not at all."""
    calls = []
    orig = fq._quantize_rows

    def spy(rows, fmt, backend, seed, fold):
        calls.append((fold, rows.shape[0]))
        return orig(rows, fmt, backend, seed, fold)

    monkeypatch.setattr(fq, "_quantize_rows", spy)
    w = torch.randn(3, 3, 2, 4)
    x = torch.randn(5, 2, 6, 6)

    def loss(w, ex, flag):
        return fq.qconv2d(ex[None], w, seed=1, flag=flag, stride=2,
                          fmt="luq_fp4", backend="ref").square().sum()

    for flag in (False, True):
        calls.clear()
        g = vmap(torch.func.grad(loss), in_dims=(None, 0, None),
                 randomness="same")(w, x, flag)
        assert g.shape == (5, 3, 3, 2, 4)
    assert sorted(calls) == [(0, 5), (1, 1), (2, 1), (3, 5), (4, 5), (5, 5)]
