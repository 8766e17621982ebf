"""PyTorch port vs JAX package: the LUQ-FP4 quantizer and the fake-quantized
convolution (repro_torch.kernels luq_quant, repro_torch.quant.fake_quant).

Kernel level, bitwise: the port's keyed plain version of ``luq_quant``
(what its CUDA kernel is held to on the card: the row max taken itself,
the Philox draws of a key) against the JAX package's Pallas kernel
``luq_quant_2d`` in interpret mode and its ``luq_quant_ref`` under
``vmap``, fed the same Philox draws (``philox.uniforms(key, 0, n)``) as
numpy arrays, in float32 and in bf16 (the reference given the same
dtype), edge values included.

Above the kernel the port draws its own streams, one Philox key per
(seed, fold), so ``qconv2d`` is held statistically: its mean over many
streams lies within 5 standard errors of the unquantized convolution
(fixed, non-degenerate shapes).
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
from repro_torch.models.common import logits_key  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.quant import formats, philox  # noqa: E402

torch.set_num_threads(1)

ALPHA = 4.0
KEY = fq.stream_key(11, 3)


def _edge_rows(rng, rows, n, dtype=torch.float32):
    """(rows, n) in ``dtype`` with alpha = 4 in every row and the
    rounding's edges mixed in: exact powers of two times alpha, one ulp of
    ``dtype`` below them (towards zero), their negatives and zeros."""
    x = np.clip(rng.standard_normal((rows, n)), -3.5, 3.5).astype(np.float32)
    x = torch.from_numpy(x).to(dtype)
    levels = (ALPHA * 2.0 ** -torch.arange(0, 9)).to(dtype)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    below = (levels.view(ints) - 1).view(dtype)        # positive: one ulp down
    edges = torch.cat([levels, -levels, below, -below,
                       torch.zeros(4, dtype=dtype)])
    x[:, 0] = ALPHA
    x[:, 1:1 + edges.numel()] = edges
    return x


def _jnp(t):
    """``t`` as a JAX array of the same dtype."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_the_pallas_kernel_bitwise(dtype):
    """Every row's max is alpha = 4, so the Pallas kernel's scalar alpha
    is each row's own; its uniforms are the key's draw, one per column,
    the same for every row."""
    x = _edge_rows(np.random.default_rng(0), 8, 256, dtype)
    u = philox.uniforms(KEY, 0, 256).numpy()
    jk = luq_quant_2d(_jnp(x), jnp.asarray(np.tile(u, (8, 1))),
                      jnp.float32(ALPHA), block=(8, 128), interpret=True)
    ours = ops.luq_quant(x, KEY)
    assert ours.dtype == dtype and jk.dtype == _jnp(x).dtype
    np.testing.assert_array_equal(ours.float().numpy(), _np(jk))
    assert len(np.unique(np.abs(_np(jk)))) > 5        # many grid levels hit


def test_plain_version_of_an_all_zero_tensor_is_zero():
    x = np.zeros((8, 128), np.float32)
    u = np.tile(philox.uniforms(KEY, 0, 128).numpy(), (8, 1))
    jk = np.asarray(luq_quant_2d(jnp.asarray(x), jnp.asarray(u),
                                 jnp.float32(0.0), block=(8, 128),
                                 interpret=True))
    ours = ops.luq_quant(torch.from_numpy(x), KEY).numpy()
    np.testing.assert_array_equal(ours, jk)
    assert not ours.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_row_alpha_with_shared_uniforms_matches_vmapped_reference(dtype):
    """Rows of a microbatch: each its own alpha (one row all zero), one
    draw shared by every row, as the JAX package's vmap DP path computes
    with an unbatched key."""
    rng = np.random.default_rng(2)
    x = _edge_rows(rng, 6, 300, dtype) * torch.from_numpy(
        rng.random((6, 1)).astype(np.float32)).to(dtype)
    x[3] = 0.0
    u = jnp.asarray(philox.uniforms(KEY, 0, 300).numpy())
    alpha = _jnp(x.abs().amax(dim=1))
    want = _np(jax.vmap(lambda xr, a: luq_quant_ref(xr, u, a))(_jnp(x),
                                                                alpha))
    ours = ops.luq_quant(x, KEY)
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours.float().numpy(), want)
    # the backend's quantize op on both backends: the same stream
    for backend in ("ref", "cuda"):
        q, actual = qbackend.get_quantizer("luq_fp4", backend)
        assert actual == backend
        np.testing.assert_array_equal(q(x, KEY).float().numpy(), want)


@pytest.mark.parametrize("shape", [(1, 4096), (3, 1001), (5, 2)])
def test_bf16_operand_rounds_in_float32_and_returns_bf16(shape):
    """A bf16 operand is quantized as its float32 values, cast back with
    round-to-nearest-even: exactly ``q(rows.float(), key).to(bf16)``, the
    values of the quantize op when it copied operands to float32; the
    codes are those of the float32 values."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    x = (x * 3).bfloat16()
    key = fq.stream_key(2, 4)
    got = ops.luq_quant(x, key)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.luq_quant_ref(x.float(), key).bfloat16())
    assert torch.equal(ops.luq_quant(x, key, codes=True),
                       ref.luq_quant_ref(x.float(), key, codes=True))


@pytest.mark.parametrize("fmt", ["luq_fp4", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_and_cuda_quantize_agree_bitwise_on_cpu(fmt, dtype, monkeypatch):
    """On CPU tensors both backends' ``quantize`` op draw the key's
    Philox stream and give the same bits (int4 runs on ``ref`` for both),
    the stream formats.py's quantizer sees."""
    monkeypatch.delenv(qbackend.ENV_VAR, raising=False)
    rows = (torch.randn(4, 333, generator=torch.Generator().manual_seed(6))
            * torch.arange(1, 5)[:, None]).to(dtype)
    rows[2] = 0.0
    key = fq.stream_key(9, 1)
    ref_q, _ = qbackend.get_quantizer(fmt, "ref")
    cuda_q, _ = qbackend.get_quantizer(fmt, "cuda")
    got = cuda_q(rows, key)
    assert got.dtype == dtype and torch.equal(got, ref_q(rows, key))
    u = philox.uniforms(key, 0, 333)
    xf = rows.float()
    want = formats.make_quantizer(fmt)(xf, u, xf.abs().amax(1, keepdim=True))
    assert torch.equal(got, want.to(dtype))


def test_quantize_op_falls_back_to_ref_for_formats_without_a_kernel(
        monkeypatch):
    monkeypatch.delenv(qbackend.ENV_VAR, raising=False)
    assert qbackend.get_quantizer("luq_fp4", "cuda")[1] == "cuda"
    for fmt in ("int4", "fp8_e4m3", "bf16", "none"):
        assert qbackend.get_quantizer(fmt, "cuda")[1] == "ref"
    # int4 is per row too: each row on its own max|row| / 7 grid, rounded
    # up where the key's uniform lies below the fraction
    q, _ = qbackend.get_quantizer("int4", "cuda")
    rows = torch.tensor([[7.0, 3.5, -7.0], [0.7, 0.15, 0.0]])
    u = philox.uniforms(KEY, 0, 3)
    step = rows.abs().amax(dim=1, keepdim=True) / 7.0
    y = rows / step
    want = (torch.floor(y) + (u < y - torch.floor(y)).float()) * step
    torch.testing.assert_close(q(rows, KEY), want, rtol=0, atol=0)
    assert q(rows, KEY)[0, 0].item() == 7.0 and q(rows, KEY)[1, 2] == 0


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fake_quant_under_vmap_is_per_example_with_one_shared_draw(
        monkeypatch, backend):
    monkeypatch.delenv(qbackend.ENV_VAR, raising=False)
    x = torch.randn(5, 3, 4, 4) * torch.arange(1, 6).reshape(5, 1, 1, 1)
    got = vmap(lambda ex: fq.fake_quant(ex, "luq_fp4", backend, 7, 2),
               randomness="same")(x)
    rows = x.reshape(5, -1)
    want = ref.luq_quant_ref(rows, fq.stream_key(7, 2))
    torch.testing.assert_close(got.reshape(5, -1), want, rtol=0, atol=0)
    # outside vmap the tensor is quantized whole: one scale, one draw
    whole = fq.fake_quant(x, "luq_fp4", backend, 7, 2)
    torch.testing.assert_close(
        whole.reshape(1, -1),
        ref.luq_quant_ref(x.reshape(1, -1), fq.stream_key(7, 2)),
        rtol=0, atol=0)


def test_streams_are_fixed_per_seed_and_fold_and_do_not_collide():
    """One Philox key per (seed, fold): the same key and draws at every
    call (the draws do not change from step to step), distinct keys and
    draws across (seed, fold) pairs, and no key of the logits head's."""
    key = fq.stream_key(3, 1)
    a = philox.row_uniforms(key, 64)
    assert fq.stream_key(3, 1) == key
    assert torch.equal(a, philox.uniforms(fq.stream_key(3, 1), 0, 64))
    pairs = [(s, f) for s in (0, 1, 2, 3, 4, 17, 2 ** 32 - 1)
             for f in range(8)]
    keys = {fq.stream_key(s, f) for s, f in pairs}
    assert len(keys) == len(pairs)
    others = [philox.uniforms(fq.stream_key(s, f), 0, 64) for s, f in
              ((4, 0), (3, 0), (3, 2), (2, 2), (4, 1))]
    assert all(not torch.equal(a, o) for o in others)
    logits = {logits_key(f) for f in range(4096)}
    assert not keys & logits
    with pytest.raises(ValueError):
        fq.stream_key(3, 8)


def test_cpu_draws_are_cached_bounded_and_unchanged(monkeypatch):
    """The CPU cache of row draws returns the stream's own values, keeps
    a key's tensor for the next call and drops the least recently used
    beyond its byte bound."""
    monkeypatch.setattr(philox, "_ROW_CACHE", type(philox._ROW_CACHE)())
    monkeypatch.setattr(philox, "_ROW_CACHE_BYTES", 4 * 300)
    a = philox.row_uniforms((1, 2), 100)
    assert torch.equal(a, philox.uniforms((1, 2), 0, 100))
    assert philox.row_uniforms((1, 2), 100) is a
    philox.row_uniforms((3, 4), 100)
    philox.row_uniforms((5, 6), 100)
    philox.row_uniforms((1, 2), 100)               # most recent again
    philox.row_uniforms((7, 8), 100)               # drops (3, 4)
    assert list(philox._ROW_CACHE) == [((5, 6), 100), ((1, 2), 100),
                                       ((7, 8), 100)]
    big = philox.row_uniforms((9, 9), 1000)        # above the bound: kept out
    assert torch.equal(big, philox.uniforms((9, 9), 0, 1000))
    assert ((9, 9), 1000) not in philox._ROW_CACHE


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
    flag is off calls it not at all.  A conv whose input needs no
    gradient (the stem, on the images) runs no dgrad: folds 2 and 3 are
    not called."""
    calls = []
    orig = fq._quantize_rows

    def spy(rows, fmt, backend, seed, fold, flag=None):
        calls.append((fold, rows.shape[0]))
        return orig(rows, fmt, backend, seed, fold, flag)

    monkeypatch.setattr(fq, "_quantize_rows", spy)
    w = torch.randn(3, 3, 2, 4)
    x = torch.randn(5, 2, 6, 6)

    def loss(w, ex, flag):
        return fq.qconv2d(ex[None], w, seed=1, flag=flag, stride=2,
                          fmt="luq_fp4", backend="ref").square().sum()

    for flag in (False, True):
        calls.clear()
        g, gx = vmap(torch.func.grad(loss, argnums=(0, 1)),
                     in_dims=(None, 0, None), randomness="same")(w, x, flag)
        assert g.shape == (5, 3, 3, 2, 4) and gx.shape == x.shape
    assert sorted(calls) == [(0, 5), (1, 1), (2, 1), (3, 5), (4, 5), (5, 5)]
    calls.clear()
    vmap(torch.func.grad(loss), in_dims=(None, 0, None),
         randomness="same")(w, x, True)
    assert sorted(calls) == [(0, 5), (1, 1), (4, 5), (5, 5)]
