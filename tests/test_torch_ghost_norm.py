"""The ghost norm kernel's plain version (``repro_torch.kernels.ref.
ghost_norm_ref``, what ``ops.ghost_norm_sq`` runs on CPU tensors) and the
backend's ``ghost_norm`` op, against the JAX package.

The kernel and its plain version take the operands and the Philox keys
of their draws (fake-quant's folds 4 and 5) and take each example's
scale themselves:

* against the Pallas kernel ``ghost_norm_gram`` in interpret mode, fed the
  keys' draws (``philox.uniforms(key, 0, n)``, padded) and the same
  scales: rtol 2e-5, the JAX package's own fused-vs-composition
  tolerance (``tests/test_kernels.py``);
* against the quantize-then-Gram composition with the same keys (the
  ``ref`` and ``cuda`` backends' op): rtol 2e-5; against the direct
  ``||Q(x)^T Q(g)||^2``: rtol 2e-4 (another summation of the same
  products);
* exactly 0 for a zero operand, exactly 1/16 for g scaled by 1/4 (LUQ's
  per-tensor max scaling is scale-invariant), a batched call equals the
  per-example calls, and bf16 operands give the norm of their float32
  values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ghost_norm import ghost_norm_gram  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import backend as qbackend  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.quant import philox  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(16, 32, 64), (15, 384, 48), (8, 100, 200)]      # (T, Dx, Dg)


def _operands(t, dx, dg, seed, b=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, dx)).astype(np.float32)
    g = (rng.standard_normal((b, t, dg)) * 0.01).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def _alphas(x, g):
    return x.abs().amax(dim=(1, 2)), g.abs().amax(dim=(1, 2))


@pytest.mark.parametrize("tdd", SHAPES)
def test_plain_version_matches_pallas_kernel(tdd):
    t, dx, dg = tdd
    x, g = _operands(t, dx, dg, t * dx)
    kx, kg = fq.stream_key(dg, 4), fq.stream_key(dg, 5)
    ux = philox.uniforms(kx, 0, t * dx).reshape(t, dx).numpy()
    ug = philox.uniforms(kg, 0, t * dg).reshape(t, dg).numpy()
    ax, ag = _alphas(x, g)
    got = ref.ghost_norm_ref(x, g, kx, kg)
    # the JAX wrapper's padding: rows to a multiple of 8, both operands to
    # one column count, a multiple of 256 (zeros change neither Gram)
    d = -(-max(dx, dg) // 256) * 256
    pt = (-t) % 8

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, pt), (0, d - a.shape[1])))

    want = ghost_norm_gram(pad(x[0].numpy()), pad(ux), pad(g[0].numpy()),
                           pad(ug), jnp.asarray(ax.numpy()).reshape(1, 1),
                           jnp.asarray(ag.numpy()).reshape(1, 1),
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], rtol=2e-5)


@pytest.mark.parametrize("tdd", SHAPES)
def test_plain_version_matches_quantize_then_gram(tdd):
    """The keys of folds 4 and 5 feed the fused op; quantizing each
    example with the same keys, then the Grams (both backends' op) or the
    direct product, gives the same norm."""
    t, dx, dg = tdd
    x, g = _operands(t, dx, dg, 3 * t, b=2)
    kx, kg = fq.stream_key(7, 4), fq.stream_key(7, 5)
    got = ref.ghost_norm_ref(x, g, kx, kg)
    for backend in ("ref", "cuda"):
        gn, actual = qbackend.get_ghost_norm("luq_fp4", backend)
        assert actual == backend
        np.testing.assert_allclose(gn(x, g, kx, kg).numpy(), got.numpy(),
                                   rtol=2e-5)
    xq = fq._quantize_per_example(x, "luq_fp4", "ref", 7, 4)
    gq = fq._quantize_per_example(g, "luq_fp4", "ref", 7, 5)
    direct = (xq.transpose(1, 2) @ gq).square().sum(dim=(1, 2))
    np.testing.assert_allclose(direct.numpy(), got.numpy(), rtol=2e-4)


def test_zero_operand_scale_invariance_and_batching():
    t, dx, dg = 12, 40, 24
    x, g = _operands(t, dx, dg, 11, b=3)
    kx, kg = fq.stream_key(2, 4), fq.stream_key(2, 5)
    x[1] = 0.0                                        # a zero example
    out = ops.ghost_norm_sq(x, g, kx, kg)
    assert out[1].item() == 0.0 and (out[[0, 2]] > 0).all()
    assert ops.LAUNCHES["ghost_norm_sq"] == 0         # CPU: the plain version
    quarter = ops.ghost_norm_sq(x, 0.25 * g, kx, kg)
    np.testing.assert_allclose(quarter.numpy(), 0.0625 * out.numpy(),
                               rtol=1e-6)
    for b in range(3):
        one = ops.ghost_norm_sq(x[b:b + 1], g[b:b + 1], kx, kg)
        np.testing.assert_allclose(one.numpy(), out[b:b + 1].numpy(),
                                   rtol=1e-6)


def test_bf16_operands_give_the_norm_of_their_float32_values():
    """The op reads bf16 operands as they are: Q of a bf16 tensor is Q of
    its float32 values (the same scale, the same draws), so the norm is
    that of the float32 copy, bit for bit, on both backends."""
    t, dx, dg = 20, 48, 24
    x, g = _operands(t, dx, dg, 21, b=2)
    x, g = x.bfloat16(), (g * 100).bfloat16()
    kx, kg = fq.stream_key(4, 4), fq.stream_key(4, 5)
    want = ops.ghost_norm_sq(x.float(), g.float(), kx, kg)
    assert torch.equal(ops.ghost_norm_sq(x, g, kx, kg), want)
    for backend in ("ref", "cuda"):
        gn, _ = qbackend.get_ghost_norm("luq_fp4", backend)
        assert torch.equal(gn(x, g, kx, kg), gn(x.float(), g.float(), kx, kg))


def _edge_rows(b, n, seed):
    """(b, n) rows with LUQ's edge values (powers of two times alpha = 4,
    one ulp below them, signed zeros) and an all-zero row (alpha = 0)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, n)).astype(np.float32)).clamp(-3.5, 3.5)
    x[:, 0] = 4.0
    levels = 4.0 * 2.0 ** -torch.arange(0, 9)
    below = torch.nextafter(levels, torch.zeros_like(levels))
    edges = torch.cat([levels, -levels, below, -below, torch.zeros(2),
                       -torch.zeros(2)])
    x[:, 1:1 + edges.numel()] = edges
    x[1] = 0.0
    return x


def test_codes_times_alpha_equal_luq_fp4_exactly():
    """The quantizer's code output (the ghost kernel's operands): bf16
    codes sign * 2^-k or 0, and codes * alpha is ``luq_fp4``'s value bit
    for bit (bf16 holds every code exactly)."""
    x = _edge_rows(3, 300, 12)
    key = fq.stream_key(3, 4)
    alpha = x.abs().amax(dim=1)
    codes = ops.luq_quant(x, key, codes=True)
    assert codes.dtype == torch.bfloat16
    grid = torch.cat([torch.zeros(1), 2.0 ** -torch.arange(0.0, 7.0)])
    assert torch.isin(codes.float().abs(), grid).all()
    assert (codes[1] == 0).all()                       # alpha = 0
    want = ops.luq_quant(x, key)
    assert torch.equal(codes.float() * alpha[:, None], want)
    assert ops.LAUNCHES["luq_quant"] == 0             # CPU: the plain version


def test_code_route_matches_plain_version():
    """The kernel's route in plain PyTorch: bf16 codes, float32 Grams of
    the codes over the upper 32 x 32 tiles only (off-diagonal tiles
    doubled), scaled by (alpha_x alpha_g)^2 per example at the end; within
    1e-5 of sum_ij |XX_ij GG_ij| of ``ghost_norm_ref``, exactly 0 for a zero
    example.  T = 70 leaves a ragged last tile."""
    B, T, Dx, Dg, tile = 3, 70, 24, 40, 32
    x = _edge_rows(B, T * Dx, 13).reshape(B, T, Dx)
    g = _edge_rows(B, T * Dg, 14).reshape(B, T, Dg) * 1e-3
    g[1] = torch.flip(g[0], (0,))                      # x[1] alone is zero
    kx, kg = fq.stream_key(5, 4), fq.stream_key(5, 5)
    ax, ag = _alphas(x, g)
    cx = ref.luq_quant_ref(x.reshape(B, -1), kx, codes=True)
    cg = ref.luq_quant_ref(g.reshape(B, -1), kg, codes=True)
    cx = cx.float().reshape(x.shape)
    cg = cg.float().reshape(g.shape)
    xx = cx @ cx.transpose(1, 2)
    gg = cg @ cg.transpose(1, 2)
    tiles = range(0, T, tile)
    total = torch.zeros(B)
    for i in tiles:
        for j in tiles:
            if j >= i:
                part = (xx[:, i:i + tile, j:j + tile]
                        * gg[:, i:i + tile, j:j + tile]).sum(dim=(1, 2))
                total += part if i == j else 2.0 * part
    got = (ax * ag) ** 2 * total
    want = ref.ghost_norm_ref(x, g, kx, kg)
    xq = ref.luq_quant_ref(x.reshape(B, -1), kx).reshape(x.shape)
    gq = ref.luq_quant_ref(g.reshape(B, -1), kg).reshape(g.shape)
    bound = 1e-5 * ((xq @ xq.transpose(1, 2)).abs()
                    * (gq @ gq.transpose(1, 2)).abs()).sum(dim=(1, 2))
    assert ((got - want).abs() <= bound).all()
    assert got[1].item() == 0.0 and want[1].item() == 0.0
    assert (got[[0, 2]] > 0).all()
