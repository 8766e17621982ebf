"""PyTorch port vs JAX package: the LUQ-FP4 quantized matmul
(repro_torch.kernels.ops.luq_matmul and the backend's ``matmul`` op).

Both sides get the same numpy uniforms.  The quantized operands agree
bitwise (same float32 operations; a value within an ulp of a power of
two could move one grid level where XLA's log2 and PyTorch's differ,
which these inputs do not hit), and the products agree to float32
summation order: |diff| <= 1e-5 * (|Q(a)| @ |Q(b)|) + 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul  # noqa: E402
from repro.kernels.ref import luq_quant_ref, quant_matmul_ref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.quant import backend as tqb  # noqa: E402
from repro_torch.quant.formats import luq_fp4  # noqa: E402

torch.set_num_threads(1)


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    ua = rng.random((m, k), dtype=np.float32)
    ub = rng.random((k, n), dtype=np.float32)
    return a, b, ua, ub


def test_luq_matmul_matches_jax_kernel_on_shared_uniforms():
    m, k, n = 3, 200, 130
    a, b, ua, ub = _operands(0, m, k, n)
    alpha_a = np.float32(np.abs(a).max())
    alpha_b = np.float32(np.abs(b).max())
    # the JAX kernel takes whole (8, 128, 128) tiles: pad, then crop
    rng = np.random.default_rng(1)
    ap, bp = np.zeros((8, 256), np.float32), np.zeros((256, 256), np.float32)
    ap[:m, :k], bp[:k, :n] = a, b
    uap, ubp = rng.random((8, 256), dtype=np.float32), rng.random(
        (256, 256), dtype=np.float32)
    uap[:m, :k], ubp[:k, :n] = ua, ub
    jk = np.asarray(jax_quant_matmul(
        jnp.asarray(ap), jnp.asarray(bp), jnp.asarray(uap), jnp.asarray(ubp),
        jnp.asarray(alpha_a), jnp.asarray(alpha_b), block=(8, 128, 128),
        interpret=True))[:m, :n]
    jr = np.asarray(quant_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(ua), jnp.asarray(ub),
                                     alpha_a, alpha_b))
    ours = tops.luq_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(ua), torch.from_numpy(ub),
                           torch.tensor(alpha_a), torch.tensor(alpha_b))
    # quantized operands: bitwise
    jaq = np.asarray(luq_quant_ref(jnp.asarray(a), jnp.asarray(ua), alpha_a))
    jbq = np.asarray(luq_quant_ref(jnp.asarray(b), jnp.asarray(ub), alpha_b))
    taq = luq_fp4(torch.from_numpy(a), torch.from_numpy(ua),
                  torch.tensor(alpha_a)).numpy()
    tbq = luq_fp4(torch.from_numpy(b), torch.from_numpy(ub),
                  torch.tensor(alpha_b)).numpy()
    np.testing.assert_array_equal(taq, jaq)
    np.testing.assert_array_equal(tbq, jbq)
    bound = 1e-5 * (np.abs(jaq) @ np.abs(jbq)) + 1e-6
    for theirs in (jk, jr):
        assert (np.abs(ours.numpy() - theirs) <= bound).all()


def test_per_row_uniforms_equal_rowwise_products():
    """One launch over R rows with one draw per row equals R separate
    whole-matrix products, each with its own draw and its own alpha_a."""
    m, k, n = 4, 64, 48
    a, b, ua, _ = _operands(2, m, k, n)
    ub = np.random.default_rng(3).random((m, k, n), dtype=np.float32)
    alpha_a = torch.from_numpy(np.abs(a).max(axis=1))
    alpha_b = torch.tensor(np.float32(np.abs(b).max()))
    ours = tops.luq_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(ua), torch.from_numpy(ub),
                           alpha_a, alpha_b)
    for i in range(m):
        row = tops.luq_matmul(torch.from_numpy(a[i:i + 1]),
                              torch.from_numpy(b),
                              torch.from_numpy(ua[i:i + 1]),
                              torch.from_numpy(ub[i]), alpha_a[i], alpha_b)
        np.testing.assert_array_equal(ours[i:i + 1].numpy(), row.numpy())


def test_quantized_operands_land_on_the_luq_grid():
    a, _, ua, _ = _operands(4, 16, 96, 1)
    q = luq_fp4(torch.from_numpy(a), torch.from_numpy(ua)).numpy()
    alpha = np.abs(a).max()
    levels = np.concatenate([[0.0], 2.0 ** -np.arange(7)])
    ratio = np.abs(q) / alpha
    assert np.isclose(ratio[..., None], levels, rtol=0, atol=1e-7).any(-1).all()
    assert (np.sign(q)[q != 0] == np.sign(a)[q != 0]).all()


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_quantized_matmul_is_unbiased(backend, monkeypatch):
    """Mean over 400 independent draws is within 5 standard errors of the
    exact product, elementwise over a fixed (4, 64) x (64, 32) problem
    (128 outputs: a 5-sigma bound has a false-alarm rate near 1e-4)."""
    monkeypatch.delenv(tqb.ENV_VAR, raising=False)
    mm, actual = tqb.get_matmul("luq_fp4", backend)
    assert actual == backend
    a, b, _, _ = _operands(5, 4, 64, 32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    draws = []
    for s in range(400):
        gen = torch.Generator().manual_seed(1000 + s)
        draws.append(mm(ta, tb, gen).numpy())
    draws = np.stack(draws)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    stderr = draws.std(axis=0, ddof=1) / np.sqrt(len(draws))
    assert (stderr > 0).all()
    assert (np.abs(draws.mean(axis=0) - exact) <= 5 * stderr).all()
