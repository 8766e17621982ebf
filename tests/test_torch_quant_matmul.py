"""PyTorch port vs JAX package: the LUQ-FP4 quantized matmul
(repro_torch.kernels.ref.luq_matmul_ref, repro_torch.kernels.ops.luq_matmul
and the backend's ``matmul`` op).

Both sides get the same numpy uniforms: explicit ones, or the port's
Philox draws of a key.  The quantized operands agree bitwise (same float32
operations; a value within an ulp of a power of two could move one grid
level where XLA's log2 and PyTorch's differ, which these inputs do not
hit), and the products agree to float32 summation order: |diff| <= 1e-5 *
(|Q(a)| @ |Q(b)|) + 1e-6.  LUQ's prepared split agrees with the JAX
package's rounding bit for bit, and the ``ref`` and ``cuda`` backends' op
agree bit for bit on CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul  # noqa: E402
from repro.kernels.ref import luq_quant_ref, quant_matmul_ref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.quant import backend as tqb  # noqa: E402
from repro_torch.quant import philox  # noqa: E402
from repro_torch.quant.formats import (luq_fp4, luq_fp4_level,  # noqa: E402
                                       luq_fp4_prep, luq_fp4_value)

torch.set_num_threads(1)


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    ua = rng.random((m, k), dtype=np.float32)
    ub = rng.random((k, n), dtype=np.float32)
    return a, b, ua, ub


def _jax_both(a, b, ua, ub, alpha_a, alpha_b):
    """The JAX package's Pallas kernel (interpret mode) and its plain
    version on the same uniforms, with the quantized operands."""
    m, k = a.shape
    n = b.shape[1]
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
    jaq = np.asarray(luq_quant_ref(jnp.asarray(a), jnp.asarray(ua), alpha_a))
    jbq = np.asarray(luq_quant_ref(jnp.asarray(b), jnp.asarray(ub), alpha_b))
    return jk, jr, jaq, jbq


def test_luq_matmul_matches_jax_kernel_on_shared_uniforms():
    m, k, n = 3, 200, 130
    a, b, ua, ub = _operands(0, m, k, n)
    alpha_a = np.float32(np.abs(a).max())
    alpha_b = np.float32(np.abs(b).max())
    jk, jr, jaq, jbq = _jax_both(a, b, ua, ub, alpha_a, alpha_b)
    ours = tref.luq_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(ua), torch.from_numpy(ub),
                               torch.tensor(alpha_a), torch.tensor(alpha_b))
    # quantized operands: bitwise
    taq = luq_fp4(torch.from_numpy(a), torch.from_numpy(ua),
                  torch.tensor(alpha_a)).numpy()
    tbq = luq_fp4(torch.from_numpy(b), torch.from_numpy(ub),
                  torch.tensor(alpha_b)).numpy()
    np.testing.assert_array_equal(taq, jaq)
    np.testing.assert_array_equal(tbq, jbq)
    bound = 1e-5 * (np.abs(jaq) @ np.abs(jbq)) + 1e-6
    for theirs in (jk, jr):
        assert (np.abs(ours.numpy() - theirs) <= bound).all()


def test_key_path_matches_jax_kernel_on_philox_draws():
    """The port's key path (``ops.luq_matmul`` on CPU tensors: the kernel's
    plain version) equals the JAX kernel fed the port's Philox draws of
    the same key as numpy uniforms."""
    m, k, n = 3, 200, 128
    a, b, _, _ = _operands(6, m, k, n)
    key = (2 * 300 + 1, 17)
    ua = philox.uniforms(key, 0, m * k).reshape(m, k).numpy()
    ub = philox.uniforms(key, 1, k * n).reshape(k, n).numpy()
    alpha_a = np.float32(np.abs(a).max())
    alpha_b = np.float32(np.abs(b).max())
    jk, jr, jaq, jbq = _jax_both(a, b, ua, ub, alpha_a, alpha_b)
    ours = tops.luq_matmul(torch.from_numpy(a), torch.from_numpy(b), key,
                           torch.tensor(alpha_a), torch.tensor(alpha_b))
    bound = 1e-5 * (np.abs(jaq) @ np.abs(jbq)) + 1e-6
    for theirs in (jk, jr):
        assert (np.abs(ours.numpy() - theirs) <= bound).all()


def test_per_row_uniforms_equal_rowwise_products():
    """One call over R rows with one key per row equals R separate
    whole-matrix products, each with its own key and its own alpha_a."""
    m, k, n = 4, 64, 48
    a, b, _, _ = _operands(2, m, k, n)
    keys = [(2 * p + 1, 17) for p in (5, 9, 9, 40)]
    alpha_a = torch.from_numpy(np.abs(a).max(axis=1))
    alpha_b = torch.tensor(np.float32(np.abs(b).max()))
    ours = tops.luq_matmul(torch.from_numpy(a), torch.from_numpy(b), keys,
                           alpha_a, alpha_b)
    for i in range(m):
        row = tops.luq_matmul(torch.from_numpy(a[i:i + 1]),
                              torch.from_numpy(b), keys[i], alpha_a[i],
                              alpha_b)
        np.testing.assert_array_equal(ours[i:i + 1].numpy(), row.numpy())


def test_key_tensor_draws_the_bits_of_the_key_list():
    """Per-row keys as the (R, 2) int32 tensor the kernel reads from device
    memory (``philox.key_tensor``; a word above 2**31 is held in int32 by
    its bits) give the plain version the draws of the key list, bit for
    bit, and each row equals the JAX kernel fed that row's draws."""
    m, k, n = 3, 200, 128
    a, b, _, _ = _operands(9, m, k, n)
    keys = [(2 * p + 1, 17) for p in (4, 250, 9)]
    keys[2] = (0xDEADBEEF, 0x9E3779B9)
    kt = philox.key_tensor(keys, "cpu")
    assert kt.dtype == torch.int32 and tuple(kt.shape) == (m, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    alpha_a = ta.abs().amax(dim=1)
    alpha_b = tb.abs().amax()
    want = tops.luq_matmul(ta, tb, keys, alpha_a, alpha_b)
    for key_t in (kt, kt.long()):
        assert torch.equal(tops.luq_matmul(ta, tb, key_t, alpha_a, alpha_b),
                           want)
        assert torch.equal(tref.luq_matmul_keys_ref(ta, tb, key_t, alpha_a,
                                                    alpha_b), want)
    for i, key in enumerate(keys):
        ua = philox.uniforms(key, 0, k).reshape(1, k).numpy()
        ub = philox.uniforms(key, 1, k * n).reshape(k, n).numpy()
        jk, jr, jaq, jbq = _jax_both(a[i:i + 1], b, ua, ub,
                                     np.float32(alpha_a[i]),
                                     np.float32(alpha_b))
        bound = 1e-5 * (np.abs(jaq) @ np.abs(jbq)) + 1e-6
        for theirs in (jk, jr):
            assert (np.abs(want[i:i + 1].numpy() - theirs) <= bound).all()


@pytest.mark.parametrize("per_row", [False, True])
def test_ref_and_cuda_backends_agree_bitwise_on_cpu(per_row, monkeypatch):
    """Both backends' ``matmul`` op draw the same Philox stream: on CPU
    tensors (the kernel's plain version) the same bits."""
    monkeypatch.delenv(tqb.ENV_VAR, raising=False)
    a, b, _, _ = _operands(7, 3, 40, 36)
    keys = [(11, 17), (13, 17), (15, 17)] if per_row else (12, 17)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    outs = [tqb.get_matmul("luq_fp4", be)[0](ta, tb, keys)
            for be in ("ref", "cuda")]
    assert torch.equal(outs[0], outs[1])
    assert tops.LAUNCHES["luq_matmul"] == 0            # CPU: the plain version


def test_luq_split_matches_jax_luq_bitwise():
    """``luq_fp4_prep`` then ``luq_fp4_value`` (the split that lets the
    kernel prepare an element of b once for every row's draw; ``luq_fp4``
    is their composition) gives the JAX package's ``luq_quant_ref`` values
    bit for bit, edge values included (powers of two times alpha, one ulp
    below them, zeros), for per-row alphas, a zero alpha and several
    Philox draws; every level lies on the LUQ grid."""
    a, _, _, _ = _operands(8, 4, 257, 1)
    x = torch.from_numpy(a)
    x[:, 0] = 4.0
    levels = 4.0 * 2.0 ** -torch.arange(0, 9)
    below = torch.nextafter(levels, torch.zeros_like(levels))
    edges = torch.cat([levels, -levels, below, -below, torch.zeros(2),
                       -torch.zeros(2)])
    x[:, 1:1 + edges.numel()] = edges
    x[3] = 0.0
    alpha = x.abs().amax(dim=1, keepdim=True)
    prep = luq_fp4_prep(x, alpha)
    grid = torch.cat([torch.zeros(1), 2.0 ** -torch.arange(0.0, 7.0)])
    for s in range(3):
        u = philox.uniforms((s, 17), 1, x.numel()).reshape(x.shape)
        want = np.asarray(luq_quant_ref(jnp.asarray(x.numpy()),
                                        jnp.asarray(u.numpy()),
                                        jnp.asarray(alpha.numpy())))
        np.testing.assert_array_equal(luq_fp4_value(prep, u).numpy(), want)
        assert torch.isin(luq_fp4_level(prep, u), grid).all()


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
    """Mean over 400 independent draws (Philox keys (1000 + s, 17)) is
    within 5 standard errors of the exact product, elementwise over a
    fixed (4, 64) x (64, 32) problem (128 outputs: a 5-sigma bound has a
    false-alarm rate near 1e-4)."""
    monkeypatch.delenv(tqb.ENV_VAR, raising=False)
    mm, actual = tqb.get_matmul("luq_fp4", backend)
    assert actual == backend
    a, b, _, _ = _operands(5, 4, 64, 32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    draws = [mm(ta, tb, (1000 + s, 17)).numpy() for s in range(400)]
    draws = np.stack(draws)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    stderr = draws.std(axis=0, ddof=1) / np.sqrt(len(draws))
    assert (stderr > 0).all()
    assert (np.abs(draws.mean(axis=0) - exact) <= 5 * stderr).all()
