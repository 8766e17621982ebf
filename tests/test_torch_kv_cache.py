"""PyTorch port vs JAX package: KV-cache row quantization and decode
attention (repro_torch.quant.kv_cache, repro_torch.kernels.ops).

Codes and scales must agree bitwise with the JAX package's ``kv_quant``
and its Pallas ``kv_quant_rows`` (interpret mode): both sides do the same
float32 operations on the same rows.  Decode attention agrees to float32
rounding (atol = rtol = 1e-5): the two sides sum in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.quant import backend as jqb  # noqa: E402
from repro.quant import kv_cache as jkvc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.quant import kv_cache as tkvc  # noqa: E402

torch.set_num_threads(1)

QUANT_FMTS = ("int8", "luq_fp4")


@pytest.fixture(autouse=True)
def _plain_jax_backend(monkeypatch):
    # keep each side on the backend the test names, whatever CI exports
    monkeypatch.delenv(jqb.ENV_VAR, raising=False)


def _rows(seed, shape, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x = x * np.float32(3.0)
    flat = x.reshape(-1, shape[-1])
    for r in zero_rows:
        flat[r] = 0.0
    return x


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("fmt", QUANT_FMTS)
@pytest.mark.parametrize("shape,zero_rows", [
    ((2, 3, 16, 32), (0, 17)),     # (B, KV, S, hd) with two all-zero rows
    ((3, 7, 10), (4,)),            # rows and head_dim off every tile size
])
def test_kv_quant_bitwise_equal_to_jax(fmt, shape, zero_rows):
    x = _rows(0, shape, zero_rows)
    jc, js = jkvc.kv_quant(fmt, jnp.asarray(x))
    pc, ps = jops.kv_quant_rows(jnp.asarray(x), fmt)        # Pallas, interpret
    tc, ts = tkvc.kv_quant(fmt, torch.from_numpy(x))
    wc, ws = tops.kv_quant_rows(torch.from_numpy(x), fmt)   # wrapper, CPU
    assert tc.dtype == tkvc.code_spec(fmt, shape[-1])[0]
    assert ts.dtype == torch.bfloat16
    for codes in (np.asarray(jc), np.asarray(pc), _np(wc)):
        np.testing.assert_array_equal(_np(tc), codes)
    for scales in (np.asarray(js, np.float32), np.asarray(ps, np.float32),
                   _np(ws)):
        np.testing.assert_array_equal(_np(ts), scales)
    flat_scales = _np(ts).reshape(-1)
    assert (flat_scales[list(zero_rows)] == 0).all()


@pytest.mark.parametrize("fmt", QUANT_FMTS)
def test_zero_scale_rows_dequantize_to_zero(fmt):
    x = _rows(1, (4, 6, 32))
    codes, scales = tkvc.kv_quant(fmt, torch.from_numpy(x))
    assert (codes != 0).any()
    scales = scales.clone()
    scales[1] = 0
    deq = tkvc.kv_dequant(fmt, codes, scales)
    assert (deq[1] == 0).all()
    assert (deq[0] != 0).any()


def _cache(seed, fmt, B, KV, S, hd, pos):
    """Quantized cache with live rows <= pos and garbage beyond it."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    kc, ks = tkvc.kv_quant(fmt, torch.from_numpy(k))
    vc, vs = tkvc.kv_quant(fmt, torch.from_numpy(v))
    for b, p in enumerate(pos):
        # stale rows from a previous occupant: random codes, large scales
        junk = torch.from_numpy(rng.integers(0, 256, kc[b, :, p + 1:].shape))
        kc[b, :, p + 1:] = junk.to(kc.dtype)
        vc[b, :, p + 1:] = junk.flip(-1).to(vc.dtype)
        ks[b, :, p + 1:] = 50.0
        vs[b, :, p + 1:] = 50.0
    return kc, vc, ks, vs


@pytest.mark.parametrize("fmt", QUANT_FMTS)
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attn_matches_jax(fmt, g):
    B, KV, S, hd = 3, 2, 13, 16          # S not a multiple of 8
    pos = [0, 7, 12]                     # ragged per-slot positions
    kc, vc, ks, vs = _cache(2, fmt, B, KV, S, hd, pos)
    q = np.random.default_rng(3).standard_normal((B, KV * g, hd)).astype(
        np.float32)
    scale = 1.0 / np.sqrt(hd)
    tq, tpos = torch.from_numpy(q), torch.tensor(pos, dtype=torch.int32)
    ref = tkvc.ref_decode_attn(fmt, tq, kc, vc, ks, vs, tpos, n_kv=KV,
                               scale=scale)
    fused = tops.decode_attn_fused(tq, kc, vc, ks, vs, tpos, fmt=fmt, n_kv=KV,
                                   scale=scale)
    jargs = (jnp.asarray(q), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()),
             jnp.asarray(_np(ks)).astype(jnp.bfloat16),
             jnp.asarray(_np(vs)).astype(jnp.bfloat16),
             jnp.asarray(pos, jnp.int32))
    jref = jkvc.ref_decode_attn(fmt, *jargs, n_kv=KV, scale=scale)
    jfused = jops.decode_attn_fused(*jargs, fmt=fmt, n_kv=KV, scale=scale)
    for ours in (ref, fused):
        for theirs in (jref, jfused):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       atol=1e-5, rtol=1e-5)
