"""PyTorch port vs JAX package: KV-cache row quantization and decode
attention (repro_torch.quant.kv_cache, repro_torch.kernels.ops).

Codes and scales must agree bitwise with the JAX package's ``kv_quant``
and its Pallas ``kv_rowquant_2d`` (interpret mode, codes packed by its
wrapper ``kv_quant_rows``): both sides do the same float32 operations on
the same rows.  The port writes K and V into the cache in one call
(``kv_quant_write``, the CUDA kernel's wrapper; on CPU tensors its plain
version): held bitwise, on whole caches, against the JAX package's codes
written at each slot's position and against ``kv_cache.kv_quant`` plus
the index writes the decode step made before.  Decode attention agrees to
float32 rounding (atol = rtol = 1e-5): the two sides sum in another
order.
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
    wc, ws = _written(fmt, torch.from_numpy(x))              # wrapper, CPU
    assert tc.dtype == tkvc.code_spec(fmt, shape[-1])[0]
    assert ts.dtype == torch.bfloat16
    for codes in (np.asarray(jc), np.asarray(pc), _np(wc)):
        np.testing.assert_array_equal(_np(tc), codes)
    for scales in (np.asarray(js, np.float32), np.asarray(ps, np.float32),
                   _np(ws)):
        np.testing.assert_array_equal(_np(ts), scales)
    flat_scales = _np(ts).reshape(-1)
    assert (flat_scales[list(zero_rows)] == 0).all()


def _written(fmt, x):
    """``x`` (..., hd) quantized by the fused write into a fresh cache of
    its own rows, viewed as (1, N1, T, hd) with K = V = x; returns the
    K side's (codes, scales) in ``x``'s shape."""
    hd = x.shape[-1]
    rows = x.reshape(1, x.shape[0], -1, hd)
    code_dtype, code_dim = tkvc.code_spec(fmt, hd)
    caches = [torch.empty(rows.shape[:3] + (code_dim,), dtype=code_dtype)
              for _ in range(2)]
    scales = [torch.empty(rows.shape[:3], dtype=tkvc.SCALE_DTYPE)
              for _ in range(2)]
    tops.kv_quant_write(rows, rows, *caches, *scales, fmt)
    assert torch.equal(caches[0], caches[1])
    return (caches[0].reshape(*x.shape[:-1], code_dim),
            scales[0].reshape(x.shape[:-1]))


def _slot_cache(rng, fmt, B, KV, S, hd):
    """A whole quantized cache with stale rows everywhere: random codes
    and scales, the rows a write must leave untouched."""
    code_dtype, code_dim = tkvc.code_spec(fmt, hd)
    hi = 256 if fmt == "luq_fp4" else 128
    codes = [torch.from_numpy(rng.integers(-127 if hi == 128 else 0, hi,
                                           (B, KV, S, code_dim))).to(code_dtype)
             for _ in range(2)]
    scales = [torch.from_numpy(rng.random((B, KV, S)).astype(np.float32)
                               * 50).to(tkvc.SCALE_DTYPE) for _ in range(2)]
    return codes, scales


@pytest.mark.parametrize("fmt", QUANT_FMTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kv_write_matches_jax_codes_and_the_scatter(fmt, dtype):
    """One decode step's write: K and V rows (B, KV, hd) of every slot at
    its clamped position (a slot at S - 1, one past the end clamped to
    S - 1, one at 0), in the compute dtype, into whole caches with stale
    rows.  Bitwise: the same caches as ``kv_cache.kv_quant`` plus the four
    index writes, and as the JAX package's Pallas codes (packed), scales
    and the ref ``kv_quant`` written at those rows; every other row
    untouched."""
    B, KV, S, hd = 4, 3, 9, 32
    rng = np.random.default_rng(7)
    k = torch.from_numpy(_rows(8, (B, KV, hd), (1,))).to(dtype)
    v = torch.from_numpy(_rows(9, (B, KV, hd), (5,))).to(dtype)
    pos = torch.tensor([S - 1, 3, S + 2, 0], dtype=torch.int32)
    wpos = pos.clamp(max=S - 1).long()
    (kc, vc), (ks, vs) = _slot_cache(rng, fmt, B, KV, S, hd)
    stale = [t.clone() for t in (kc, vc, ks, vs)]
    want = [t.clone() for t in stale]
    rows = torch.arange(B)
    for src, codes, scales in ((k, want[0], want[2]), (v, want[1], want[3])):
        c, sc = tkvc.kv_quant(fmt, src)
        codes[rows, :, wpos] = c
        scales[rows, :, wpos] = sc
    tops.kv_quant_write(k[:, :, None], v[:, :, None], kc, vc, ks, vs, fmt,
                        wpos)
    for got, w in zip((kc, vc, ks, vs), want):
        assert torch.equal(got, w)
    jwant = [t.clone() for t in want]
    for src, codes, scales in ((k, 0, 2), (v, 1, 3)):
        flat = jnp.asarray(src.float().numpy())
        pc, ps = jops.kv_quant_rows(flat, fmt)               # Pallas, interpret
        jc, js = jkvc.kv_quant(fmt, flat)
        np.testing.assert_array_equal(np.asarray(pc), np.asarray(jc))
        jwant[codes][rows, :, wpos] = torch.from_numpy(np.array(pc))
        jwant[scales][rows, :, wpos] = torch.from_numpy(
            np.asarray(ps, np.float32)).to(tkvc.SCALE_DTYPE)
    for got, w in zip((kc, vc, ks, vs), jwant):
        assert torch.equal(got, w)
    untouched = torch.ones(B, S, dtype=torch.bool)
    untouched[rows, wpos] = False
    for got, old in zip((kc, vc, ks, vs), stale):
        for b in range(B):
            assert torch.equal(got[b][:, untouched[b]],
                               old[b][:, untouched[b]])


@pytest.mark.parametrize("fmt", QUANT_FMTS)
def test_fused_kv_write_of_a_prefill_stack(fmt):
    """Prefill writes every layer's K and V rows in one call, from row 0
    of a longer cache: rows 0..T-1 are ``kv_quant``'s codes and scales,
    the rest untouched; the model's prefill cache equals the plain
    quantization of its float32 K/V stack."""
    L, B, KV, T, S, hd = 2, 2, 3, 5, 8, 16
    rng = np.random.default_rng(3)
    ks = torch.from_numpy(_rows(4, (L * B, KV, T, hd), (0,))).bfloat16()
    vs = torch.from_numpy(_rows(5, (L * B, KV, T, hd))).bfloat16()
    (kc, vc), (ksc, vsc) = _slot_cache(rng, fmt, L * B, KV, S, hd)
    stale = [t.clone() for t in (kc, vc, ksc, vsc)]
    tops.kv_quant_write(ks, vs, kc, vc, ksc, vsc, fmt)
    for src, codes, scales, old_c, old_s in ((ks, kc, ksc, stale[0], stale[2]),
                                             (vs, vc, vsc, stale[1],
                                              stale[3])):
        c, sc = tkvc.kv_quant(fmt, src.float())
        assert torch.equal(codes[:, :, :T], c)
        assert torch.equal(scales[:, :, :T], sc)
        assert torch.equal(codes[:, :, T:], old_c[:, :, T:])
        assert torch.equal(scales[:, :, T:], old_s[:, :, T:])


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
