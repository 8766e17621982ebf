"""The CUDA kernels against their plain versions, on the card.

Marked ``requires_cuda``: each test skips where no GPU is available (the
check runs inside the ``cuda`` fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerances: codes, scales and quantized operands bitwise (the kernels
repeat the plain versions' float32 operations, and the quantizers' Philox
draws are the plain twin's words); attention and matmul outputs to
float32 summation order; the clip's norms rtol 1e-5 and its
sum within 1e-5 of sum_b |scale_b g_bd| per column (summation order);
the ghost norm within 1e-5 of sum_ij |XX_ij GG_ij| per example
(summation order), as in ``chip_smoke.py``.  Every kernel gives the same
bits on every run, and decode attention the same bits for a slot alone
as in a batch.  TF32 is off for the plain versions.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402
from repro_torch.quant import kv_cache as kvc  # noqa: E402
from repro_torch.quant import philox  # noqa: E402

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kv_cache(device, fmt, N0, N1, S, hd, seed):
    """Codes and scales of K and V filled with stale values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    codes = [torch.randint(-100, 100, (N0, N1, S, code_dim), device=device,
                           generator=gen).to(code_dtype) for _ in range(2)]
    scales = [(torch.rand(N0, N1, S, device=device, generator=gen) * 50)
              .to(kvc.SCALE_DTYPE) for _ in range(2)]
    return codes + scales


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("shape", [(4, 4, 128), (3, 5, 24), (1, 2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_rows_bitwise(cuda, fmt, shape, dtype):
    """Rows (a, b, hd) as one prefill-style write from row 0 of a longer
    cache: codes and scales bitwise, the rows past them untouched."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen) * 3
    x[0, 0] = 0
    k = x.to(dtype).reshape(1, *shape)
    v = (-2 * x).to(dtype).reshape(1, *shape)
    cache = _kv_cache(cuda, fmt, 1, shape[0], shape[1] + 3, shape[2], 1)
    want = [t.clone() for t in cache]
    ops.kv_quant_write(k, v, *cache, fmt)
    ref.kv_quant_write_ref(k, v, *want, fmt)
    for got, w in zip(cache, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_write_every_slot_and_position(cuda, fmt, dtype):
    """The decode step's write, (slots, kv, 1, hd) views of K and V rows
    at each slot's clamped position, into a cache of stale rows: every
    position of every slot in turn (slot b at (p + 7 b) % S), then all
    slots at S - 1, then positions past the end clamped to S - 1.  Each
    call bitwise the plain version's cache (kv_quant plus index writes),
    and the same bits on a second run."""
    B, KV, S, hd = 4, 4, 40, 128
    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = _kv_cache(cuda, fmt, B, KV, S, hd, 2)
    want = [t.clone() for t in cache]
    steps = [[(p + 7 * b) % S for b in range(B)] for p in range(S)]
    steps += [[S - 1] * B, [S, S + 5, S - 1, 2 * S]]
    for pos in steps:
        qkv = torch.randn(B, 3, KV, hd, device=cuda, generator=gen) * 2
        qkv[0, :, 1] = 0.0                            # an all-zero row
        qkv = qkv.to(dtype)
        k, v = qkv[:, 0, :, None], qkv[:, 1, :, None]  # strided views
        wpos = torch.tensor(pos, device=cuda).clamp(max=S - 1)
        before = [t.clone() for t in cache]
        ops.kv_quant_write(k, v, *cache, fmt, wpos)
        ref.kv_quant_write_ref(k, v, *want, fmt, wpos)
        for got, w in zip(cache, want):
            assert torch.equal(got, w)
        again = [t.clone() for t in before]
        ops.kv_quant_write(k, v, *again, fmt, wpos)
        for got, w in zip(again, cache):
            assert torch.equal(got, w)


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("g,hd", [(8, 128), (1, 24), (3, 64)])
def test_decode_attn_fused_close(cuda, fmt, g, hd):
    B, KV, S = 3, 2, 37
    gen = torch.Generator(device=cuda).manual_seed(1)
    kc, ks = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=cuda,
                                           generator=gen))
    vc, vs = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=cuda,
                                           generator=gen))
    q = torch.randn(B, KV * g, hd, device=cuda, generator=gen)
    pos = torch.tensor([0, 17, 36], dtype=torch.int32, device=cuda)
    args = (q, kc, vc, ks, vs, pos)
    kw = dict(fmt=fmt, n_kv=KV, scale=hd ** -0.5)
    out = ops.decode_attn_fused(*args, **kw)
    torch.testing.assert_close(out, ref.decode_attn_ref(*args, **kw),
                               atol=1e-5, rtol=1e-5)


def _stale_cache(device, fmt, pos_list, KV, S, hd, seed):
    """A quantized cache whose rows past each slot's pos hold garbage: the
    kernel gets NaN / inf scales there (it must never read them), the
    plain version finite ones (it masks the scores and multiplies the
    zero probabilities by the V scales)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B = len(pos_list)
    kc, ks = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=device,
                                           generator=gen))
    vc, vs = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=device,
                                           generator=gen))
    ks_ref, vs_ref = ks.clone(), vs.clone()
    for b, p in enumerate(pos_list):
        kc[b, :, p + 1:] = 7
        ks[b, :, p + 1:] = float("nan")
        vs[b, :, p + 1:] = float("inf")
        ks_ref[b, :, p + 1:] = 50.0
        vs_ref[b, :, p + 1:] = 50.0
    return kc, vc, ks, vs, ks_ref, vs_ref


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_decode_attn_split_s(cuda, fmt, g):
    """S = 1024 is 16 splits of L = 64 rows: positions on both sides of
    the split edges (0, L - 1, L, 2L, S - 1) and stale rows past pos.
    Within 1e-5 of the plain version, the same bits twice, and each slot
    run alone (B = 1) gives its row of the batch bit for bit: the splits
    depend on row indices only, never on the batch."""
    KV, S, hd, L = 4, 1024, 128, 64
    pos_list = [0, L - 1, L, 2 * L, S - 1]
    kc, vc, ks, vs, ks_ref, vs_ref = _stale_cache(cuda, fmt, pos_list, KV, S,
                                                  hd, 8)
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(len(pos_list), KV * g, hd, device=cuda, generator=gen)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda)
    kw = dict(fmt=fmt, n_kv=KV, scale=hd ** -0.5)
    out = ops.decode_attn_fused(q, kc, vc, ks, vs, pos, **kw)
    want = ref.decode_attn_ref(q, kc, vc, ks_ref, vs_ref, pos, **kw)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, ops.decode_attn_fused(q, kc, vc, ks, vs, pos,
                                                  **kw))
    for b in range(len(pos_list)):
        one = [t[b:b + 1].contiguous() for t in (q, kc, vc, ks, vs, pos)]
        assert torch.equal(ops.decode_attn_fused(*one, **kw)[0], out[b])


@pytest.mark.parametrize("per_row", [False, True])
def test_luq_matmul_close(cuda, per_row):
    """The kernel draws with Philox from the keys; the plain version draws
    the same stream in PyTorch.  Random operands: within 1e-5 of |Q(a)| @
    |Q(b)| per output, the same bits twice.  One-hot operands make the
    product pick single quantized elements, exactly: a = e_k rows (alpha 1,
    Q = 1) give rows of Q(b) under each row's key, b = I gives Q(a), so
    the kernel's Q(a), Q(b) are bitwise the plain version's.  N = 1000
    takes whole Philox calls and 16-byte loads, N = 998 the per-element
    path."""
    R, K = 5, 300
    keys = [(2 * p + 1, 17) for p in (3, 8, 8, 21, 600)] if per_row \
        else (2 * 300, 17)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for N in (1000, 998):
        a = torch.randn(R, K, device=cuda, generator=gen)
        b = torch.randn(K, N, device=cuda, generator=gen) * 0.02
        alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax()
        alpha_b = b.abs().amax()
        ops.reset_launch_counts()
        out = ops.luq_matmul(a, b, keys, alpha_a, alpha_b)
        assert ops.LUQ_MATMUL_LAUNCHES == {"prefill": 0, "decode": 1}
        assert torch.equal(out, ops.luq_matmul(a, b, keys, alpha_a, alpha_b))
        want = ref.luq_matmul_keys_ref(a, b, keys, alpha_a, alpha_b)
        key_list = keys if per_row else [keys] * R
        ua = (torch.stack([philox.uniforms(k, 0, K, cuda) for k in keys])
              if per_row else philox.uniforms(keys, 0, R * K, cuda)
              .reshape(R, K))
        aq = ref.luq_fp4(a, ua, alpha_a.reshape(-1, 1))
        bound = torch.stack([
            1e-5 * (aq[i].abs() @ ref.luq_fp4(
                b, philox.uniforms(key_list[i], 1, K * N, cuda).reshape(K, N),
                alpha_b).abs()) + 1e-6 for i in range(R)])
        assert ((out - want).abs() <= bound).all()

        onehot = torch.zeros(R, K, device=cuda)
        onehot[torch.arange(R), torch.tensor([0, 7, 150, 298, 299])] = 1.0
        one = torch.ones((R,) if per_row else (), device=cuda)
        torch.testing.assert_close(
            ops.luq_matmul(onehot, b, keys, one, alpha_b),
            ref.luq_matmul_keys_ref(onehot, b, keys, one, alpha_b),
            rtol=0, atol=0)
        eye = torch.eye(K, N, device=cuda)
        torch.testing.assert_close(
            ops.luq_matmul(a, eye, keys, alpha_a, torch.ones((), device=cuda)),
            ref.luq_matmul_keys_ref(a, eye, keys, alpha_a,
                                    torch.ones((), device=cuda)),
            rtol=0, atol=0)


def _luq_inputs(device, rows, n, dtype, seed):
    """x in ``dtype`` with the rounding's edges mixed in (exact powers of
    two times alpha = 4, one ulp of ``dtype`` below them, zeros) and, with
    several rows, an all-zero row (alpha = 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, n, device=device, generator=gen).clamp(-3.5, 3.5)
    x = x.to(dtype)
    x[:, 0] = 4.0
    levels = (4.0 * 2.0 ** -torch.arange(0, 9, device=device)).to(dtype)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    below = (levels.view(ints) - 1).view(dtype)
    edges = torch.cat([levels, -levels, below, -below,
                       torch.zeros(4, device=device, dtype=dtype)])
    x[:, 1:1 + edges.numel()] = edges
    if rows > 1:
        x[1] = 0.0
    return x


@pytest.mark.parametrize("rows,n,dtype", [
    (1, 3 * 3 * 512 * 512, torch.float32),   # the largest ResNet-18 weight
    (64, 32 * 32 * 64, torch.float32),       # the largest ResNet activation
    (1, 2560 * 6912, torch.bfloat16),        # a stablelm-3b MLP weight
    (4, 256 * 2560, torch.bfloat16),         # stablelm-3b per-example rows
    (3, 1001, torch.float32),                # n % 4 != 0: scalar loads
    (5, 1002, torch.bfloat16),
    (5, 4096, torch.bfloat16),
])
@pytest.mark.parametrize("codes", [False, True])
def test_luq_quant_bitwise(cuda, rows, n, dtype, codes):
    x = _luq_inputs(cuda, rows, n, dtype, 3)
    key = fq.stream_key(17, 4)
    got = ops.luq_quant(x, key, codes)
    assert got.dtype == (torch.bfloat16 if codes else dtype)
    assert torch.equal(got, ref.luq_quant_ref(x, key, codes))
    assert torch.equal(got, ops.luq_quant(x, key, codes))      # second run
    if codes:          # codes * alpha: the values, bit for bit
        alpha = x.float().abs().amax(dim=1, keepdim=True)
        assert torch.equal((got.float() * alpha).to(dtype),
                           ref.luq_quant_ref(x, key))


@pytest.mark.parametrize("rows,n,dtype", [
    (64, 32 * 32 * 256, torch.float32),      # a ResNet-50 activation
    (4, 256 * 2560, torch.bfloat16),         # stablelm-3b per-example rows
    (3, 1001, torch.float32),                # scalar loads
    (5, 1002, torch.bfloat16),
])
@pytest.mark.parametrize("codes", [False, True])
def test_luq_quant_reads_its_flag(cuda, rows, n, dtype, codes):
    """The policy flag from device memory: at 1 the unflagged bits, at 0
    the operand itself (codes: in bf16), both the plain version's."""
    x = _luq_inputs(cuda, rows, n, dtype, 4)
    key = fq.stream_key(17, 4)
    for value in (0.0, 1.0):
        flag = torch.full((), value, device=cuda)
        got = ops.luq_quant(x, key, codes, flag=flag)
        assert torch.equal(got, ref.luq_quant_ref(x, key, codes, flag))
        assert torch.equal(got, ops.luq_quant(x, key, codes) if value
                           else (x.bfloat16() if codes else x))
    view = torch.zeros(3, device=cuda)[1]           # a view, as qflags[i]
    assert torch.equal(ops.luq_quant(x, key, codes, flag=view),
                       x.bfloat16() if codes else x)


def _with_anchor(x, anchor):
    """Rows of ``x`` (R, C) behind four columns of ``anchor``: each row's
    scale is max(anchor, max|row|), and C + 4 keeps the row length a
    multiple of 4 when C is (the vector loads)."""
    return torch.cat([torch.full_like(x[:, :4], anchor), x], dim=1)


@pytest.mark.parametrize("anchor", [1.0, 0.7])
def test_luq_quant_bitwise_over_every_finite_float(cuda, anchor):
    """Every finite float32 x (2^32 bit patterns less NaN and inf, in
    chunks, rows of 4096 consecutive patterns behind an anchor), values
    and codes: the kernel's row max, its level from the exponent bits and
    its exact products by powers of two give the plain version's amax,
    log2, exp2 and division results bit for bit.  The anchor 1 makes
    y = |x| for every |x| <= 1; 0.7 another scale."""
    n = 1 << 28
    key = fq.stream_key(5, 0)
    for start in range(-(1 << 31), 1 << 31, n):
        x = torch.arange(start, start + n, dtype=torch.int64, device=cuda)
        x = x.to(torch.int32).view(torch.float32)
        x = torch.where(torch.isfinite(x), x, 0.0).reshape(-1, 4096)
        x = _with_anchor(x, anchor)
        assert torch.equal(ops.luq_quant(x, key), ref.luq_quant_ref(x, key))
        assert torch.equal(ops.luq_quant(x, key, True),
                           ref.luq_quant_ref(x, key, True))


@pytest.mark.parametrize("anchor", [1.0, 0.7])
def test_luq_quant_bitwise_over_every_bf16(cuda, anchor):
    """Every finite bf16 value (2^16 patterns less NaN and inf), in rows
    of 256 behind an anchor and as one row, values and codes."""
    x = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32, device=cuda)
    x = x.to(torch.int16).view(torch.bfloat16)
    x = torch.where(torch.isfinite(x), x, 0.0)
    key = fq.stream_key(6, 1)
    for rows in (_with_anchor(x.reshape(-1, 256), anchor), x.reshape(1, -1)):
        assert rows.dtype == torch.bfloat16
        assert torch.equal(ops.luq_quant(rows, key),
                           ref.luq_quant_ref(rows, key))
        assert torch.equal(ops.luq_quant(rows, key, True),
                           ref.luq_quant_ref(rows, key, True))


@pytest.mark.parametrize("dtype,offset", [
    (torch.float32, 1), (torch.float32, 2), (torch.float32, 3),
    (torch.bfloat16, 1), (torch.bfloat16, 3)])
@pytest.mark.parametrize("n", [4096, 4097])
def test_luq_quant_view_at_an_odd_offset(cuda, dtype, offset, n):
    """A (3, n) view starting ``offset`` elements into its storage, off
    the vector loads' grid: the scalar path, whose loads stop at the row's
    end.  The elements around the view are NaN, so a stray load shows."""
    x = _luq_inputs(cuda, 3, n, dtype, 4)
    storage = torch.full((offset + 3 * n + 5,), float("nan"), device=cuda,
                         dtype=dtype)
    view = storage[offset:offset + 3 * n].view(3, n)
    view.copy_(x)
    key = fq.stream_key(8, 3)
    for codes in (False, True):
        got = ops.luq_quant(view, key, codes)
        assert torch.equal(got, ref.luq_quant_ref(x, key, codes))
        assert torch.equal(got, ops.luq_quant(view, key, codes))


@pytest.mark.parametrize("B,D", [(64, 11_190_891), (1, 1000), (5, 1537)])
def test_clip_and_sum_close(cuda, B, D):
    C = 1.0
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn(B, D, device=cuda, generator=gen) * 1e-3
    if B > 2:
        g[0] = 0.0                                    # a zero row
        g[1] *= 0.1 / g[1].norm()                     # a norm below C
    out, norms = ops.clip_and_sum(g, C)
    want, want_norms = ref.per_sample_clip_ref(g, C)
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0.0)
    scale = torch.clamp(C / torch.clamp(want_norms, min=1e-12), max=1.0)
    assert ((out - want).abs() <= 1e-5 * (scale @ g.abs()) + 1e-12).all()
    again, _ = ops.clip_and_sum(g, C)                 # no atomics
    assert torch.equal(out, again)


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("D", [12288, 12289, 12290, 12291, 1001])
def test_clip_and_sum_edges(cuda, B, D):
    """The edges of the two-pass design: D % 4 in {0, 1, 2, 3} (rows b >= 1
    off the 16-byte grid: scalar head and tail in pass 1, the shuffled
    realignment in pass 2's 2048-column tiles, the scalar last tile) and
    D = 1001 below one tile; a zero row and a norm below C.  Norms rtol
    1e-5, the sum within 1e-5 of sum_b |scale_b g_bd|, the same bits
    twice."""
    C = 1.0
    gen = torch.Generator(device=cuda).manual_seed(10)
    g = torch.randn(B, D, device=cuda, generator=gen) * 0.02
    if B > 2:
        g[0] = 0.0
        g[1] *= 0.1 / g[1].norm()
    out, norms = ops.clip_and_sum(g, C)
    want, want_norms = ref.per_sample_clip_ref(g, C)
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0.0)
    scale = torch.clamp(C / torch.clamp(want_norms, min=1e-12), max=1.0)
    assert ((out - want).abs() <= 1e-5 * (scale @ g.abs()) + 1e-12).all()
    if B > 2:
        assert norms[0].item() == 0.0 and norms[1].item() < C
    again, again_norms = ops.clip_and_sum(g, C)
    assert torch.equal(out, again) and torch.equal(norms, again_norms)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("D", [12288, 12289])
def test_clip_and_sum_view_at_an_offset(cuda, offset, D):
    """A (B, D) view starting ``offset`` floats into its storage, so row 0
    is off the 16-byte grid too: both passes take the misalignment from
    the address.  The floats before the view are NaN, so a stray load that
    is not dropped shows.  Tolerances as above, the same bits twice."""
    B, C = 7, 1.0
    gen = torch.Generator(device=cuda).manual_seed(11)
    storage = torch.full((offset + B * D,), float("nan"), device=cuda)
    g = storage[offset:].view(B, D)
    g.copy_(torch.randn(B, D, device=cuda, generator=gen) * 0.02)
    out, norms = ops.clip_and_sum(g, C)
    want, want_norms = ref.per_sample_clip_ref(g, C)
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0.0)
    scale = torch.clamp(C / torch.clamp(want_norms, min=1e-12), max=1.0)
    assert ((out - want).abs() <= 1e-5 * (scale @ g.abs()) + 1e-12).all()
    again, again_norms = ops.clip_and_sum(g, C)
    assert torch.equal(out, again) and torch.equal(norms, again_norms)


def _ghost_inputs(device, B, T, Dx, Dg, seed, dtype=torch.float32):
    """x, g with the rounding's edges mixed in and, with several examples,
    an all-zero example; the keys of folds 4 and 5."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, T, Dx, device=device, generator=gen).clamp(-3.5, 3.5)
    g = torch.randn(B, T, Dg, device=device, generator=gen) * 0.01
    x[:, 0, 0] = 4.0
    levels = 4.0 * 2.0 ** -torch.arange(0, 9, device=device)
    below = torch.nextafter(levels, torch.zeros_like(levels))
    edges = torch.cat([levels, -levels, below, -below])
    n = min(edges.numel(), Dx)
    x[:, -1, :n] = edges[:n]
    if B > 1:
        x[1] = 0.0
    return (x.to(dtype), g.to(dtype), fq.stream_key(seed, 4),
            fq.stream_key(seed, 5))


@pytest.mark.parametrize("B,T,Dx,Dg,dtype", [
    (4, 256, 2560, 6912, torch.bfloat16),  # stablelm-3b gate / up in pass 1
    (4, 256, 2560, 6912, torch.float32),
    (1, 37, 48, 80, torch.float32),        # T not a multiple of the tile
    (4, 130, 96, 40, torch.bfloat16),      # Dx != Dg, T not a multiple
    (2, 45, 50, 37, torch.float32),        # D % 8 != 0: the scalar loads
    (3, 64, 2560, 2560, torch.bfloat16),
])
def test_ghost_norm_close_and_deterministic(cuda, B, T, Dx, Dg, dtype):
    args = _ghost_inputs(cuda, B, T, Dx, Dg, 5, dtype)
    out = ops.ghost_norm_sq(*args)
    want = ref.ghost_norm_ref(*args)
    x, g, kx, kg = args
    xq = ref.luq_quant_ref(x.reshape(B, -1), kx).reshape(x.shape).float()
    gq = ref.luq_quant_ref(g.reshape(B, -1), kg).reshape(g.shape).float()
    bound = 1e-5 * ((xq @ xq.transpose(1, 2)).abs()
                    * (gq @ gq.transpose(1, 2)).abs()).sum(dim=(1, 2))
    assert ((out - want).abs() <= bound).all()
    if B > 1:
        assert out[1].item() == 0.0                   # the zero example
    assert torch.equal(out, ops.ghost_norm_sq(*args))  # no atomics


@pytest.mark.parametrize("B,T,Dx,Dg", [(4, 256, 2560, 6912),
                                       (4, 130, 96, 40)])
def test_ghost_norm_reads_its_flag(cuda, B, T, Dx, Dg):
    """At flag 1 the unflagged bits; at flag 0 the norm of the unquantized
    bf16 operands, within 1e-5 of sum_ij |XX_ij GG_ij| of float64 Grams,
    and the plain version's within that too."""
    x, g, kx, kg = _ghost_inputs(cuda, B, T, Dx, Dg, 6, torch.bfloat16)
    on, off = torch.ones((), device=cuda), torch.zeros((), device=cuda)
    assert torch.equal(ops.ghost_norm_sq(x, g, kx, kg, on),
                       ops.ghost_norm_sq(x, g, kx, kg))
    got = ops.ghost_norm_sq(x, g, kx, kg, off).double()
    x64, g64 = x.double(), g.double()
    xx, gg = x64 @ x64.transpose(1, 2), g64 @ g64.transpose(1, 2)
    bound = 1e-5 * (xx.abs() * gg.abs()).sum(dim=(1, 2))
    for want in ((xx * gg).sum(dim=(1, 2)),
                 ref.ghost_norm_ref(x, g, kx, kg, off).double()):
        assert ((got - want).abs() <= bound).all()


def test_launch_counts_count_kernel_launches_only(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 1, 128, device=cuda)
    cache = _kv_cache(cuda, "int8", 2, 3, 4, 128, 0)
    ops.kv_quant_write(x, x, *cache, "int8")
    ops.kv_quant_write(x.cpu(), x.cpu(), *(t.cpu() for t in cache), "int8")
    rows = torch.randn(4, 64, device=cuda)
    ops.luq_quant(rows, (1, 2))
    ops.luq_quant(rows.cpu(), (1, 2))           # plain version: not counted
    with ops.per_example_launches():
        ops.luq_quant(rows[:1], (1, 2))
    ops.clip_and_sum(rows, 1.0)
    x, g, kx, kg = _ghost_inputs(cuda, 2, 8, 16, 24, 6)
    ops.ghost_norm_sq(x, g, kx, kg)
    ops.ghost_norm_sq(x.cpu(), g.cpu(), kx, kg)
    assert ops.LAUNCHES == {"luq_matmul": 0, "kv_quant_write": 1,
                            "decode_attn_fused": 0, "luq_quant": 2,
                            "clip_and_sum": 1, "ghost_norm_sq": 1}
    assert ops.LUQ_MATMUL_LAUNCHES == {"prefill": 0, "decode": 0}
    assert ops.LUQ_QUANT_LAUNCHES == {"whole": 1, "per_example": 1,
                                      "kernels": 4}
    assert ops.GHOST_NORM_LAUNCHES == {"16/24": 1}


def test_luq_matmul_device_keys_bitwise(cuda):
    """Per-row keys read from device memory (the decode graph's (R, 2)
    tensor) give the bits of the same keys passed as a list; one-hot
    operands pick single quantized elements, so the kernel's Q(a), Q(b)
    under device keys are bitwise the plain version's, which takes the
    same tensor."""
    R, K, N = 4, 300, 1000
    keys = [(2 * p + 1, 17) for p in (3, 8, 600, 1023)]
    keys[1] = (0xDEADBEEF, 0x9E3779B9)
    key_t = philox.key_tensor(keys, cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn(R, K, device=cuda, generator=gen)
    b = torch.randn(K, N, device=cuda, generator=gen) * 0.02
    alpha_a, alpha_b = a.abs().amax(dim=1), b.abs().amax()
    out = ops.luq_matmul(a, b, key_t, alpha_a, alpha_b)
    assert torch.equal(out, ops.luq_matmul(a, b, keys, alpha_a, alpha_b))
    assert torch.equal(ref.luq_matmul_keys_ref(a, b, key_t, alpha_a, alpha_b),
                       ref.luq_matmul_keys_ref(a, b, keys, alpha_a, alpha_b))
    onehot = torch.zeros(R, K, device=cuda)
    onehot[torch.arange(R), torch.tensor([0, 7, 150, 299])] = 1.0
    one = torch.ones((R,), device=cuda)
    assert torch.equal(ops.luq_matmul(onehot, b, key_t, one, alpha_b),
                       ref.luq_matmul_keys_ref(onehot, b, key_t, one, alpha_b))
    eye, unit = torch.eye(K, N, device=cuda), torch.ones((), device=cuda)
    assert torch.equal(ops.luq_matmul(a, eye, key_t, alpha_a, unit),
                       ref.luq_matmul_keys_ref(a, eye, key_t, alpha_a, unit))


def _small_run(executor, grad_mode="vmap"):
    from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,
                                    QuantConfig, RunConfig)
    from repro_torch.configs import get_smoke_config
    cnn = ModelConfig(name="cnn", family="resnet", resnet_blocks=(1, 1),
                      num_classes=8, image_size=16, compute_dtype="float32")
    if grad_mode == "ghost":
        model = get_smoke_config("stablelm-3b")
        dp = DPConfig(microbatch_size=4, grad_mode="ghost",
                      ghost_microbatch=2, quant_fraction=0.5)
    elif grad_mode == "cnn_ghost":
        model = cnn
        dp = DPConfig(microbatch_size=4, grad_mode="ghost",
                      ghost_microbatch=4, quant_fraction=0.5)
    else:
        model = cnn
        dp = DPConfig(microbatch_size=4, clip_backend="fused",
                      quant_fraction=0.5)
    return RunConfig(model=model, quant=QuantConfig(fmt="luq_fp4",
                                                    backend="cuda"),
                     dp=dp, optim=OptimConfig(name="momentum", lr=0.1,
                                              schedule="cosine"),
                     global_batch=8, seq_len=16, steps=3, steps_per_epoch=3,
                     epoch_executor=executor)


@pytest.mark.parametrize("grad_mode", ["vmap", "ghost", "cnn_ghost"])
def test_graphed_epoch_equals_the_eager_loop_bitwise(cuda, grad_mode):
    """One epoch of 3 steps under a cosine schedule, sigma 1: the scan
    executor's replays of the captured step give the loop's params,
    momentum, losses and epsilon bit for bit (deterministic cuDNN), and
    the launch counts are the loop's plus the warm-up step."""
    from repro_torch.data.synthetic import ImageClassDataset, TokenDataset
    from repro_torch.train_loop import Trainer
    ds = (TokenDataset(n=64, vocab=199, seq_len=16) if grad_mode == "ghost"
          else ImageClassDataset(n=64, num_classes=8, image_size=16))
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for executor in ("loop", "scan"):
            tr = Trainer(_small_run(executor, grad_mode), ds,
                         mode="static", device=cuda)
            ops.reset_launch_counts()
            hist = tr.train(1)
            torch.cuda.synchronize()
            out[executor] = (tr, hist, ops.launch_counts())
    finally:
        torch.backends.cudnn.deterministic = False
    (loop, hl, cl), (scan, hs, cs) = out["loop"], out["scan"]
    assert len(scan.epoch_fn.captured) == 1
    assert scan.epoch_fn._graph.replays == 3
    assert [h.loss for h in hl] == [h.loss for h in hs]
    assert [h.eps for h in hl] == [h.eps for h in hs]
    for a, b in zip(torch.utils._pytree.tree_leaves((loop.params,
                                                     loop.opt_state)),
                    torch.utils._pytree.tree_leaves((scan.params,
                                                     scan.opt_state))):
        assert torch.equal(a, b)
    for name, n in cl["launches"].items():       # 3 steps, then 3 + warm-up
        assert cs["launches"][name] * 3 == n * 4, name


@pytest.mark.parametrize("grad_mode", ["vmap", "ghost", "cnn_ghost"])
def test_one_graph_for_every_policy_under_dpquant(cuda, grad_mode):
    """DPQuant with an analysis every epoch, two epochs: the scan trainer
    captures one graph of the step and one of the probe step for every
    policy, and its params, EMA scores, policies and epsilon are the
    loop trainer's (eager steps and probes) bit for bit."""
    import dataclasses
    from repro_torch.data.synthetic import ImageClassDataset, TokenDataset
    from repro_torch.train_loop import Trainer
    ds = (TokenDataset(n=64, vocab=199, seq_len=16) if grad_mode == "ghost"
          else ImageClassDataset(n=64, num_classes=8, image_size=16))
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for executor in ("loop", "scan"):
            run = _small_run(executor, grad_mode)
            run = dataclasses.replace(run, steps=6, dp=dataclasses.replace(
                run.dp, analysis_interval=1, analysis_reps=1,
                analysis_batch_size=4))
            tr = Trainer(run, ds, mode="dpquant", device=cuda)
            hist = tr.train(2)
            torch.cuda.synchronize()
            out[executor] = (tr, hist)
    finally:
        torch.backends.cudnn.deterministic = False
    (loop, hl), (scan, hs) = out["loop"], out["scan"]
    assert len(scan.epoch_fn.captured) == len(scan.probe_fn.captured) == 1
    assert scan.scheduler.scores.tolist() == loop.scheduler.scores.tolist()
    assert [(h.loss, h.eps, h.quantized_layers) for h in hl] == \
        [(h.loss, h.eps, h.quantized_layers) for h in hs]
    for a, b in zip(torch.utils._pytree.tree_leaves((loop.params,
                                                     loop.opt_state)),
                    torch.utils._pytree.tree_leaves((scan.params,
                                                     scan.opt_state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "densenet121"])
def test_cnn_ghost_step_at_full_width(cuda, arch):
    """The full config's ghost step on 8 images: at fmt none the pass-1
    norms within rtol 1e-4 of the vmap engine's per-example norms
    (GroupNorm and head leaves included); at luq_fp4 one train step
    (pass 1 in chunks of 4) with a finite loss, no clip or ghost_norm
    launch, and the quantize calls its convs imply: per quantized conv
    and pass, two of the weight and four per example, the stem (whose
    input needs no gradient) one and three."""
    from torch.func import grad, vmap
    from repro_torch.config import (DPConfig, OptimConfig, QuantConfig,
                                    RunConfig)
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import ImageClassDataset
    from repro_torch.dp import ghost
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models import densenet, resnet
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    batch = {k: v.to(cuda) for k, v in ImageClassDataset(
        n=8, num_classes=cfg.num_classes).get(list(range(8))).items()}
    flags = (True,) * cfg.policy_len()
    model = build_model(cfg, QuantConfig(fmt="none"), device=cuda)
    params = model.init(0)

    def loss_one(p, ex):
        return model.loss_fn(p, {k: v[None] for k, v in ex.items()}, flags)

    grads = vmap(grad(loss_one), in_dims=(None, 0))(params, batch)
    want = torch.sqrt(sum(g.square().sum(dim=tuple(range(1, g.dim())))
                          for g in grads.values()))
    del grads
    _, got = ghost.ghost_per_example_norms(
        lambda p, b, h: model.per_example_loss(p, b, flags, hooks=h),
        params, batch, hooked_mask=model.ghost_mask(params))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)

    model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"),
                        device=cuda)
    run = RunConfig(model=cfg, quant=model.quant,
                    dp=DPConfig(grad_mode="ghost", ghost_microbatch=4),
                    optim=OptimConfig(name="sgd", lr=0.1), global_batch=8)
    setup = build_train_setup(model, run)
    ops.reset_launch_counts()
    _, _, metrics = setup.step_fn(params, setup.opt_init_fn(params), batch,
                                  0, flags, 0.1)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    counts = ops.launch_counts()
    assert counts["launches"]["clip_and_sum"] == 0
    assert counts["launches"]["ghost_norm_sq"] == 0
    convs = {"resnet": resnet, "densenet": densenet}[cfg.family] \
        .conv_layers(cfg)
    passes = 8 // 4 + 1                         # two chunks, then pass 2
    q_convs, q_stems = passes * sum(convs), passes
    assert counts["luq_quant"] == {"whole": 2 * q_convs - q_stems,
                                   "per_example": 4 * q_convs - q_stems,
                                   "kernels": 2 * (6 * q_convs - 2 * q_stems)}


def test_graph_replays_draw_the_loops_noise_at_each_seed(cuda):
    """The noise generator is registered with the captured step and
    re-seeded before each replay: two successive replays draw different
    noise, each the eager draw at its seed."""
    from repro_torch.dp.noise import add_gaussian_noise
    from repro_torch.launch.steps import (NOISE_SEED_OFFSET, EpochRunner,
                                          TrainSetup)
    gen = torch.Generator(device=cuda)

    def step_fn(params, opt_state, batch, seed, qflags, lr):
        if seed is not None:
            gen.manual_seed(NOISE_SEED_OFFSET + int(seed))
        zero = torch.zeros_like(params["w"])      # the noise alone
        noise = add_gaussian_noise({"w": zero}, clip_norm=1.0,
                                   noise_multiplier=1.0, batch_size=1,
                                   generator=gen)["w"]
        return {"w": noise}, opt_state, {"loss": noise.sum()}

    def eager(seed):
        g = torch.Generator(device=cuda)
        g.manual_seed(NOISE_SEED_OFFSET + seed)
        return torch.randn(4099, generator=g, device=cuda)

    runner = EpochRunner(TrainSetup(step_fn, lambda p: (), gen), cuda)
    params = {"w": torch.zeros(4099, device=cuda)}
    batches = {"x": torch.zeros(2, 1, device=cuda)}
    lrs = torch.zeros(2, device=cuda)
    draws = []
    for seed in (5, 6):
        params, _, metrics = runner(params, (), {"x": batches["x"][:1]},
                                    [seed], (), lrs[:1])
        draws.append(params["w"].clone())
        assert torch.equal(draws[-1], eager(seed))
    assert not torch.equal(draws[0], draws[1])
    params, _, metrics = runner(params, (), batches, [7, 8], (), lrs)
    assert torch.equal(params["w"], eager(8))
    assert metrics["loss"].tolist() == [eager(7).sum().item(),
                                        eager(8).sum().item()]
    assert len(runner.captured) == 1 and runner._graph.replays == 4


@pytest.mark.parametrize("kv_fmt", ["int8", "luq_fp4"])
def test_graphed_tick_equals_the_eager_tick(cuda, kv_fmt):
    """The engine's decode step replayed from its graph gives the tokens
    of the same step run eagerly every tick, with the KV write counted
    once a layer and step (the ticks, and the capture's eager warm-up)."""
    from repro_torch.config import QuantConfig, ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ContinuousEngine
    model = build_model(get_smoke_config("yi-6b"),
                        QuantConfig(fmt="luq_fp4", backend="cuda"),
                        device=cuda)
    params = model.init(0)
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 223, (n,), generator=rng).numpy()
               for n in (5, 11, 3, 8, 14)]
    tokens = {}
    for graphed in (True, False):
        engine = ContinuousEngine(model, params, ServeConfig(
            max_slots=3, max_seq=32, kv_fmt=kv_fmt), device=cuda)
        if not graphed:
            engine._decode = engine._decode_step     # an eager tick
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        ops.reset_launch_counts()
        out = engine.run()
        ticks = engine.metrics.decode_ticks
        steps = ticks + graphed                  # the capture's warm-up
        assert ops.KV_WRITE_LAUNCHES["decode"] == 2 * steps
        assert ops.LUQ_MATMUL_LAUNCHES["decode"] == steps
        tokens[graphed] = [out[r].tokens.tolist() for r in sorted(out)]
        if graphed:
            assert engine.decode_replays == ticks
    assert tokens[True] == tokens[False]


@pytest.mark.parametrize("kv_fmt", ["int8", "luq_fp4"])
def test_graphed_prefill_and_recovery_keep_the_tokens(cuda, kv_fmt):
    """Each bucket's prefill graph replays the eager prefill's logits and
    cache bit for bit (its luq_matmul launch counted as a prefill's, and
    the one row's device key giving the int key's bits); a chaos run at
    temperature 1.0 (a decode failure and poison: replayed prefixes)
    gives the fault-free tokens, every prefill a replay."""
    import numpy as np
    from repro_torch.config import QuantConfig, ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import FaultEvent, FaultPlan
    from repro_torch.serve import ContinuousEngine
    model = build_model(get_smoke_config("yi-6b"),
                        QuantConfig(fmt="luq_fp4", backend="cuda"),
                        device=cuda)
    params = model.init(0)
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 223, (n,), generator=rng).numpy()
               for n in (5, 11, 3, 8, 14)]
    serve = ServeConfig(max_slots=3, max_seq=32, kv_fmt=kv_fmt,
                        temperature=1.0, seed=3, max_retries=5)
    tokens = []
    for plan in (None, FaultPlan([FaultEvent("decode_fail", 2),
                                  FaultEvent("slot_corrupt", 4, 1)], seed=1)):
        engine = ContinuousEngine(model, params, serve, device=cuda)
        engine.submit(prompts[0], max_new_tokens=2)      # capture buckets
        engine.submit(prompts[1], max_new_tokens=2)
        engine.run()
        engine.reset()
        engine.faults = plan
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        replays = engine.prefill_replays
        out = engine.run()
        tokens.append([out[r].tokens.tolist() for r in sorted(out)])
        admissions = sum(engine.pool.admissions)
        assert engine.prefill_replays - replays == admissions
        assert engine.prefill_programs == 3
    assert tokens[0] == tokens[1]
    assert engine.replayed_steps > 0
    for bucket, step in engine._prefills.items():
        n = bucket // 2 + 1                  # the bucket's shortest prompt
        host = np.zeros((bucket + 1,), np.int32)
        host[:n] = np.arange(n) * 7 % 223
        host[bucket] = n
        engine._prefill_in[bucket].copy_(torch.from_numpy(host))
        ops.reset_launch_counts()
        logits, pcache = step()
        assert ops.LUQ_MATMUL_LAUNCHES == {"prefill": 1, "decode": 0}
        want, wcache = model.prefill(
            engine.params, {"tokens": engine._prefill_in[bucket][:bucket]
                            .view(1, bucket)}, prompt_len=n, kv_fmt=kv_fmt)
        assert torch.equal(logits, want)
        for name in wcache:
            if name != "pos":
                assert torch.equal(pcache[name], wcache[name])


def test_straggler_is_the_slowed_replica_on_the_card(cuda):
    """``on_tick``'s wall on the card includes the tick's device->host
    copy (the first tick the decode graph's capture), and every live
    replica records the same wall, so only the replica a ``replica_slow``
    fault slows is evicted."""
    from repro_torch.config import QuantConfig, ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import FaultEvent, FaultPlan, ServeSupervisor
    from repro_torch.serve import ContinuousEngine
    model = build_model(get_smoke_config("yi-6b"),
                        QuantConfig(fmt="luq_fp4", backend="cuda"),
                        device=cuda)
    plan = FaultPlan([FaultEvent("replica_slow", 1, 5, factor=4.0)])
    engine = ContinuousEngine(model, model.init(0), ServeConfig(
        max_slots=2, max_seq=16), device=cuda, faults=plan)
    walls = []
    sup = ServeSupervisor(engine, n_replicas=16, faults=plan,
                          straggler_patience=2)
    on_tick = engine.on_tick
    engine.on_tick = lambda t, dt, now: (walls.append(dt), on_tick(t, dt,
                                                                   now))
    for i, (n, g) in enumerate([(5, 8), (3, 6)]):
        engine.submit([(7 * i + j) % 223 for j in range(n)],
                      max_new_tokens=g)
    out = engine.run()
    assert all(r.status == "ok" for r in out.values())
    assert sup.dead == {5} and sup.events[0]["lost"] == [5]
    assert min(walls) > 0


def test_fake_cuda_traces_count_as_meta_traces(cuda):
    """``launch.op_analysis`` on fake CUDA tensors (``FakeTensorMode``)
    counts what it counts on ``meta`` tensors, kernel calls included: a
    SMOKE ResNet-18 vmap step and a SMOKE stablelm-3b ghost step."""
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch import train

    for argv in (["--arch", "resnet18", "--smoke", "--mode", "dpquant",
                  "--fmt", "luq_fp4", "--backend", "cuda", "--clip-backend",
                  "fused", "--batch", "16", "--microbatch", "4"],
                 ["--arch", "stablelm-3b", "--smoke", "--mode", "dpquant",
                  "--fmt", "luq_fp4", "--backend", "cuda", "--grad-mode",
                  "ghost", "--clip-backend", "ref", "--ghost-microbatch",
                  "2", "--batch", "4", "--seq-len", "16"]):
        run = train.build_run(train.parse_args(argv))
        fake = oa.analyze_train(run, device="cuda")
        meta = oa.analyze_train(run)
        for key in ("flops", "flops_by_class", "bytes", "kernels",
                    "peak_bytes", "warnings"):
            assert fake[key] == meta[key], key
        assert oa.kernel_calls(fake)["luq_quant"] > 0


# --------------------------------------------------------------------------- #
# the kernels on shards of an operand split over ranks (the model axis)
# --------------------------------------------------------------------------- #
# (whole shape, split dim, rows, parts): maps that keep Philox groups whole
# (a q weight split by heads of 80, a dispatch row split by experts) and
# maps that do not (an MLP of 6,910 split in two, an odd inner width)
SPLIT_CASES = [((2560, 32, 80), 1, 1, 2), ((1, 8, 80, 64), 1, 1, 2),
               ((4, 16, 6910), 2, 4, 2), ((3, 9, 6, 5), 1, 3, 3)]


@pytest.mark.parametrize("shape,dim,rows,parts", SPLIT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codes", [False, True])
def test_luq_round_on_shards_is_the_whole_operands_slice(
        cuda, shape, dim, rows, parts, dtype, codes):
    """``luq_row_max`` of each shard, their max, ``luq_round`` under the
    shard's index map: bitwise the plain version, and together the whole
    operand's ``luq_quant`` bit for bit; with the flag at 0 the shard."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    whole = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    key = fq.stream_key(101, 3)
    want = ops.luq_quant(whole.reshape(rows, -1), key, codes=codes).reshape(
        shape)
    n = shape[dim] // parts
    shards = [whole.narrow(dim, i * n, n).contiguous() for i in range(parts)]
    alpha = torch.stack([ops.luq_row_max(s.reshape(rows, -1))
                         for s in shards]).amax(dim=0)
    assert torch.equal(alpha, whole.reshape(rows, -1).float().abs().amax(1))
    for i, s in enumerate(shards):
        imap = fq._index_map(s.shape, (dim, i * n, shape[dim]))
        got = ops.luq_round(s.reshape(rows, -1), key, alpha, imap,
                            codes=codes)
        assert torch.equal(got, ref.luq_round_ref(
            s.reshape(rows, -1), key, alpha, imap, codes))
        assert torch.equal(got.reshape(s.shape), want.narrow(dim, i * n, n))
        off = torch.zeros((), device=cuda)
        passed = ops.luq_round(s.reshape(rows, -1), key, alpha, imap,
                               codes=codes, flag=off)
        assert torch.equal(passed, s.reshape(rows, -1).to(passed.dtype))


@pytest.mark.parametrize("B,D,split", [(4, 1_000_003, 700_001), (1, 5000, 17),
                                       (64, 12289, 12288)])
def test_split_clip_equals_the_whole_rows(cuda, B, D, split):
    """Rows split over two ranks (``split`` columns each, the rest
    replicated and counted by the first): ``clip_sumsq`` of each, summed,
    then ``clip_apply``: norms rtol 1e-5 of ``clip_and_sum``'s, each
    rank's sums within 1e-5 of sum_b |scale_b g_bd| of its columns; on
    one rank the two passes are ``clip_and_sum``'s bits."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    whole = torch.randn(B, 2 * split + D, device=cuda, generator=gen) * 1e-3
    want, norms = ops.clip_and_sum(whole, 1.0)
    locs = [torch.cat([whole[:, i * split:(i + 1) * split],
                       whole[:, 2 * split:]], dim=1) for i in range(2)]
    sumsq = sum(ops.clip_sumsq(t, t.shape[1] if i == 0 else split)
                for i, t in enumerate(locs))
    scale = torch.clamp(1.0 / torch.clamp(norms, min=1e-12), max=1.0)
    for i, t in enumerate(locs):
        got, got_norms = ops.clip_apply(t, sumsq, 1.0)
        torch.testing.assert_close(got_norms, norms, rtol=1e-5, atol=0.0)
        w = torch.cat([want[i * split:(i + 1) * split], want[2 * split:]])
        tol = 1e-5 * (scale @ t.abs()) + 1e-12
        assert ((got - w).abs() <= tol).all()
    one, one_norms = ops.clip_apply(whole, ops.clip_sumsq(whole), 1.0)
    assert torch.equal(one, want) and torch.equal(one_norms, norms)


@pytest.mark.parametrize("B,T,D,parts", [(4, 256, 2560, 2), (3, 33, 30, 3)])
@pytest.mark.parametrize("tap", ["column", "row"])
def test_ghost_norm_on_shards_adds_up(cuda, B, T, D, parts, tap):
    """A column-parallel tap (the cotangent split) or a row-parallel one
    (the input split): each shard's ``ghost_norm_sq`` given the split
    operand's scales and index map, within 1e-5 of the plain version's,
    and their sum within 1e-5 of sum_ij |XX_ij GG_ij| of the whole
    operands' norm."""
    gen = torch.Generator(device=cuda).manual_seed(B * T + D)
    x = torch.randn(B, T, D, device=cuda, generator=gen).bfloat16()
    g = (torch.randn(B, T, D, device=cuda, generator=gen) * 1e-3).bfloat16()
    kx, kg = fq.stream_key(7, 4), fq.stream_key(7, 5)
    want = ops.ghost_norm_sq(x, g, kx, kg)
    n = D // parts
    split = x if tap == "row" else g
    alpha = split.reshape(B, -1).float().abs().amax(1)
    total = torch.zeros_like(want)
    for i in range(parts):
        s = split[:, :, i * n:(i + 1) * n].contiguous()
        imap = fq._index_map(s.shape, (2, i * n, D))
        kw = (dict(alpha_x=alpha, map_x=imap) if tap == "row"
              else dict(alpha_g=alpha, map_g=imap))
        args = (s, g, kx, kg) if tap == "row" else (x, s, kx, kg)
        part = ops.ghost_norm_sq(*args, **kw)
        plain = ref.ghost_norm_ref(*args, None, kw.get("alpha_x"),
                                   kw.get("alpha_g"), kw.get("map_x"),
                                   kw.get("map_g"))
        sq = ref.luq_round_ref(s.reshape(B, -1), kx if tap == "row" else kg,
                               alpha, imap).reshape(s.shape).double()
        other = (ref.luq_quant_ref(g.reshape(B, -1), kg) if tap == "row"
                 else ref.luq_quant_ref(x.reshape(B, -1), kx)).reshape(
            B, T, D).double()
        tol = 1e-5 * ((sq @ sq.transpose(1, 2)).abs()
                      * (other @ other.transpose(1, 2)).abs()).sum((1, 2))
        assert ((part.double() - plain.double()).abs() <= tol).all()
        total += part
    xq = ref.luq_quant_ref(x.reshape(B, -1), kx).reshape(x.shape).double()
    gq = ref.luq_quant_ref(g.reshape(B, -1), kg).reshape(g.shape).double()
    tol = 1e-5 * ((xq @ xq.transpose(1, 2)).abs()
                  * (gq @ gq.transpose(1, 2)).abs()).sum(dim=(1, 2))
    assert ((total.double() - want.double()).abs() <= tol).all()


# --------------------------------------------------------------------------- #
# serving on the model axis: a vocab shard of the head, a sequence shard of
# the KV cache
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("K,N,parts", [(4096, 64000, 2), (64, 1000, 4),
                                       (40, 96, 3)])
def test_luq_matmul_vocab_shards_are_the_whole_heads_columns(
        cuda, per_row, K, N, parts):
    """Each shard of the head's columns, given the whole head's scale and
    its column offset, gives the whole head's columns bit for bit (the
    whole head's draws and K splits), and its plain version within the
    kernel's tolerance; N / parts = 333 takes the element path."""
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    R = 4 if per_row else 1
    a = torch.randn(R, K, device=cuda, generator=gen)
    b = torch.randn(K, N, device=cuda, generator=gen) / 64
    keys = ([(2 * p + 1, 17) for p in (10, 300, 700, 1023)] if per_row
            else (2 * 512, 17))
    alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax().reshape(1)
    alpha_b = b.abs().amax()
    whole = ops.luq_matmul(a, b, keys, alpha_a, alpha_b)
    n = N // parts
    for i in range(parts):
        cols = slice(i * n, (i + 1) * n)
        shard = b[:, cols].contiguous()
        got = ops.luq_matmul(a, shard, keys, alpha_a, alpha_b,
                             cols=(i * n, N))
        assert torch.equal(got, whole[:, cols]), i
        want = ref.luq_matmul_keys_ref(a, shard, keys, alpha_a, alpha_b,
                                       cols=(i * n, N))
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("S,parts", [(1024, 2), (256, 4), (200, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_write_into_sequence_shards(cuda, fmt, S, parts, dtype):
    """A tick's rows at each slot's position and a prompt's rows from row
    0, into each rank's rows of the cache: the whole cache's slice bit for
    bit, the rows the shard does not write untouched."""
    N0, N1, hd = 4, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(S + parts)
    stale = _kv_cache(cuda, fmt, N0, N1, S, hd, S)
    rows = S // parts
    for wpos, T in ((torch.tensor([3, rows - 1, rows + 5, S + 9],
                                  device=cuda), 1), (None, S - 7)):
        k = (torch.randn(N0, N1, T, hd, device=cuda, generator=gen) * 3).to(
            dtype)
        v = torch.randn(N0, N1, T, hd, device=cuda, generator=gen).to(dtype)
        w = None if wpos is None else wpos.clamp(max=S - 1)
        whole = [c.clone() for c in stale]
        ops.kv_quant_write(k, v, *whole, fmt, w)
        for r in range(parts):
            sl = slice(r * rows, (r + 1) * rows)
            got = [c[:, :, sl].clone() for c in stale]
            ops.kv_quant_write(k, v, *got, fmt, w, r * rows, S)
            want = [c[:, :, sl].clone() for c in stale]
            ref.kv_quant_write_ref(k, v, *want, fmt, w, r * rows, S)
            for g, x, y in zip(got, want, whole):
                assert torch.equal(g, x) and torch.equal(g, y[:, :, sl])


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("S,parts,g", [(1024, 2, 8), (512, 4, 8),
                                       (200, 2, 3)])
def test_decode_attn_sequence_shards_merge_to_the_whole_cache(
        cuda, fmt, S, parts, g):
    """Pass 1 over each rank's rows, the partials gathered in rank order,
    pass 2 over all: where the rows a rank are a multiple of 64, the whole
    cache's output bit for bit; else within float32 order of it.  Slots
    whose position lies in the first shard (the later ones empty), in a
    later one, and past the end."""
    KV, hd = 4, 128
    B = 4
    gen = torch.Generator(device=cuda).manual_seed(S + g)
    kc, ks = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=cuda,
                                           generator=gen))
    vc, vs = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=cuda,
                                           generator=gen))
    q = torch.randn(B, KV * g, hd, device=cuda, generator=gen)
    pos = torch.tensor([5, S // parts + 70, S - 1, S + 40], dtype=torch.int32,
                       device=cuda)
    kw = dict(fmt=fmt, n_kv=KV, scale=hd ** -0.5)
    whole = ops.decode_attn_fused(q, kc, vc, ks, vs, pos, **kw)
    rows = S // parts
    partials = []
    for r in range(parts):
        sl = slice(r * rows, (r + 1) * rows)
        partials.append(ops.decode_attn_split(
            q, *(t[:, :, sl].contiguous() for t in (kc, vc, ks, vs)), pos,
            row0=r * rows, seq_len=S, **kw))
    got = ops.decode_attn_merge(torch.stack(partials), pos, batch=B,
                                n_kv=KV, group=g, head_dim=hd, rows=rows,
                                seq_len=S)
    if rows % 64 == 0:
        assert torch.equal(got, whole)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, ref.decode_attn_ref(
        q, kc, vc, ks, vs, pos, **kw), rtol=1e-5, atol=1e-5)
