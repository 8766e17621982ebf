"""The CUDA kernels against their plain versions, on the card.

Marked ``requires_cuda``: each test skips where no GPU is available (the
check runs inside the ``cuda`` fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerances: codes, scales and quantized operands bitwise (the kernels
repeat the plain versions' float32 operations, and the matmul's Philox
draws are the plain twin's words); attention and matmul outputs to
float32 summation order; the clip's norms rtol 1e-5 and its
sum within 1e-5 of sum_b |scale_b g_bd| per column (summation order);
the ghost norm within 1e-5 of sum_ij |XX_ij GG_ij| per example
(summation order), as in ``chip_smoke.py``.  Decode attention, the clip
and the ghost norm give the same bits on every run, and decode attention
the same bits for a slot alone as in a batch.  TF32 is off for the plain
versions.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
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


@pytest.mark.parametrize("fmt", ["int8", "luq_fp4"])
@pytest.mark.parametrize("shape", [(4, 4, 128), (3, 5, 24), (1, 2, 2)])
def test_kv_quant_rows_bitwise(cuda, fmt, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen) * 3
    x[0, 0] = 0
    codes, scales = ops.kv_quant_rows(x, fmt)
    rc, rs = ref.kv_quant_rows_ref(x, fmt)
    assert torch.equal(codes, rc) and torch.equal(scales, rs)


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
        assert ops.LUQ_MATMUL_LAUNCHES == {"shared": int(not per_row),
                                           "per_row": int(per_row)}
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


def _luq_inputs(device, rows, n, per_row, seed):
    """x with the rounding's edges mixed in (exact powers of two times
    alpha = 4, one ulp below them, zeros) and, with several rows, an
    all-zero row (alpha = 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, n, device=device, generator=gen).clamp(-3.5, 3.5)
    x[:, 0] = 4.0
    levels = 4.0 * 2.0 ** -torch.arange(0, 9, device=device)
    below = torch.nextafter(levels, torch.zeros_like(levels))
    edges = torch.cat([levels, -levels, below, -below,
                       torch.zeros(4, device=device)])
    x[:, 1:1 + edges.numel()] = edges
    if rows > 1:
        x[1] = 0.0
    u = torch.rand(*((rows,) if per_row else ()), n, device=device,
                   generator=gen)
    return x, u, x.abs().amax(dim=1)


@pytest.mark.parametrize("rows,n,per_row", [
    (1, 3 * 3 * 512 * 512, False),      # the largest ResNet-18 weight
    (64, 32 * 32 * 64, False),          # the largest activation under vmap
    (3, 1001, True),                    # n % 4 != 0: the scalar kernel
    (5, 4096, True),
])
@pytest.mark.parametrize("codes", [False, True])
def test_luq_quant_bitwise(cuda, rows, n, per_row, codes):
    x, u, alpha = _luq_inputs(cuda, rows, n, per_row, 3)
    got = ops.luq_quant(x, u, alpha, codes)
    assert torch.equal(got, ref.luq_quant_ref(x, u, alpha, codes))
    if codes:          # codes * alpha: the values, bit for bit
        assert torch.equal(got.float() * alpha[:, None],
                           ref.luq_quant_ref(x, u, alpha))


@pytest.mark.parametrize("alpha", [1.0, 0.7])
def test_luq_quant_bitwise_over_every_finite_float(cuda, alpha):
    """Every finite float32 x (2^32 bit patterns less NaN and inf, in
    chunks), against random uniforms, values and codes: the kernel's
    level from the exponent bits and its exact products by powers of two
    give the plain version's log2 / exp2 / division results bit for bit.
    alpha = 0.7 puts y = |x| / alpha above 1 too."""
    n = 1 << 28
    a = torch.full((1,), alpha, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for start in range(-(1 << 31), 1 << 31, n):
        x = torch.arange(start, start + n, dtype=torch.int64, device=cuda)
        x = x.to(torch.int32).view(torch.float32).reshape(1, n)
        x = torch.where(torch.isfinite(x), x, 0.0)
        u = torch.rand(n, device=cuda, generator=gen)
        assert torch.equal(ops.luq_quant(x, u, a), ref.luq_quant_ref(x, u, a))
        assert torch.equal(ops.luq_quant(x, u, a, True),
                           ref.luq_quant_ref(x, u, a, True))


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


def _ghost_inputs(device, B, T, Dx, Dg, seed):
    """x, g with the rounding's edges mixed in and, with several examples,
    an all-zero example; shared uniforms, per-example scales."""
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
    ux = torch.rand(T * Dx, device=device, generator=gen)
    ug = torch.rand(T * Dg, device=device, generator=gen)
    return (x, g, ux, ug, x.abs().amax(dim=(1, 2)), g.abs().amax(dim=(1, 2)))


@pytest.mark.parametrize("B,T,Dx,Dg", [
    (4, 256, 2560, 6912),               # stablelm-3b gate / up in pass 1
    (1, 37, 48, 80),                    # T not a multiple of the tile
    (4, 130, 96, 40),                   # Dx != Dg, T not a multiple
    (2, 45, 50, 37),                    # D % 8 != 0: the scalar loads
    (3, 64, 2560, 2560),
])
def test_ghost_norm_close_and_deterministic(cuda, B, T, Dx, Dg):
    args = _ghost_inputs(cuda, B, T, Dx, Dg, 5)
    out = ops.ghost_norm_sq(*args)
    want = ref.ghost_norm_ref(*args)
    x, g, ux, ug, ax, ag = args
    xq = ref.luq_fp4(x.reshape(B, -1), ux, ax[:, None]).reshape(x.shape)
    gq = ref.luq_fp4(g.reshape(B, -1), ug, ag[:, None]).reshape(g.shape)
    bound = 1e-5 * ((xq @ xq.transpose(1, 2)).abs()
                    * (gq @ gq.transpose(1, 2)).abs()).sum(dim=(1, 2))
    assert ((out - want).abs() <= bound).all()
    if B > 1:
        assert out[1].item() == 0.0                   # the zero example
    assert torch.equal(out, ops.ghost_norm_sq(*args))  # no atomics


def test_launch_counts_count_kernel_launches_only(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 128, device=cuda)
    ops.kv_quant_rows(x, "int8")
    ops.kv_quant_rows(x.cpu(), "int8")         # plain version: not counted
    rows = torch.randn(4, 64, device=cuda)
    u = torch.rand(64, device=cuda)
    ops.luq_quant(rows, u, rows.abs().amax(dim=1))
    ops.luq_quant(rows.cpu(), u.cpu(), rows.abs().amax(dim=1).cpu())
    ops.clip_and_sum(rows, 1.0)
    args = _ghost_inputs(cuda, 2, 8, 16, 24, 6)
    ops.ghost_norm_sq(*args)
    ops.ghost_norm_sq(*(t.cpu() for t in args))
    assert ops.LAUNCHES == {"luq_matmul": 0, "kv_quant_rows": 1,
                            "decode_attn_fused": 0, "luq_quant": 1,
                            "clip_and_sum": 1, "ghost_norm_sq": 1}
    assert ops.LUQ_MATMUL_LAUNCHES == {"shared": 0, "per_row": 0}
    assert ops.LUQ_QUANT_LAUNCHES == {"one_row": 0, "rows": 1}
    assert ops.GHOST_NORM_LAUNCHES == {"16/24": 1}
