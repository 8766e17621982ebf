"""The CUDA kernels against their plain versions, on the card.

Marked ``requires_cuda``: each test skips where no GPU is available (the
check runs inside the ``cuda`` fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerances: codes, scales and quantized operands bitwise (the kernels
repeat the plain versions' float32 operations); attention and matmul
outputs to float32 summation order.  TF32 is off for the plain versions.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import kv_cache as kvc  # noqa: E402

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


@pytest.mark.parametrize("per_row", [False, True])
def test_luq_matmul_close(cuda, per_row):
    R, K, N = 5, 300, 1000
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(R, K, device=cuda, generator=gen)
    b = torch.randn(K, N, device=cuda, generator=gen) * 0.02
    ua = torch.rand(R, K, device=cuda, generator=gen)
    ub = torch.rand(*((R,) if per_row else ()), K, N, device=cuda,
                    generator=gen)
    alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax()
    alpha_b = b.abs().amax()
    ops.reset_launch_counts()
    out = ops.luq_matmul(a, b, ua, ub, alpha_a, alpha_b)
    assert ops.LUQ_MATMUL_LAUNCHES == {"shared": int(not per_row),
                                       "per_row": int(per_row)}
    want = ref.luq_matmul_ref(a, b, ua, ub, alpha_a, alpha_b)
    aq = ref.luq_fp4(a, ua, alpha_a.reshape(-1, 1))
    bound = torch.stack([
        1e-5 * (aq[i].abs() @ ref.luq_fp4(b, ub[i] if per_row else ub,
                                          alpha_b).abs()) + 1e-6
        for i in range(R)])
    assert ((out - want).abs() <= bound).all()


def test_launch_counts_count_kernel_launches_only(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 128, device=cuda)
    ops.kv_quant_rows(x, "int8")
    ops.kv_quant_rows(x.cpu(), "int8")         # plain version: not counted
    assert ops.LAUNCHES == {"luq_matmul": 0, "kv_quant_rows": 1,
                            "decode_attn_fused": 0}
    assert ops.LUQ_MATMUL_LAUNCHES == {"shared": 0, "per_row": 0}
