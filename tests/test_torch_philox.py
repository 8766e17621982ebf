"""The port's Philox4x32-10 (``repro_torch.quant.philox``), the plain twin
of ``kernels/csrc/philox.cuh`` that the ``luq_matmul`` kernel draws with.

* the three known-answer vectors of Random123 (``kat_vectors``) for
  philox4x32 with 10 rounds, word for word;
* the 16-bit-limb 32 x 32 -> 64 product against Python's integers at the
  extremes of the range;
* the stream's layout: element e is lane e % 4 of the call for e // 4, so
  a column block of a matrix (a call per 4 columns, or a call per element
  when the rows are not a multiple of 4 wide) equals those elements of
  the flat stream; operands and keys give other streams;
* the uniforms lie in [0, 1 - 2^-24] on the 2^-24 grid, and the mean of
  2^20 of them is within 5 standard errors (5 * sqrt(1/12 / 2^20) =
  0.00141) of 1/2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.quant import philox  # noqa: E402

torch.set_num_threads(1)

KAT = [   # (counter, key, output), Random123's kat_vectors, philox4x32 10
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_known_answer_vectors(ctr, key, want):
    words = philox.philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_limb_product_matches_python_integers():
    xs = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
          0x243F6A88, 0xDEADBEEF]
    x = torch.tensor(xs, dtype=torch.int64)
    for m in (philox.M0, philox.M1, 0xFFFFFFFF):
        hi, lo = philox._mulhilo(m, x)
        assert hi.tolist() == [(m * v) >> 32 for v in xs]
        assert lo.tolist() == [(m * v) & philox.MASK32 for v in xs]


@pytest.mark.parametrize("row_stride,col0,cols", [(64, 8, 20), (13, 2, 7)])
def test_layout_of_a_column_block(row_stride, col0, cols):
    key = (41, 17)
    flat = philox.uniforms(key, 1, 6 * row_stride + 64)
    block = philox.uniforms_2d(key, 1, 5, cols, row_stride, col0)
    e = (torch.arange(5)[:, None] * row_stride + col0 + torch.arange(cols))
    assert torch.equal(block, flat[e])
    # lane e % 4 of the call for e // 4, with counter (e // 4, 0, op, 0)
    g = torch.tensor([e[1, 0] // 4])
    zero = torch.zeros_like(g)
    words = philox.philox4x32_10(g, zero, zero + 1, zero, *key)
    want = (int(words[int(e[1, 0]) % 4]) >> 8) * 2.0 ** -24
    assert block[1, 0].item() == want
    assert not torch.equal(flat[:16], philox.uniforms(key, 0, 16))
    assert not torch.equal(flat[:16], philox.uniforms((43, 17), 1, 16))


def test_uniforms_range_grid_and_mean():
    u = philox.uniforms((7, 17), 1, 1 << 20)
    assert u.dtype == torch.float32
    assert u.min().item() >= 0.0 and u.max().item() <= 1.0 - 2.0 ** -24
    assert torch.equal(u * 2.0 ** 24, torch.floor(u * 2.0 ** 24))
    mean = u.double().mean().item()
    assert abs(mean - 0.5) <= 5 * np.sqrt(1.0 / 12 / u.numel())
