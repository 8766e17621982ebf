"""The hand-written backward of the port's fake-quantized convolution
(``repro_torch.quant.fake_quant.qconv2d``) against the JAX package's conv
and autograd.

The quantizer is patched to a deterministic stand-in, so that the
convolution's own arithmetic is what is compared:

* identity: forward, dgrad and wgrad of a quantized conv equal autograd of
  the plain conv within 1e-5;
* a distinct scale per fold (``1 + fold / 8``): the six quantize points
  feed the right operands, against ``jax.lax.conv_general_dilated`` with
  "SAME" padding and ``jax.vjp`` within 1e-5 (atol and rtol), at stride
  1 and 2, even, odd and non-square sizes, 3x3 and 1x1 kernels, batched
  over a microbatch and per example under ``torch.func.vmap``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from repro_torch.quant import fake_quant as fq  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# (height, width, kernel, stride): stride 2 on even sizes pads (0, 1), on
# odd sizes (1, 1); a non-square input pads rows and columns apart
SHAPES = [(8, 8, 3, 1), (7, 9, 3, 1), (8, 8, 3, 2), (7, 7, 3, 2),
          (8, 7, 3, 2), (8, 8, 1, 2), (7, 7, 1, 2)]
N, C, O = 3, 4, 5


def _scale(fold: int) -> float:
    return 1.0 + fold / 8


def _patch_quantizer(monkeypatch, per_fold: bool):
    """Replace the quantizer with ``rows * scale(fold)`` (identity when
    ``per_fold`` is false); returns the list of (fold, rows) calls."""
    calls = []

    def stand_in(rows, fmt, backend, seed, fold, flag=None):
        calls.append((fold, rows.shape[0]))
        return rows * (_scale(fold) if per_fold else 1.0)

    monkeypatch.setattr(fq, "_quantize_rows", stand_in)
    return calls


def _inputs(h, w, k, stride, seed=0):
    rng = np.random.default_rng(seed + 100 * h + 10 * w + k + stride)
    x = rng.standard_normal((N, h, w, C)).astype(np.float32)       # NHWC
    wt = rng.standard_normal((k, k, C, O)).astype(np.float32)      # HWIO
    ho, wo = -(-h // stride), -(-w // stride)
    gy = rng.standard_normal((N, ho, wo, O)).astype(np.float32)
    return x, wt, gy


def _jax_conv(x, w, stride):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _jax_quantized_conv(x, w, gy, stride):
    """y = Q0(x) * Q1(w), dx = conv^T(Q3(g); Q2(w)), dw = conv^T(Q5(g);
    Q4(x)), Q_f(t) = t * scale(f): the reference's qconv custom VJP with
    the stand-in quantizer."""
    s = _scale
    y = _jax_conv(x * s(0), w * s(1), stride)
    _, vjp_x = jax.vjp(lambda t: _jax_conv(t, w * s(2), stride), x)
    _, vjp_w = jax.vjp(lambda t: _jax_conv(x * s(4), t, stride), w)
    (dx,) = vjp_x(gy * s(3))
    (dw,) = vjp_w(gy * s(5))
    return y, dx, dw


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _port_grads(x, w, gy, stride, flag):
    """The port's y, dx (NHWC) and dw (HWIO) for the loss sum(y * gy)."""
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = fq.qconv2d(xt, wt, seed=7, flag=flag, stride=stride, fmt="luq_fp4",
                   backend="ref")
    (y * _nchw(gy)).sum().backward()
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            xt.grad.permute(0, 2, 3, 1).numpy(), wt.grad.numpy())


@pytest.mark.parametrize("h,w,k,stride", SHAPES)
def test_identity_quantized_conv_grads_equal_plain_conv_autograd(
        monkeypatch, h, w, k, stride):
    x, wt, gy = _inputs(h, w, k, stride)
    plain = _port_grads(x, wt, gy, stride, flag=False)
    calls = _patch_quantizer(monkeypatch, per_fold=False)
    quantized = _port_grads(x, wt, gy, stride, flag=True)
    assert sorted(f for f, _ in calls) == [0, 1, 2, 3, 4, 5]
    for name, got, want in zip(("y", "dx", "dw"), quantized, plain):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    want = _jax_conv(jnp.asarray(x), jnp.asarray(wt), stride)
    np.testing.assert_allclose(plain[0], np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w,k,stride", SHAPES)
def test_quantize_points_feed_the_operands_of_jax_qconv(
        monkeypatch, h, w, k, stride):
    x, wt, gy = _inputs(h, w, k, stride, seed=1)
    _patch_quantizer(monkeypatch, per_fold=True)
    got = _port_grads(x, wt, gy, stride, flag=True)
    want = _jax_quantized_conv(jnp.asarray(x), jnp.asarray(wt),
                               jnp.asarray(gy), stride)
    for name, g, w_ in zip(("y", "dx", "dw"), got, want):
        np.testing.assert_allclose(g, np.asarray(w_), err_msg=name, **TOL)


@pytest.mark.parametrize("h,w,k,stride", [(8, 8, 3, 2), (7, 9, 3, 1),
                                          (8, 8, 1, 2)])
def test_per_example_grads_under_vmap_match_jax(monkeypatch, h, w, k, stride):
    """The DP engine's path: vmap(grad) over single examples gives each
    example's dw and dx of the reference's qconv VJP."""
    x, wt, gy = _inputs(h, w, k, stride, seed=2)
    calls = _patch_quantizer(monkeypatch, per_fold=True)

    def loss(wp, xe, ge):
        y = fq.qconv2d(xe[None], wp, seed=7, flag=True, stride=stride,
                       fmt="luq_fp4", backend="ref")
        return (y * ge[None]).sum()

    dw, dx = vmap(grad(loss, argnums=(0, 1)), in_dims=(None, 0, 0))(
        torch.from_numpy(wt), _nchw(x), _nchw(gy))
    assert sorted(calls) == [(0, N), (1, 1), (2, 1), (3, N), (4, N), (5, N)]
    one = lambda a, b, c: _jax_quantized_conv(a[None], b, c[None], stride)  # noqa: E731
    _, jdx, jdw = jax.vmap(one, in_axes=(0, None, 0))(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(gy))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdx)[:, 0], **TOL)


@pytest.mark.parametrize("q_fwd,q_dgrad,q_wgrad", [
    (False, True, True), (True, False, True), (True, True, False)])
def test_quantize_flags_turn_off_their_gemm_only(monkeypatch, q_fwd, q_dgrad,
                                                 q_wgrad):
    x, wt, gy = _inputs(8, 8, 3, 2, seed=3)
    calls = _patch_quantizer(monkeypatch, per_fold=True)
    xt = _nchw(x).requires_grad_(True)
    wp = torch.from_numpy(wt).requires_grad_(True)
    y = fq.qconv2d(xt, wp, seed=7, flag=True, stride=2, fmt="luq_fp4",
                   backend="ref", q_fwd=q_fwd, q_dgrad=q_dgrad,
                   q_wgrad=q_wgrad)
    (y * _nchw(gy)).sum().backward()
    on = {0: q_fwd, 1: q_fwd, 2: q_dgrad, 3: q_dgrad, 4: q_wgrad, 5: q_wgrad}
    assert sorted(f for f, _ in calls) == sorted(f for f in on if on[f])
    s = {f: (_scale(f) if on[f] else 1.0) for f in on}
    X, W, G = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(gy)
    jy = _jax_conv(X * s[0], W * s[1], 2)
    (jdx,) = jax.vjp(lambda t: _jax_conv(t, W * s[2], 2), X)[1](G * s[3])
    (jdw,) = jax.vjp(lambda t: _jax_conv(X * s[4], t, 2), W)[1](G * s[5])
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wp.grad.numpy(), np.asarray(jdw), **TOL)
