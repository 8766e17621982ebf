"""The port's fake-quantized einsum (``repro_torch.quant.fake_quant.
qeinsum``, a hand-written forward and backward) against the JAX package's
``qeinsum`` (a custom VJP) and ``jax.vjp``.

The quantizer is patched to a deterministic stand-in in both packages, a
distinct scale per fold (``1 + fold / 8``), so each of the six quantize
points must feed the right operand: forward, dgrad and wgrad within 1e-5
(atol and rtol) for the four projections of the transformer, with the
``quantize_fwd/dgrad/wgrad`` options, and with the layer's flag off.

Per-example mode (the ghost engine's batched passes) equals the custom
op's vmap rule: a batched ``qeinsum(..., per_example=True)`` and the same
``qeinsum`` under ``torch.func.vmap`` give the same output and gradients
with the real LUQ-FP4 quantizer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

import repro.quant.fake_quant as jfq  # noqa: E402
from repro_torch.quant import fake_quant as fq  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, H, K, F = 2, 5, 6, 3, 4, 7
# the transformer's projections: q/k/v, o, gate/up, down
SPECS = {
    "bsd,dhk->bshk": ((B, S, D), (D, H, K)),
    "bshk,hkd->bsd": ((B, S, H, K), (H, K, D)),
    "bsd,df->bsf": ((B, S, D), (D, F)),
    "bsf,fd->bsd": ((B, S, F), (F, D)),
}


def _scale(fold: int) -> float:
    return 1.0 + fold / 8


@pytest.fixture
def stand_in(monkeypatch):
    """Both packages' quantizers become ``t * scale(fold)``."""
    def port(rows, fmt, backend, seed, fold, flag=None):
        return rows * _scale(fold)

    def reference(x, seed, fold, fmt, flag, backend="ref", per_example=False):
        return jnp.where(flag > 0.5, x * _scale(fold), x)

    monkeypatch.setattr(fq, "_quantize_rows", port)
    monkeypatch.setattr(jfq, "_maybe_quant", reference)


def _inputs(spec, seed):
    xs, ws = SPECS[spec]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    y = np.einsum(spec, x, w)
    gy = rng.standard_normal(y.shape).astype(np.float32)
    return x, w, gy


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("flag,qf,qd,qw", [
    (True, True, True, True), (True, False, True, False),
    (True, True, False, True), (False, True, True, True)])
def test_qeinsum_matches_jax_vjp(stand_in, spec, flag, qf, qd, qw):
    x, w, gy = _inputs(spec, len(spec))
    kw = dict(fmt="luq_fp4", q_fwd=qf, q_dgrad=qd, q_wgrad=qw)

    def jfn(a, b):
        return jfq.qeinsum(spec, a, b, seed=3, flag=float(flag),
                           backend="ref", **kw)

    y, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = fq.qeinsum(spec, tx, tw, seed=3, flag=flag, backend="ref", **kw)
    out.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("spec", list(SPECS))
def test_per_example_mode_equals_the_vmap_rule(spec):
    x, w, gy = _inputs(spec, 2 * len(spec))
    x, w, gy = (torch.from_numpy(a) for a in (x, w, gy))
    kw = dict(seed=5, flag=True, fmt="luq_fp4", backend="ref")

    def loss(xx, ww, gg):
        return (fq.qeinsum(spec, xx, ww, **kw) * gg).sum()

    # per example: each lane's x is one example (1, ...), quantized whole
    # by the custom op, batched by its vmap rule
    def one(xx, gg):
        return loss(xx[None], w, gg[None])

    vx = vmap(grad(one, argnums=0), randomness="same")(x, gy)
    vw = vmap(grad(lambda xx, ww, gg: loss(xx[None], ww, gg[None]),
                   argnums=1), in_dims=(0, None, 0),
              randomness="same")(x, w, gy).sum(dim=0)
    vy = vmap(lambda xx: fq.qeinsum(spec, xx[None], w, **kw)[0],
              randomness="same")(x)
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fq.qeinsum(spec, tx, tw, per_example=True, **kw)
    y.backward(gy)
    np.testing.assert_allclose(y.detach().numpy(), vy.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), vx.numpy(), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), vw.numpy(), **TOL)
    # and per example is not per tensor: the batch quantized whole differs
    flat = fq.qeinsum(spec, x, w, **kw)
    assert not torch.allclose(flat, y.detach())
