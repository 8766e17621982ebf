"""Mamba-2 (SSD, state-space duality) language model: training and oneshot
serving.

The counterpart of ``repro.models.mamba2``.  The chunked SSD algorithm
(Dao & Gu 2024, the "minimal SSD" formulation):

  * within a chunk, a quadratic attention-like term masked by the decay
    kernel ``L[i, j] = exp(cumsum(dA)_i - cumsum(dA)_j)`` (i >= j);
  * across chunks, each chunk's end state carried by a Python loop over
    the chunks (the reference's ``lax.scan``), which reads nothing to the
    host, so a train step stays capturable as a CUDA graph.

Decode is the O(1) state update.  Params are a flat dict with the JAX
package's leaf names and layouts: ``embed`` (V, d, tied with the logits),
``final_norm`` (d,) and the layer stacks ``blocks.<leaf>`` with a leading
layer axis (``blocks.in_proj`` (L, d, 2 d_inner + 2 N + H), fused as [z,
x, B, C, dt]; ``blocks.conv_w`` (L, W, d_inner); ...).  ngroups = 1: B
and C are shared by the heads.

DPQuant: the in and out projections (seeds ``97 * layer`` and ``+ 1``)
and the two SSD contractions (``+ 30``, ``+ 31``) quantize under the
layer's flag; the decay math stays float32 (no GEMM).  The SSD
contractions have an activation in the weight slot of ``qeinsum``
(``CB = C B^T`` and ``gate @ (x dt)``): under the vmap engine each
example's operand is quantized whole, one row per example, as the
reference's per-lane quantizer does under ``jax.vmap``.

Dtypes follow the reference's promotions at bf16 compute with float32
params: the prefill and training conv multiplies the bf16 ``x`` by the
float32 ``conv_w``, so its output and everything of the SSD is float32;
decode casts ``conv_w`` to bf16 and then adds the float32 ``conv_b``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.config import (ModelConfig, QuantConfig, generator,
                                torch_dtype)
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import Model, register_family

BLOCK_LEAVES = ("norm", "in_proj", "conv_w", "conv_b", "dt_bias", "A_log",
                "D", "out_norm", "out_proj")
_MATMUL_LEAVES = ("in_proj", "out_proj")


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    d, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    L, w = cfg.n_layers, cfg.conv_width
    init = functools.partial(cm.dense_init, generator=gen, device=device,
                             dtype=pdt)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "embed": cm.embed_init((cfg.padded_vocab, d), generator=gen,
                               device=device, dtype=pdt),
        "final_norm": torch.zeros((d,), dtype=pdt, device=device),
        "blocks.norm": torch.zeros((L, d), dtype=pdt, device=device),
        "blocks.in_proj": init((L, d, 2 * di + 2 * N + H), d),
        "blocks.conv_w": init((L, w, di), w),
        "blocks.conv_b": torch.zeros((L, di), dtype=pdt, device=device),
        "blocks.dt_bias": torch.zeros((L, H), **f32),
        "blocks.A_log": a_log.expand(L, H).contiguous(),
        "blocks.D": torch.ones((L, H), **f32),
        "blocks.out_norm": torch.zeros((L, di), dtype=pdt, device=device),
        "blocks.out_proj": init((L, di, d), di),
    }


def prepare(params: dict, cfg: ModelConfig) -> dict:
    """The in and out projections cast to the compute dtype once, for
    serving (the reference casts them on every call; the cast is
    deterministic).  ``conv_w`` stays float32: prefill's conv reads it so."""
    cd = torch_dtype(cfg.compute_dtype)
    return {name: (t.to(cd) if name.split(".")[-1] in _MATMUL_LEAVES else t)
            for name, t in params.items()}


def _layer(params: dict, i: int) -> dict:
    return {leaf: params[f"blocks.{leaf}"][i] for leaf in BLOCK_LEAVES}


def _softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, ``jax.nn.softplus``'s
    formula."""
    return torch.logaddexp(x, torch.zeros_like(x))


# --------------------------------------------------------------------------- #
# SSD core
# --------------------------------------------------------------------------- #
def _segsum(a):
    """a: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums,
    ``out[i, j] = sum_{k=j+1..i} a[k]`` for i >= j, -inf above the
    diagonal (``exp`` of it is 0, and its gradient an exact 0)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, flag, seed: int,
                quant: QuantConfig):
    """SSD forward.  Shapes:
      x:  (b, S, H, P)    inputs per head
      dt: (b, S, H)       positive step sizes
      A:  (H,)            negative decay rates
      B:  (b, S, N)       input maps (ngroups = 1)
      C:  (b, S, N)       output maps
    Returns y: (b, S, H, P) in ``x``'s dtype.  ``quant`` None (serving):
    the two contractions are plain einsums.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q != 0:
        # pad the tail (dt = 0: unit decay; x = 0: no state contribution)
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    xr = x.reshape(b, nc, Q, H, P)
    dtr = dt.reshape(b, nc, Q, H)
    Br = B.reshape(b, nc, Q, N)
    Cr = C.reshape(b, nc, Q, N)

    dA = dtr * A[None, None, None, :]                 # (b, nc, Q, H) negative
    dA_cum = torch.cumsum(dA, dim=2)

    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)

    # ---- within a chunk (quadratic, attention-like) ----
    Lmat = torch.exp(_segsum(dA.transpose(2, 3)))     # (b, nc, H, Q, Q)
    CB = qp("bcln,bcsn->bcls", Cr, Br, seed=seed + 30)  # (b, nc, Q, Q)
    gate = CB[:, :, None] * Lmat                       # (b, nc, H, L, S)
    xdt = xr * dtr[..., None]
    y_diag = qp("bchls,bcshp->bclhp", gate.to(xdt.dtype), xdt,
                seed=seed + 31)

    # ---- each chunk's end state ----
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b, nc, Q, H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Br.float(),
                          decay_states.float(), xdt.float())  # (b,nc,H,P,N)

    # ---- across chunks: the state before each chunk ----
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])               # (b, nc, H)
    carry = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,H,P,N)

    # ---- output of the carried states ----
    out_decay = torch.exp(dA_cum)                            # (b, nc, Q, H)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cr.float(), prev_states,
                         out_decay.float())

    y = y_diag.float() + y_off
    return y.reshape(b, S, H, P)[:, :S_orig].to(x.dtype)


def _causal_conv(x, w, b, state=None, activation=F.silu):
    """Depthwise causal conv, then ``activation`` (SiLU; None: none, as
    the Griffin hybrid calls it).  x: (B, S, D); w: (W, D); returns (y,
    new_state), ``new_state`` the (B, W-1, D) trailing input rows for
    decode.  ``x * w`` promotes as the reference's does (bf16 ``x`` and
    float32 ``w`` give float32)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    y = y + b[None, None, :]
    return (y if activation is None else activation(y)), new_state


def _split(zxbcdt, cfg: ModelConfig):
    """The fused in-projection's parts: z, x (compute dtype), B, C, dt
    (float32, dt before its bias and softplus)."""
    di, N = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + N].float(),
            zxbcdt[..., 2 * di + N:2 * di + 2 * N].float(),
            zxbcdt[..., 2 * di + 2 * N:].float())


def mamba_block(x, blk, *, flag, seed: int, cfg: ModelConfig,
                quant: QuantConfig, conv_state=None):
    """A Mamba-2 block (training and prefill path); returns the residual
    branch and the conv's trailing rows."""
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    cd = x.dtype

    h = cm.rmsnorm(x, blk["norm"]).to(cd)
    zxbcdt = qp("bsd,de->bse", h, blk["in_proj"].to(cd), seed=seed)
    z, xs, Bc, Cc, dt = _split(zxbcdt, cfg)
    xs, new_conv = _causal_conv(xs, blk["conv_w"], blk["conv_b"], conv_state)
    dt = _softplus(dt + blk["dt_bias"][None, None, :])
    A = -torch.exp(blk["A_log"])

    xh = xs.reshape(*xs.shape[:2], H, P)
    y = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk, flag, seed, quant)
    y = y + xh.float() * blk["D"][None, None, :, None]
    y = y.reshape(*xs.shape[:2], di).to(cd)
    # gated RMSNorm (mamba2 style)
    y = cm.rmsnorm(y * F.silu(z), blk["out_norm"])
    out = qp("bse,ed->bsd", y.to(cd), blk["out_proj"].to(cd), seed=seed + 1)
    return out, new_conv


def _residual(x, blk, **kw):
    out, _ = mamba_block(x, blk, **kw)
    return x + out


def forward_hidden(params, tokens, qflags, cfg: ModelConfig,
                   quant: QuantConfig):
    """Final-norm hidden states (B, S, d) of a training forward; each
    block recomputed in the backward under the dense transformer's remat
    rule (``transformer._remat``)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    # one unbind per stacked leaf (see transformer.forward_hidden)
    stacks = {leaf: params[f"blocks.{leaf}"].unbind(0)
              for leaf in BLOCK_LEAVES}
    remat = tfm._remat(cfg)
    for i in range(cfg.n_layers):
        blk = {leaf: stacks[leaf][i] for leaf in BLOCK_LEAVES}
        block = functools.partial(_residual, flag=qflags[i], seed=97 * i,
                                  cfg=cfg, quant=quant)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block, x, blk, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, blk)
    return cm.rmsnorm(x, params["final_norm"])


def lm_loss(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S).  The
    JAX package's ``lm_loss`` also takes an rng, which it deletes; the
    port leaves it out."""
    tokens = batch["tokens"]
    h = forward_hidden(params, tokens, qflags, cfg, quant)
    return cm.chunked_lm_loss(h[:, :-1], tokens[:, 1:], params["embed"],
                              real_vocab=cfg.vocab_size,
                              ce_chunk=cfg.ce_chunk)


# --------------------------------------------------------------------------- #
# serving: O(1)-state decode
# --------------------------------------------------------------------------- #
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int):
    """``{name: (shape, dtype)}`` of a cache; its size does not depend on
    ``seq_len`` (that is the point).  ``pos`` is host-side."""
    del seq_len
    L, H, P, N = cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm": ((L, batch, H, P, N), torch.float32),
        "conv": ((L, batch, cfg.conv_width - 1, cfg.d_inner),
                 torch_dtype(cfg.compute_dtype)),
        "pos": ((), torch.int32),
    }


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, quant: QuantConfig,
            cache_len=None):
    """Run the prompt; return the last token's float32 logits (B, V_pad)
    and the recurrent cache (``ssm`` (L, B, H, P, N) float32, ``conv``
    (L, B, W-1, d_inner), ``pos`` a host int).  Every projection is
    unquantized, as the reference's zero flags make it; ``cache_len`` is
    not needed (the state has a fixed size)."""
    del cache_len
    tokens = batch["tokens"]
    B, S = tokens.shape
    cd = torch_dtype(cfg.compute_dtype)
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    x = params["embed"][tokens].to(cd)
    ssm_states, conv_states = [], []
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = cm.rmsnorm(x, blk["norm"]).to(cd)
        zxbcdt = torch.einsum("bsd,de->bse", h, blk["in_proj"].to(cd))
        z, xs, Bc, Cc, dt = _split(zxbcdt, cfg)
        dt = _softplus(dt + blk["dt_bias"][None, None, :])
        xs, conv_state = _causal_conv(xs, blk["conv_w"], blk["conv_b"])
        A = -torch.exp(blk["A_log"])
        xh = xs.reshape(B, S, H, P)
        y = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk, False, 97 * i,
                        None)
        # the final state, recomputed from the whole sequence's decays
        dA_cum = torch.cumsum(dt * A[None, None, :], dim=1)
        decay = torch.exp(dA_cum[:, -1:, :] - dA_cum)          # (B, S, H)
        xdt = xh * dt[..., None]
        ssm_states.append(torch.einsum("bsn,bsh,bshp->bhpn", Bc, decay,
                                       xdt.float()))
        conv_states.append(conv_state)
        y = y + xh.float() * blk["D"][None, None, :, None]
        y = cm.rmsnorm(y.reshape(B, S, di).to(cd) * F.silu(z),
                       blk["out_norm"])
        x = x + torch.einsum("bse,ed->bsd", y.to(cd), blk["out_proj"].to(cd))
    h_last = cm.rmsnorm(x[:, -1], params["final_norm"]).float()
    logits = h_last @ params["embed"].float().T
    return logits, {"ssm": torch.stack(ssm_states),
                    "conv": torch.stack(conv_states), "pos": S}


@torch.no_grad()
def decode_step(params, cache, token, cfg: ModelConfig, quant: QuantConfig):
    """Append one token (B,) to every row; returns (logits, new cache)."""
    cd = torch_dtype(cfg.compute_dtype)
    B = token.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    x = params["embed"][token].to(cd)
    ssm_states, conv_states = [], []
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        ssm, conv = cache["ssm"][i], cache["conv"][i]  # (B,H,P,N), (B,W-1,di)
        h = cm.rmsnorm(x, blk["norm"]).to(cd)
        zxbcdt = torch.einsum("bd,de->be", h, blk["in_proj"].to(cd))
        z, xs, Bc, Cc, dt = _split(zxbcdt, cfg)
        dt = _softplus(dt + blk["dt_bias"][None, :])
        # the conv over the ring of the last W inputs
        xw = torch.cat([conv.to(cd), xs[:, None, :]], dim=1)   # (B, W, di)
        y_conv = torch.einsum("bwd,wd->bd", xw, blk["conv_w"].to(cd))
        xs = F.silu(y_conv + blk["conv_b"][None, :])
        conv_states.append(xw[:, 1:])
        # the state update
        A = -torch.exp(blk["A_log"])
        dA = torch.exp(dt * A[None, :])                          # (B, H)
        xh = xs.reshape(B, H, P).float()
        new_ssm = (ssm * dA[:, :, None, None]
                   + torch.einsum("bhp,bn,bh->bhpn", xh, Bc, dt))
        ssm_states.append(new_ssm)
        y = torch.einsum("bhpn,bn->bhp", new_ssm, Cc)
        y = y + xh * blk["D"][None, :, None]
        y = cm.rmsnorm(y.reshape(B, di).to(cd) * F.silu(z), blk["out_norm"])
        x = x + torch.einsum("be,ed->bd", y.to(cd), blk["out_proj"].to(cd))
    h_last = cm.rmsnorm(x, params["final_norm"]).float()
    logits = h_last @ params["embed"].float().T
    return logits, {"ssm": torch.stack(ssm_states),
                    "conv": torch.stack(conv_states),
                    "pos": cache["pos"] + 1}


# --------------------------------------------------------------------------- #
# registry glue
# --------------------------------------------------------------------------- #
@register_family("ssm")
def build_ssm(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=functools.partial(prepare, cfg=cfg),
        loss_fn=functools.partial(lm_loss, cfg=cfg, quant=quant),
        prefill=functools.partial(prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(decode_step, cfg=cfg, quant=quant),
        kv_formats=("none",),
    )
