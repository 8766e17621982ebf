"""Encoder-decoder transformer (whisper-medium): training and oneshot
serving.

The counterpart of ``repro.models.encdec``.  As there, the audio frontend
(conv + mel) is a stub: a batch carries precomputed frame embeddings
``enc_embeds`` (B, S, d_model) in the compute dtype, as long as its tokens
(``batch_spec`` ties the two lengths, as the reference's does).  Both
stacks add float32 sinusoidal positions cast to the compute dtype;
attention is multi-head (kv = heads) without RoPE, the MLP the tanh GELU,
the norms RMSNorm of the ``1 + scale`` form.

Params are a flat dict with the reference's nested tree joined by dots:
``embed`` (V_pad, d, tied with the logits), ``enc_norm``, ``final_norm``,
the encoder stack ``enc.{attn_norm,mlp_norm,wq,wk,wv,wo,wi,wo_mlp}`` and
the decoder stack ``dec.{self_norm,cross_norm,mlp_norm,self_w*,cross_w*,
wi,wo_mlp}``, each with a leading layer axis (``wq`` (L, d, H, hd), ``wo``
(L, H, hd, d)).

DPQuant: the policy spans both stacks.  ``qflags[l]`` gates encoder block
``l`` and ``qflags[n_enc + l]`` decoder block ``l``: its self-attention,
its cross-attention (K and V projected from the encoder's output) and its
MLP.  The reference's seeds: encoder block ``l`` at ``97 l``, decoder
block ``l`` at ``97 (l + 1000)``, its cross-attention at ``+ 10``; inside
an attention q, k, v, o at ``+ 0..3``, the MLP's two projections at ``+
4, 5``.  With ``ModelConfig.remat`` each block is recomputed in the
backward under the dense transformer's rule (``transformer._remat``).

Serving: ``prefill`` encodes and runs the decoder prompt with plain
einsums (the reference's flags are 0 there), caching the decoder's self
K/V and the cross K/V (projected once from the encoder's output), both
padded to ``cache_len`` rows; ``decode_step`` writes the self cache at
``pos`` and attends it up to ``pos`` and the cross cache up to ``enc_len -
1``.  The logits are a float32 product with no quantizer, so serving runs
no kernel of the port.  The cache is ``self_k``, ``self_v``, ``cross_k``,
``cross_v`` (L_dec, B, KV, cache_len, hd) in the compute dtype, the
reference's layout, and ``enc_len`` and ``pos`` as host ints (the
reference keeps int32 scalars).

The reference's family has no per-example loss and no ghost hooks: it
trains in the vmap engine only.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.config import (ModelConfig, QuantConfig, generator,
                                torch_dtype)
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import Model, register_family
from repro_torch.quant import kv_cache as kvc

ATTN_LEAVES = ("wq", "wk", "wv", "wo")
MLP_LEAVES = ("wi", "wo_mlp")
ENC_LEAVES = ("attn_norm", "mlp_norm") + ATTN_LEAVES + MLP_LEAVES
DEC_LEAVES = (("self_norm", "cross_norm", "mlp_norm")
              + tuple(f"self_{k}" for k in ATTN_LEAVES)
              + tuple(f"cross_{k}" for k in ATTN_LEAVES) + MLP_LEAVES)
_MATMUL_LEAVES = frozenset(ATTN_LEAVES + MLP_LEAVES + DEC_LEAVES[3:])
SEED_STRIDE = 97
DEC_SEED_BASE = 1000          # decoder block l: 97 (l + 1000)
CROSS_SEED = 10               # a decoder block's cross-attention: + 10
CACHE_LEAVES = ("self_k", "self_v", "cross_k", "cross_v")


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def _attn_init(init, cfg: ModelConfig, n: int) -> dict:
    d, hp, kv, hd = cfg.d_model, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": init((n, d, hp, hd), d), "wk": init((n, d, kv, hd), d),
            "wv": init((n, d, kv, hd), d), "wo": init((n, hp, hd, d), hp * hd)}


def _mlp_init(init, cfg: ModelConfig, n: int) -> dict:
    return {"wi": init((n, cfg.d_model, cfg.d_ff), cfg.d_model),
            "wo_mlp": init((n, cfg.d_ff, cfg.d_model), cfg.d_ff)}


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    init = functools.partial(cm.dense_init, generator=gen, device=device,
                             dtype=pdt)
    ne, nd, d = cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    enc = {"attn_norm": zeros(ne, d), "mlp_norm": zeros(ne, d),
           **_attn_init(init, cfg, ne), **_mlp_init(init, cfg, ne)}
    dec = {"self_norm": zeros(nd, d), "cross_norm": zeros(nd, d),
           "mlp_norm": zeros(nd, d),
           **{f"self_{k}": v for k, v in _attn_init(init, cfg, nd).items()},
           **{f"cross_{k}": v for k, v in _attn_init(init, cfg, nd).items()},
           **_mlp_init(init, cfg, nd)}
    params = {"embed": cm.embed_init((cfg.padded_vocab, d), generator=gen,
                                     device=device, dtype=pdt),
              "enc_norm": zeros(d), "final_norm": zeros(d)}
    params.update({f"enc.{k}": v for k, v in enc.items()})
    params.update({f"dec.{k}": v for k, v in dec.items()})
    return params


def prepare(params: dict, cfg: ModelConfig) -> dict:
    """The projections cast to the compute dtype once, for serving (the
    reference casts them on every call; the cast is deterministic).  The
    embedding stays float32: the logits are a float32 product."""
    cd = torch_dtype(cfg.compute_dtype)
    return {name: (t.to(cd) if name.split(".")[-1] in _MATMUL_LEAVES else t)
            for name, t in params.items()}


def _layers(params: dict, stack: str, leaves) -> list:
    """The per-layer dicts of ``stack`` (``enc`` or ``dec``), one unbind a
    leaf (see transformer.forward_hidden)."""
    unbound = {leaf: params[f"{stack}.{leaf}"].unbind(0) for leaf in leaves}
    n = len(unbound[leaves[0]])
    return [{leaf: t[i] for leaf, t in unbound.items()} for i in range(n)]


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def _mha(h, prm, prefix: str, flag, seed: int, cfg: ModelConfig, quant,
         kv_h=None, causal: bool = False):
    """Attention of ``h`` over itself, or over ``kv_h`` (cross-attention),
    with the projections of ``prm[prefix + w*]``; returns (out, (k, v)).
    ``quant`` None (serving): plain einsums."""
    cd = h.dtype
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    q = qp("bsd,dhk->bshk", h, prm[f"{prefix}wq"].to(cd), seed=seed)
    src = h if kv_h is None else kv_h
    k = qp("bsd,dhk->bshk", src, prm[f"{prefix}wk"].to(cd), seed=seed + 1)
    v = qp("bsd,dhk->bshk", src, prm[f"{prefix}wv"].to(cd), seed=seed + 2)
    n_rep = cfg.padded_heads // k.shape[2]
    out = cm.chunked_causal_attention(
        q, cm.repeat_kv(k, n_rep), cm.repeat_kv(v, n_rep),
        chunk_q=cfg.attn_chunk_q, causal=causal,
        scale=1.0 / math.sqrt(cfg.head_dim))
    res = qp("bshk,hkd->bsd", out, prm[f"{prefix}wo"].to(cd), seed=seed + 3)
    return res, (k, v)


def _mlp(h, prm, flag, seed: int, quant):
    cd = h.dtype
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    a = F.gelu(qp("bsd,df->bsf", h, prm["wi"].to(cd), seed=seed + 4),
               approximate="tanh")
    return qp("bsf,fd->bsd", a, prm["wo_mlp"].to(cd), seed=seed + 5)


def _enc_block(x, blk, *, flag, seed: int, cfg: ModelConfig, quant):
    cd = torch_dtype(cfg.compute_dtype)
    h = cm.rmsnorm(x, blk["attn_norm"]).to(cd)
    a, _ = _mha(h, blk, "", flag, seed, cfg, quant)
    x = x + a
    h2 = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
    return x + _mlp(h2, blk, flag, seed, quant)


def _dec_block(x, enc_out, blk, *, flag, seed: int, cfg: ModelConfig, quant):
    """One decoder block; returns (x, (self k, v), (cross k, v))."""
    cd = torch_dtype(cfg.compute_dtype)
    h = cm.rmsnorm(x, blk["self_norm"]).to(cd)
    a, self_kv = _mha(h, blk, "self_", flag, seed, cfg, quant, causal=True)
    x = x + a
    h2 = cm.rmsnorm(x, blk["cross_norm"]).to(cd)
    c, cross_kv = _mha(h2, blk, "cross_", flag, seed + CROSS_SEED, cfg, quant,
                       kv_h=enc_out)
    x = x + c
    h3 = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
    return x + _mlp(h3, blk, flag, seed, quant), self_kv, cross_kv


def _dec_seed(layer: int) -> int:
    return SEED_STRIDE * (layer + DEC_SEED_BASE)


def _run(block, remat: bool, *args):
    if remat:
        # exact recomputation: the quantizers' draws are keyed by their
        # static (seed, fold) (see transformer.forward_hidden)
        return torch.utils.checkpoint.checkpoint(
            block, *args, use_reentrant=False, preserve_rng_state=False)
    return block(*args)


def _positions(x, cfg: ModelConfig, offset: int = 0):
    """``x`` (B, S, d) plus the sinusoidal positions from ``offset``, made
    in float32 and cast to the compute dtype."""
    cd = torch_dtype(cfg.compute_dtype)
    pos = cm.sinusoidal_positions(x.shape[1], cfg.d_model, offset,
                                  device=x.device)
    return x.to(cd) + pos.to(cd)[None]


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def encode(params, enc_embeds, qflags, cfg: ModelConfig,
           quant: Optional[QuantConfig]):
    """The encoder's final-norm output (B, S, d) in the compute dtype.
    ``qflags``: one host bool per policy layer, or the trainer's flags
    tensor (the first ``n_enc_layers`` gate the encoder)."""
    x = _positions(enc_embeds, cfg)
    remat = tfm._remat(cfg)
    for i, blk in enumerate(_layers(params, "enc", ENC_LEAVES)):
        block = functools.partial(_enc_block, flag=qflags[i],
                                  seed=SEED_STRIDE * i, cfg=cfg, quant=quant)
        x = _run(block, remat, x, blk)
    return cm.rmsnorm(x, params["enc_norm"])


def decode_hidden(params, tokens, enc_out, qflags, cfg: ModelConfig,
                  quant: QuantConfig):
    """The decoder's final-norm hidden states (B, S, d) of a training
    forward over ``tokens`` (B, S), attending ``enc_out``."""
    x = _positions(params["embed"][tokens], cfg)
    remat = tfm._remat(cfg)
    n_enc = cfg.n_enc_layers
    for i, blk in enumerate(_layers(params, "dec", DEC_LEAVES)):
        def block(x, enc_out, blk, i=i):
            return _dec_block(x, enc_out, blk, flag=qflags[n_enc + i],
                              seed=_dec_seed(i), cfg=cfg, quant=quant)[0]
        x = _run(block, remat, x, enc_out, blk)
    return cm.rmsnorm(x, params["final_norm"])


def loss_fn(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S) given
    ``batch["enc_embeds"]``, with the tied head and the padded vocabulary
    masked.  The JAX package's ``loss_fn`` also takes an rng, which it
    deletes; the port leaves it out."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["enc_embeds"], qflags, cfg, quant)
    h = decode_hidden(params, tokens, enc_out, qflags, cfg, quant)
    return cm.chunked_lm_loss(h[:, :-1], tokens[:, 1:], params["embed"],
                              real_vocab=cfg.vocab_size,
                              ce_chunk=cfg.ce_chunk)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``{name: (shape, dtype)}`` of a cache; ``enc_len`` and ``pos`` are
    host ints."""
    cd = torch_dtype(cfg.compute_dtype)
    shape = (cfg.n_dec_layers, batch, cfg.n_kv_heads, seq_len, cfg.head_dim)
    return {**{name: (shape, cd) for name in CACHE_LEAVES},
            "enc_len": ((), torch.int32), "pos": ((), torch.int32)}


def _to_cache(t, rows: int):
    """(B, S, KV, hd) -> (B, KV, max(S, rows), hd), zero rows past S."""
    t = t.transpose(1, 2)
    if rows > t.shape[2]:
        t = F.pad(t, (0, 0, 0, rows - t.shape[2]))
    return t


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, quant: QuantConfig,
            cache_len: Optional[int] = None):
    """Encode ``batch["enc_embeds"]`` and run the prompt
    ``batch["tokens"]`` (B, S); return the last token's float32 logits (B,
    V_pad) and the cache (see :func:`cache_spec`) of ``cache_len`` rows
    (default S)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cache_len = cache_len or S
    off = (False,) * cfg.policy_len()
    enc_out = encode(params, batch["enc_embeds"], off, cfg, None)
    x = _positions(params["embed"][tokens], cfg)
    rows = {name: [] for name in CACHE_LEAVES}
    for blk in _layers(params, "dec", DEC_LEAVES):
        x, (sk, sv), (ck, cv) = _dec_block(x, enc_out, blk, flag=False,
                                           seed=0, cfg=cfg, quant=None)
        for name, t in zip(CACHE_LEAVES, (sk, sv, ck, cv)):
            rows[name].append(_to_cache(t, cache_len))
    h_last = cm.rmsnorm(x[:, -1], params["final_norm"]).float()
    cache = {name: torch.stack(ts) for name, ts in rows.items()}
    cache["enc_len"] = batch["enc_embeds"].shape[1]
    cache["pos"] = S
    return h_last @ params["embed"].float().T, cache


def _attend(q, kc, vc, last: int, cfg: ModelConfig):
    """One query a row, ``q`` (B, H, hd), over the cache rows ``0..last``
    of ``kc``, ``vc`` (B, KV, S, hd): the reference's ``decode_attend``,
    the plain ``kv_fmt="none"`` attention."""
    return kvc.ref_decode_attn("none", q, kc, vc, None, None, last,
                               n_kv=cfg.n_kv_heads,
                               scale=1.0 / math.sqrt(cfg.head_dim))


@torch.no_grad()
def decode_step(params, cache, token, cfg: ModelConfig, quant: QuantConfig):
    """Append one token (B,) to every row at ``cache["pos"]``; writes the
    self cache in place and returns ``(logits, cache)``."""
    cd = torch_dtype(cfg.compute_dtype)
    pos, enc_len = int(cache["pos"]), int(cache["enc_len"])
    x = _positions(params["embed"][token][:, None], cfg, offset=pos)[:, 0]
    # the write clamped into the cache, as dynamic_update_slice clamps
    wpos = min(pos, cache["self_k"].shape[3] - 1)

    def proj(h, w):
        return torch.einsum("bd,dhk->bhk", h, w.to(cd))

    def out(ctx, w):
        return torch.einsum("bhk,hkd->bd", ctx.to(cd), w.to(cd))

    for i, blk in enumerate(_layers(params, "dec", DEC_LEAVES)):
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        h = cm.rmsnorm(x, blk["self_norm"]).to(cd)
        q = proj(h, blk["self_wq"])
        sk[:, :, wpos] = proj(h, blk["self_wk"]).to(sk.dtype)
        sv[:, :, wpos] = proj(h, blk["self_wv"]).to(sv.dtype)
        x = x + out(_attend(q, sk, sv, pos, cfg), blk["self_wo"])
        h2 = cm.rmsnorm(x, blk["cross_norm"]).to(cd)
        ctx = _attend(proj(h2, blk["cross_wq"]), cache["cross_k"][i],
                      cache["cross_v"][i], enc_len - 1, cfg)
        x = x + out(ctx, blk["cross_wo"])
        h3 = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
        a = F.gelu(torch.einsum("bd,df->bf", h3, blk["wi"].to(cd)),
                   approximate="tanh")
        x = x + torch.einsum("bf,fd->bd", a, blk["wo_mlp"].to(cd))
    h_last = cm.rmsnorm(x, params["final_norm"]).float()
    cache["pos"] = pos + 1
    return h_last @ params["embed"].float().T, cache


# --------------------------------------------------------------------------- #
# registry glue
# --------------------------------------------------------------------------- #
def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a batch: the token ids and the
    encoder's frame embeddings, as many as the tokens."""
    return {"tokens": ((batch, seq), torch.int32),
            "enc_embeds": ((batch, seq, cfg.d_model),
                           torch_dtype(cfg.compute_dtype))}


@register_family("encdec")
def build_encdec(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=functools.partial(prepare, cfg=cfg),
        loss_fn=functools.partial(loss_fn, cfg=cfg, quant=quant),
        batch_spec=functools.partial(batch_spec, cfg),
        prefill=functools.partial(prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(decode_step, cfg=cfg, quant=quant),
        kv_formats=("none",),
    )
