"""Dense decoder-only GQA transformer (gemma / yi / stablelm families):
the serving path.

The counterpart of ``repro.models.transformer``'s serving functions.  Params
are a flat dict with the JAX package's leaf names and layouts: ``embed``
(V, d), ``final_norm`` (d,), ``lm_head`` (d, V) when untied, and the layer
stacks ``blocks.<leaf>`` with a leading layer axis (``blocks.wq`` is
(L, d, H, hd), ``blocks.wo`` (L, H, hd, d), ...).  Layers run as a Python
loop.

Serving runs every projection unquantized (the JAX package's policy flag
is 0 there); only the logits head goes through the quantizer dispatch
(``common.qlogits``), and a quantized KV cache through the ``kv_quant`` /
``decode_attn`` ops.

Caches are dicts: ``k``/``v`` (L, B, KV, S, code_dim) on the device, plus
``k_scale``/``v_scale`` (L, B, KV, S) bf16 when quantized, and ``pos``,
which stays on the host (an int for a lockstep batch, a CPU int32 (B,)
tensor for a slot pool): the host needs the positions anyway to seed the
per-position logits streams, so keeping them there costs no device sync.
Decode functions write the cache in place and return it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, QuantConfig, torch_dtype
from repro_torch.models import common as cm
from repro_torch.models.registry import Model, register_family

BLOCK_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wi_gate",
                "wi_up", "wo_mlp")
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_mlp")


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (same shapes and init scales as the
    JAX package, not the same numbers: torch draws its own stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    d, hp, kv, hd, f, L = (cfg.d_model, cfg.padded_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.n_layers)
    init = functools.partial(cm.dense_init, generator=gen, device=device,
                             dtype=pdt)
    params = {
        "embed": cm.embed_init((cfg.padded_vocab, d), generator=gen,
                               device=device, dtype=pdt),
        "final_norm": torch.zeros((d,), dtype=pdt, device=device),
        "blocks.attn_norm": torch.zeros((L, d), dtype=pdt, device=device),
        "blocks.wq": init((L, d, hp, hd), d),
        "blocks.wk": init((L, d, kv, hd), d),
        "blocks.wv": init((L, d, kv, hd), d),
        "blocks.wo": init((L, hp, hd, d), hp * hd),
        "blocks.mlp_norm": torch.zeros((L, d), dtype=pdt, device=device),
        "blocks.wi_gate": init((L, d, f), d),
        "blocks.wi_up": init((L, d, f), d),
        "blocks.wo_mlp": init((L, f, d), f),
    }
    # zero the padded query heads so padding is semantics-preserving
    params["blocks.wq"][:, :, cfg.n_heads:, :] = 0
    if not cfg.tie_embeddings:
        params["lm_head"] = init((d, cfg.padded_vocab), d)
    return params


def prepare(params: dict, cfg: ModelConfig) -> dict:
    """Cast the block matmul weights to the compute dtype once.

    The JAX package casts each float32 block weight to the compute dtype on
    every call; the cast is deterministic, so doing it once here computes
    the same numbers without re-reading the float32 weights on every
    decode tick.  Other leaves are shared with ``params``.
    """
    cd = torch_dtype(cfg.compute_dtype)
    return {name: (t.to(cd) if name.split(".")[-1] in _MATMUL_LEAVES else t)
            for name, t in params.items()}


def _layer(params: dict, i: int) -> dict:
    return {leaf: params[f"blocks.{leaf}"][i] for leaf in BLOCK_LEAVES}


def _head_t(params: dict, cfg: ModelConfig):
    """(d, V) logits projection."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed(params, tokens, cfg: ModelConfig):
    cd = torch_dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    # gemma-style scaling
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd, device=x.device)


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def _activation(gate, up, kind: str):
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "relu":
        return F.relu(gate)
    raise ValueError(kind)


def attention_block(x, blk, positions, cfg: ModelConfig):
    """Pre-norm GQA attention with RoPE; returns the residual branch and
    the compact (pre-repeat) K, V."""
    cd = torch_dtype(cfg.compute_dtype)
    h = cm.rmsnorm(x, blk["attn_norm"]).to(cd)
    q = torch.einsum("bsd,dhk->bshk", h, blk["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", h, blk["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", h, blk["wv"].to(cd))
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    n_rep = cfg.padded_heads // cfg.n_kv_heads
    out = cm.chunked_causal_attention(
        q, cm.repeat_kv(k, n_rep), cm.repeat_kv(v, n_rep),
        chunk_q=cfg.attn_chunk_q, scale=1.0 / math.sqrt(cfg.head_dim))
    res = torch.einsum("bshk,hkd->bsd", out, blk["wo"].to(cd))
    return res, (k, v)


def mlp_block(x, blk, cfg: ModelConfig):
    cd = torch_dtype(cfg.compute_dtype)
    h = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
    gate = torch.einsum("bsd,df->bsf", h, blk["wi_gate"].to(cd))
    up = torch.einsum("bsd,df->bsf", h, blk["wi_up"].to(cd))
    act = _activation(gate, up, cfg.mlp_activation)
    return torch.einsum("bsf,fd->bsd", act, blk["wo_mlp"].to(cd))


# --------------------------------------------------------------------------- #
# serving: prefill + decode with KV cache
# --------------------------------------------------------------------------- #
def _kv_impls(kv_fmt: str, quant: Optional[QuantConfig]):
    """The dispatched (kv_quant, decode_attn) impls for a cache format."""
    from repro_torch.quant import backend as qbackend

    be = quant.backend if quant is not None else None
    kvq, _ = qbackend.get_kv_quant(kv_fmt, be)
    attn, _ = qbackend.get_decode_attn(kv_fmt, be)
    return kvq, attn


def kv_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                  kv_fmt: str = "none"):
    """``{name: (shape, dtype)}`` of a cache; ``pos`` is host-side."""
    from repro_torch.quant import kv_cache as kvc

    cd = torch_dtype(cfg.compute_dtype)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    code_dt, code_dim = kvc.code_spec(kv_fmt, hd)
    spec = {
        "k": ((L, batch, kv, seq_len, code_dim), code_dt or cd),
        "v": ((L, batch, kv, seq_len, code_dim), code_dt or cd),
        "pos": ((), torch.int32),
    }
    if kv_fmt != "none":
        spec["k_scale"] = ((L, batch, kv, seq_len), kvc.SCALE_DTYPE)
        spec["v_scale"] = ((L, batch, kv, seq_len), kvc.SCALE_DTYPE)
    return spec


def slot_cache_spec(cfg: ModelConfig, n_slots: int, max_seq: int,
                    kv_fmt: str = "none"):
    """Slot-pool cache: ``kv_cache_spec`` with a (n_slots,) ``pos``."""
    spec = kv_cache_spec(cfg, n_slots, max_seq, kv_fmt=kv_fmt)
    spec["pos"] = ((n_slots,), torch.int32)
    return spec


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, quant: QuantConfig,
            cache_len: Optional[int] = None, kv_fmt: str = "none",
            prompt_len: Optional[int] = None):
    """Run the full prompt; return (last-token logits, filled KV cache).

    ``prompt_len`` supports bucketed prefill: the token batch may be padded
    beyond the real prompt, and the last-token logits, the cache position
    and the logits stream are taken at ``prompt_len``.  Padding changes
    nothing for the real rows (attention is causal) and rows at index
    >= pos are masked until a decode tick overwrites them.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        attn_out, (k, v) = attention_block(x, blk, positions, cfg)
        x = x + attn_out
        x = x + mlp_block(x, blk, cfg)
        ks.append(k.transpose(1, 2))           # (B, KV, S, hd)
        vs.append(v.transpose(1, 2))
    plen = S if prompt_len is None else int(prompt_len)
    h_last = cm.rmsnorm(x[:, plen - 1], params["final_norm"]).float()
    # even folds = prefill, odd folds = decode (pos == S after prefill, so a
    # bare fold of the position would reuse the first decode step's stream)
    logits = cm.qlogits(h_last, _head_t(params, cfg), quant_cfg=quant,
                        folds=2 * plen)
    ks, vs = torch.stack(ks), torch.stack(vs)  # (L, B, KV, S, hd)
    cache = {"k": ks, "v": vs, "pos": plen}
    if kv_fmt != "none":
        kvq, _ = _kv_impls(kv_fmt, quant)
        kc, ksc = kvq(ks)
        vc, vsc = kvq(vs)
        cache = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc,
                 "pos": plen}
    if cache_len > S:
        # zero rows past the prompt: they quantize to zero codes and zero
        # scales, so padding after quantizing equals quantizing the padding
        extra = cache_len - S
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in cache:
                t = cache[name]
                # the sequence axis is 3: last of a scale array, second to
                # last of a code array
                cache[name] = F.pad(t, (0, extra) if t.dim() == 4
                                    else (0, 0, 0, extra))
    return logits, cache


def _decode_trunk(params, cache, token, pos, cfg: ModelConfig,
                  quant: Optional[QuantConfig] = None, kv_fmt: str = "none"):
    """Shared one-token trunk for lockstep and slot decode.

    ``pos`` is a (B,) int tensor on the device.  Each row's K/V is written
    at its own position (clamped into the cache, as the JAX package's
    dynamic_update_slice does) before attention reads it, and each row
    attends to rows ``<= pos``.  Writes the cache in place; returns the
    final-norm hidden states (B, d) float32.
    """
    cd = torch_dtype(cfg.compute_dtype)
    x = _embed(params, token, cfg)
    positions = pos[:, None]
    quantized = kv_fmt != "none"
    kvq, attend = _kv_impls(kv_fmt, quant)
    attn_scale = 1.0 / math.sqrt(cfg.head_dim)
    S = cache["k"].shape[3]
    rows = torch.arange(token.shape[0], device=token.device)
    wpos = pos.clamp(max=S - 1).long()
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]          # (B, KV, S, Dc) views
        h = cm.rmsnorm(x, blk["attn_norm"]).to(cd)
        q = torch.einsum("bd,dhk->bhk", h, blk["wq"].to(cd))
        k = torch.einsum("bd,dhk->bhk", h, blk["wk"].to(cd))
        v = torch.einsum("bd,dhk->bhk", h, blk["wv"].to(cd))
        q = cm.rope(q[:, None], positions, cfg.rope_theta)[:, 0]
        k = cm.rope(k[:, None], positions, cfg.rope_theta)[:, 0]
        ksc = vsc = None
        if quantized:
            ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
            k_codes, k_sc = kvq(k)                      # (B, KV, Dc), (B, KV)
            v_codes, v_sc = kvq(v)
            kc[rows, :, wpos] = k_codes
            vc[rows, :, wpos] = v_codes
            ksc[rows, :, wpos] = k_sc
            vsc[rows, :, wpos] = v_sc
        else:
            kc[rows, :, wpos] = k.to(kc.dtype)
            vc[rows, :, wpos] = v.to(vc.dtype)
        ctx = attend(q, kc, vc, ksc, vsc, pos, n_kv=cfg.n_kv_heads,
                     scale=attn_scale)
        x = x + torch.einsum("bhk,hkd->bd", ctx.to(cd), blk["wo"].to(cd))
        h2 = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
        gate = torch.einsum("bd,df->bf", h2, blk["wi_gate"].to(cd))
        up = torch.einsum("bd,df->bf", h2, blk["wi_up"].to(cd))
        act = _activation(gate, up, cfg.mlp_activation)
        x = x + torch.einsum("bf,fd->bd", act, blk["wo_mlp"].to(cd))
    return cm.rmsnorm(x, params["final_norm"]).float()


@torch.no_grad()
def decode_step(params, cache, token, cfg: ModelConfig, quant: QuantConfig,
                kv_fmt: str = "none"):
    """Append one token to a lockstep batch (every row at ``cache["pos"]``);
    returns (logits, cache)."""
    pos = int(cache["pos"])
    pos_dev = torch.full((token.shape[0],), pos, dtype=torch.int32,
                         device=token.device)
    h_last = _decode_trunk(params, cache, token, pos_dev, cfg, quant=quant,
                           kv_fmt=kv_fmt)
    logits = cm.qlogits(h_last, _head_t(params, cfg), quant_cfg=quant,
                        folds=2 * pos + 1)
    cache["pos"] = pos + 1
    return logits, cache


@torch.no_grad()
def decode_slots(params, cache, tokens, active, cfg: ModelConfig,
                 quant: QuantConfig, kv_fmt: str = "none"):
    """One decode tick across all slots at per-slot positions.

    ``tokens``: (K,) device ints, the last token of each slot; ``active``:
    (K,) host bools, the slots that advance.  Inactive rows still flow
    through the batched GEMMs; their cache writes land at a stale position
    that is masked or overwritten by the next admission.  A slot at
    position p computes what ``decode_step`` computes for a row at
    ``pos == p``, and its quantized logits draw from stream ``2p + 1``, so
    its tokens match the oneshot driver's.
    """
    pos = cache["pos"]                                  # (K,) host int32
    pos_dev = pos.to(tokens.device, non_blocking=True)
    h_last = _decode_trunk(params, cache, tokens, pos_dev, cfg, quant=quant,
                           kv_fmt=kv_fmt)
    logits = cm.qlogits(h_last, _head_t(params, cfg), quant_cfg=quant,
                        folds=[2 * p + 1 for p in pos.tolist()])
    cache["pos"] = pos + torch.as_tensor(active, dtype=torch.int32)
    return logits, cache


# --------------------------------------------------------------------------- #
# registry glue
# --------------------------------------------------------------------------- #
@register_family("dense_lm")
def build_dense_lm(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=functools.partial(prepare, cfg=cfg),
        prefill=functools.partial(prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(decode_step, cfg=cfg, quant=quant),
        decode_slots=functools.partial(decode_slots, cfg=cfg, quant=quant),
        slot_cache_spec=functools.partial(slot_cache_spec, cfg),
        kv_formats=("none", "int8", "luq_fp4"),
    )
