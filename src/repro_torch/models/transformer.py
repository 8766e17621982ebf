"""Dense decoder-only GQA transformer (gemma / yi / stablelm families):
training and serving.

The counterpart of ``repro.models.transformer``.  Params
are a flat dict with the JAX package's leaf names and layouts: ``embed``
(V, d), ``final_norm`` (d,), ``lm_head`` (d, V) when untied, and the layer
stacks ``blocks.<leaf>`` with a leading layer axis (``blocks.wq`` is
(L, d, H, hd), ``blocks.wo`` (L, H, hd, d), ...).  Layers run as a Python
loop.

Training (``lm_loss``) runs every block projection through
``common.qproj`` -> ``fake_quant.qeinsum``, gated by the layer's DPQuant
flag (an entry of the trainer's flags tensor, read on the device; or a
host bool) with the JAX package's seeds ``97 * layer + j`` (q, k, v, o,
gate, up, down: j = 0..6).  With ``ModelConfig.remat`` (the default, as
in the reference) each block is recomputed in the backward
(``torch.utils.checkpoint``) instead of keeping its activations.  The float32 weights are cast to
the compute dtype on every call, so gradients reach the float32 leaves.
``ghost_mask`` and ``make_ghost_aux`` are the ghost engine's hooks
(``repro_torch.dp.ghost``): every leaf is covered, none falls back.

Tensor parallelism (a mesh whose ``model`` axis has degree > 1; the
rank's model group in ``repro_torch.parallel.axes``): each rank holds
the shards ``param_axes`` and the partitioner's rules give it.  q, k, v,
gate and up are column-parallel over the local heads or ``mlp`` slice,
behind ``copy_to_model``; ``wo`` and ``wo_mlp`` are row-parallel, their
partial outputs summed by ``reduce_from_model`` (in float32, rounded to
the compute dtype once, ``common.row_parallel``).  Where the KV heads do
not divide over the group the KV projections stay replicated (the rule's
divisibility fallback): they run whole on every rank, their outputs'
cotangents summed over the group, and the local query heads read the KV
heads they map to.  The embedding is a vocab-parallel lookup and the
loss vocab parallel (``common.chunked_lm_loss``).  Every split operand
of a projection quantizes as the slice of the whole operand's
quantization (``quant.fake_quant``), so the sharded step computes what
the one-process step computes.  Without a model group the code is the
unsharded code.

Serving runs every projection unquantized (the JAX package's policy flag
is 0 there); only the logits head goes through the quantizer dispatch
(``common.qlogits``), and a quantized KV cache through the ``kv_write`` /
``decode_attn`` ops.  On a model group serving takes training's layout:
the projections column- and row-parallel, the logits head split over the
vocab and gathered, and the KV cache split by heads, or by sequence rows
where the rules fall back to ``kv_seq`` (``kv_cache_axes``,
``axes.kv_split``; ``decode_attention``).

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
import torch.utils.checkpoint

from repro_torch.config import (ModelConfig, QuantConfig, generator,
                                torch_dtype)
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.registry import Model, register_family
from repro_torch.parallel import axes as pax
from repro_torch.parallel.collectives import copy_to_model, reduce_from_model

BLOCK_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wi_gate",
                "wi_up", "wo_mlp")
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_mlp")


# The reference's logical axes of the block stack (BLOCK_AXES) and of the
# whole tree (param_axes), under the port's flat, layer-stacked names.
BLOCK_AXES = {
    "attn_norm": ("layers", "embed"),
    "wq": ("layers", "embed", "heads", "head_dim"),
    "wk": ("layers", "embed", "kv_heads", "head_dim"),
    "wv": ("layers", "embed", "kv_heads", "head_dim"),
    "wo": ("layers", "heads", "head_dim", "embed"),
    "mlp_norm": ("layers", "embed"),
    "wi_gate": ("layers", "embed", "mlp"),
    "wi_up": ("layers", "embed", "mlp"),
    "wo_mlp": ("layers", "mlp", "embed"),
}


def param_axes(cfg: ModelConfig) -> dict:
    """``{name: logical axes}`` of every parameter."""
    axes = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            **{f"blocks.{k}": v for k, v in BLOCK_AXES.items()}}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_block_stack(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The ``blocks.<leaf>`` stacks of ``cfg.n_layers`` pre-norm blocks,
    drawn from ``gen`` (shapes and init scales of the JAX package's
    ``init_block_stack``)."""
    pdt = torch_dtype(cfg.param_dtype)
    d, hp, kv, hd, f, L = (cfg.d_model, cfg.padded_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.n_layers)
    init = functools.partial(cm.dense_init, generator=gen, device=device,
                             dtype=pdt)
    blocks = {
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
    blocks["blocks.wq"][:, :, cfg.n_heads:, :] = 0
    return blocks


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (same shapes and init scales as the
    JAX package, not the same numbers: torch draws its own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    params = {
        "embed": cm.embed_init((cfg.padded_vocab, d), generator=gen,
                               device=device, dtype=pdt),
        "final_norm": torch.zeros((d,), dtype=pdt, device=device),
        **init_block_stack(gen, cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init((d, cfg.padded_vocab), d,
                                          generator=gen, device=device,
                                          dtype=pdt)
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


def _embed_scale(cfg: ModelConfig) -> float:
    """The gemma-style embedding scale of the ``dense_lm`` family,
    ``sqrt(d_model)`` rounded to the compute dtype, as a host float (a
    captured step copies nothing from the host); 1 for another family
    (the VLM backbone), as in the JAX package."""
    if cfg.family != "dense_lm":
        return 1.0
    return float(torch.tensor(math.sqrt(cfg.d_model),
                              dtype=torch_dtype(cfg.compute_dtype)))


def vocab_lookup(embed, tokens, cfg: ModelConfig):
    """``embed[tokens]``; for a vocab-sharded ``embed`` each rank looks up
    the ids of its rows (zeros for the others') and the group sums the
    rows, exactly (in float32, returned in ``embed``'s dtype)."""
    split = pax.split_of(embed.shape[0], cfg.padded_vocab)
    if split is None:
        return embed[tokens]
    n = embed.shape[0]
    local = tokens.long() - split[0]
    inside = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)].float() * inside[..., None]
    return reduce_from_model(rows).to(embed.dtype)


def _embed(params, tokens, cfg: ModelConfig):
    """The token embeddings in the compute dtype, scaled for ``dense_lm``."""
    cd = torch_dtype(cfg.compute_dtype)
    return (vocab_lookup(params["embed"], tokens, cfg).to(cd)
            * _embed_scale(cfg))


def _splice(x, inputs_embeds):
    """``x`` with its first ``n`` positions replaced by ``inputs_embeds``
    (B, n, d) (the VLM's ``vision_embeds``, in ``x``'s dtype)."""
    n = inputs_embeds.shape[1]
    return torch.cat([inputs_embeds.to(x.dtype), x[:, n:]], dim=1)


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


def attention_block(x, blk, positions, cfg: ModelConfig, quant=None,
                    flag=False, seed: int = 0, hooks=None):
    """Pre-norm GQA attention with RoPE; returns the residual branch and
    the compact (pre-repeat) K, V.  With ``quant`` (training) the
    projections are ``qproj`` under the layer's ``flag`` and ``seed``;
    without it (serving), plain einsums.  ``hooks``: a ghost pass's
    ``GhostHooks``, handed to the projections and the norm."""
    cd = torch_dtype(cfg.compute_dtype)
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag, hooks=hooks)
    h = cm.rmsnorm(x, blk["attn_norm"], hooks=hooks).to(cd)
    # tensor parallel: this rank's query heads, and its KV heads or all
    hp, n_loc = cfg.padded_heads, blk["wq"].shape[1]
    col = cm.tp_split(n_loc, hp, None, 1, 2)
    kv_col = cm.tp_split(blk["wk"].shape[1], cfg.n_kv_heads, None, 1, 2)
    hc = h if col is None else copy_to_model(h)
    q = qp("bsd,dhk->bshk", hc, blk["wq"].to(cd), seed=seed, split=col)
    kv_in = h if kv_col is None else hc
    k = qp("bsd,dhk->bshk", kv_in, blk["wk"].to(cd), seed=seed + 1,
           split=kv_col)
    v = qp("bsd,dhk->bshk", kv_in, blk["wv"].to(cd), seed=seed + 2,
           split=kv_col)
    if col is not None and kv_col is None:
        # replicated KV read by some query heads on each rank: their
        # cotangents summed over the group
        k, v = copy_to_model(k), copy_to_model(v)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    n_rep = cfg.padded_heads // cfg.n_kv_heads
    kr, vr = cm.repeat_kv(k, n_rep), cm.repeat_kv(v, n_rep)
    if col is not None and kv_col is None:
        heads = slice(col[1][1], col[1][1] + n_loc)
        kr, vr = kr[:, :, heads], vr[:, :, heads]
    out = cm.chunked_causal_attention(
        q, kr, vr, chunk_q=cfg.attn_chunk_q,
        scale=1.0 / math.sqrt(cfg.head_dim))
    row = None if col is None else (col[2], (0,) + col[2][1:], None)
    res = qp("bshk,hkd->bsd", *cm.row_parallel(out, blk["wo"], cd, row),
             seed=seed + 3, split=row)
    if row is not None:
        res = cm.reduce_partial(res, cd)
    return res, (k, v)


def mlp_block(x, blk, cfg: ModelConfig, quant=None, flag=False,
              seed: int = 0, hooks=None):
    cd = torch_dtype(cfg.compute_dtype)
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag, hooks=hooks)
    h = cm.rmsnorm(x, blk["mlp_norm"], hooks=hooks).to(cd)
    col = cm.tp_split(blk["wi_gate"].shape[1], cfg.d_ff, None, 1, 2)
    if col is not None:
        h = copy_to_model(h)
    gate = qp("bsd,df->bsf", h, blk["wi_gate"].to(cd), seed=seed + 4,
              split=col)
    up = qp("bsd,df->bsf", h, blk["wi_up"].to(cd), seed=seed + 5, split=col)
    act = _activation(gate, up, cfg.mlp_activation)
    row = None if col is None else (col[2], (0,) + col[2][1:], None)
    out = qp("bsf,fd->bsd", *cm.row_parallel(act, blk["wo_mlp"], cd, row),
             seed=seed + 6, split=row)
    return out if row is None else cm.reduce_partial(out, cd)


# --------------------------------------------------------------------------- #
# training: loss and ghost hooks
# --------------------------------------------------------------------------- #
def forward_hidden(params, tokens, qflags, cfg: ModelConfig,
                   quant: QuantConfig, embed_tap=None, hooks=None,
                   inputs_embeds=None):
    """Final-norm hidden states (B, S, d) of a training forward.
    ``embed_tap``: the ghost pass-1 gather hook, a (B, S, d) zero tensor
    added after the embedding scaling (its gradient is the cotangent the
    embedding's scatter consumes).  ``hooks``: a ghost pass's
    ``repro_torch.dp.ghost.GhostHooks``, handed to every projection and
    norm.  ``inputs_embeds`` (B, n, d): the VLM's ``vision_embeds``, in
    place of the first ``n`` positions' embeddings."""
    x = _embed(params, tokens, cfg)
    if embed_tap is not None:
        x = x + embed_tap
    if inputs_embeds is not None:
        x = _splice(x, inputs_embeds)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where indexing layer by layer would add a zero-filled
    # copy of the whole stack into the leaf's gradient for every layer
    stacks = {leaf: params[f"blocks.{leaf}"].unbind(0) for leaf in BLOCK_LEAVES}
    remat = _remat(cfg)
    for i in range(cfg.n_layers):
        blk = {leaf: stacks[leaf][i] for leaf in BLOCK_LEAVES}
        block = functools.partial(_block, positions=positions, cfg=cfg,
                                  quant=quant, flag=qflags[i], seed=97 * i,
                                  hooks=hooks)
        if remat:
            # Recomputation is exact: a projection's quantizer draws are
            # keyed by its static (seed, fold), not by a generator, and the
            # model has no dropout, so the CUDA RNG state need not be
            # saved and restored (which would read it under capture).
            x = torch.utils.checkpoint.checkpoint(
                block, x, blk, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, blk)
    return cm.rmsnorm(x, params["final_norm"], hooks=hooks)


def _block(x, blk, *, positions, cfg: ModelConfig, quant: QuantConfig, flag,
           seed: int, hooks):
    """One pre-norm block: ``x`` plus attention, plus the MLP."""
    attn_out, _ = attention_block(x, blk, positions, cfg, quant, flag, seed,
                                  hooks)
    x = x + attn_out
    return x + mlp_block(x, blk, cfg, quant, flag, seed, hooks)


def _remat(cfg: ModelConfig) -> bool:
    """Whether ``forward_hidden`` checkpoints its blocks: ``cfg.remat`` in
    a training forward (gradients on), outside ``torch.func`` transforms
    (the vmap engine's per-example grads), which do not take the saved
    tensor hooks the checkpoint is built on."""
    return (cfg.remat and torch.is_grad_enabled()
            and torch._C._functorch.peek_interpreter_stack() is None)


def lm_loss(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig,
            loss_mask_prefix: int = 0, per_example: bool = False,
            ghost_taps=None, hooks=None):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S): the mean, or
    (B,) per example.  ``batch["vision_embeds"]``, when present, replaces
    the first positions' embeddings; ``loss_mask_prefix`` leaves the first
    that many predictions out of the loss (the VLM's vision prefix).
    ``ghost_taps`` ({"embed_out", "logits"}, the ``GhostAux`` taps) makes
    the return ``(loss, {"hidden": hc})``; ``hooks``: the ghost pass's
    ``GhostHooks``.  The JAX package's ``lm_loss`` also takes an rng,
    which it deletes; the port leaves it out."""
    tokens = batch["tokens"]
    taps = ghost_taps or {}
    h = forward_hidden(params, tokens, qflags, cfg, quant,
                       embed_tap=taps.get("embed_out"), hooks=hooks,
                       inputs_embeds=batch.get("vision_embeds"))
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    mask = None
    if loss_mask_prefix:
        b, s = tokens.shape
        keep = torch.arange(s - 1, device=tokens.device) >= loss_mask_prefix
        mask = keep.float()[None, :].expand(b, s - 1)
    out = cm.chunked_lm_loss(h[:, :-1], tokens[:, 1:], head,
                             real_vocab=cfg.vocab_size, ce_chunk=cfg.ce_chunk,
                             mask=mask, per_example=per_example,
                             logits_tap=taps.get("logits"),
                             vocab_split=pax.split_of(head.shape[0],
                                                      cfg.padded_vocab))
    if ghost_taps is not None:
        loss, hc = out
        return loss, {"hidden": hc}
    return out


# Every block projection runs through cm.qproj -> qeinsum and so carries a
# ghost norm hook; the norm scales are tapped by the rmsnorm hook and the
# embedding / LM head by the GhostAux below: no leaf falls back.
_GHOST_HOOKED_LEAVES = frozenset(_MATMUL_LEAVES)


def ghost_mask(params) -> dict:
    return {k: k.split(".")[-1] in _GHOST_HOOKED_LEAVES for k in params}


def make_ghost_aux(qflags, cfg: ModelConfig, quant: QuantConfig):
    """Dense-LM ``GhostAux``: the gather and LM-head hooks.

    Per example, the embedding's gradient is a gather-scatter term and
    (tied embeddings) a head term on the SAME leaf:

        d_gather = s A^T C      A = onehot(tokens) (T, V), C = gather-out
                                cotangent (T, d), s = the embedding scale
        d_head   = G^T H        G = logits cotangent (S-1, V_pad),
                                H = float32 hidden rows (S-1, d)

    so ``||d_gather + d_head||^2`` needs the token-equality-masked Gram of
    the lookup cotangents, the head's mixed ghost norm and the cross term
    ``2 <d_gather, d_head> = 2 sum_{s,t} G[s, tok_t] <sC_t, H_s>``.  Untied
    heads drop the cross term and split the two norms over embed /
    lm_head.

    ``s`` is the scale the forward multiplies by: ``sqrt(d_model)`` in the
    compute dtype.  The JAX package uses the unrounded ``sqrt(d_model)``
    here, which differs from its own forward's by the bf16 rounding
    (50.5 against 50.596 at d_model 2560) and equals it at float32.

    Vocab parallel (the embedding, and an untied head, sharded over the
    model group's vocab rows): the logits tap is the local logits', and
    each rank's combine counts the tokens whose rows it holds (the
    gather term and the cross term) and its logits columns (the head
    term), its part of the norm; the engine sums the parts.  A vocab
    that does not divide over the group leaves both replicated, and the
    group's first rank alone counts them.
    """
    from repro_torch.dp.ghost import GhostAux, _matpair_sq_norm

    cd = torch_dtype(cfg.compute_dtype)
    emb_scale = _embed_scale(cfg)

    def vocab_rows():
        """(offset, rows) of the vocab this rank holds."""
        axis, v = pax.model_axis(), cfg.padded_vocab
        if axis is None or v % axis.size:
            return 0, v
        return axis.index * (v // axis.size), v // axis.size

    def make_taps(batch):
        b, t = batch["tokens"].shape
        dev = batch["tokens"].device
        return {
            "embed_out": torch.zeros((b, t, cfg.d_model), dtype=cd,
                                     device=dev),
            "logits": torch.zeros((b, t - 1, vocab_rows()[1]),
                                  dtype=torch.float32, device=dev),
        }

    def tapped_loss(params, batch, taps, hooks):
        return lm_loss(params, batch, qflags, cfg, quant, per_example=True,
                       ghost_taps=taps, hooks=hooks)

    def combine(cots, fwd, batch):
        c = cots["embed_out"].float() * emb_scale            # (B, T, d)
        g = cots["logits"].float()                           # (B, S-1, Vp)
        h = fwd["hidden"].float()                            # (B, S-1, d)
        off, n = vocab_rows()
        tok = batch["tokens"].long() - off
        own = ((tok >= 0) & (tok < n)).float()          # rows held here
        eq = (tok[:, :, None] == tok[:, None, :]).float() * own[:, :, None]
        sq_gather = (eq * (c @ c.transpose(1, 2))).sum(dim=(1, 2))
        sq_head = _matpair_sq_norm(h, g)
        # replicated embedding and head on a model group: counted once
        once = float(n < cfg.padded_vocab or pax.model_index() == 0)
        if not cfg.tie_embeddings:
            return (sq_gather + sq_head) * once
        g_tok = torch.gather(g, 2, tok.clamp(0, n - 1)[:, None, :].expand(
            -1, g.shape[1], -1)) * own[:, None, :]
        cross = (g_tok * (h @ c.transpose(1, 2))).sum(dim=(1, 2))
        return (sq_gather + sq_head + 2.0 * cross) * once

    def covers(params):
        # embed and (untied) lm_head by the taps above; the *_norm scales
        # by the rmsnorm hook (hook_norm_scales)
        return {k: k.split(".")[-1] in ("embed", "lm_head")
                or k.endswith("norm") for k in params}

    return GhostAux(make_taps=make_taps, tapped_loss=tapped_loss,
                    combine=combine, covers=covers, hook_norm_scales=True)


# --------------------------------------------------------------------------- #
# serving: prefill + decode with KV cache
# --------------------------------------------------------------------------- #
def _kv_impls(kv_fmt: str, quant: Optional[QuantConfig]):
    """The dispatched (kv_write, decode_attn) impls for a cache format."""
    from repro_torch.quant import backend as qbackend

    be = quant.backend if quant is not None else None
    kvw, _ = qbackend.get_kv_write(kv_fmt, be)
    attn, _ = qbackend.get_decode_attn(kv_fmt, be)
    return kvw, attn


def kv_cache_axes(cfg: ModelConfig, kv_fmt: str = "none") -> dict:
    """``{name: logical axes}`` of a cache (the reference's
    ``kv_cache_axes``): what lays it out over a mesh."""
    del cfg
    axes = {"k": ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
            "v": ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
            "pos": None}
    if kv_fmt != "none":
        axes["k_scale"] = ("layers", "batch", "kv_heads", "kv_seq")
        axes["v_scale"] = ("layers", "batch", "kv_heads", "kv_seq")
    return axes


def _seq_rows(cache_len: int):
    """``(row0, rows)`` of this rank's shard of a cache of ``cache_len``
    rows split over its sequence (``axes.kv_split() == "kv_seq"``), or
    None when the rank holds every row."""
    if pax.kv_split() != pax.KV_SEQ:
        return None
    axis = pax.model_axis()
    if cache_len % axis.size:
        raise ValueError(f"a cache of {cache_len} rows does not split over "
                         f"{axis.size} ranks")
    rows = cache_len // axis.size
    return axis.index * rows, rows


def kv_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                  kv_fmt: str = "none"):
    """``{name: (shape, dtype)}`` of a cache; ``pos`` is host-side.  Under
    a model group, this rank's shard (``axes.kv_split``)."""
    from repro_torch.quant import kv_cache as kvc

    cd = torch_dtype(cfg.compute_dtype)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if pax.kv_split() == pax.KV_HEADS:
        kv //= pax.model_axis().size
    rows = _seq_rows(seq_len)
    if rows is not None:
        seq_len = rows[1]
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
    """Slot-pool cache: ``kv_cache_spec`` with a (n_slots,) ``pos``, kept
    on the device like the rest."""
    spec = kv_cache_spec(cfg, n_slots, max_seq, kv_fmt=kv_fmt)
    spec["pos"] = ((n_slots,), torch.int32)
    return spec


def prefill_cache(ks, vs, plen, cache_len: int, kv_fmt: str,
                  quant: Optional[QuantConfig]):
    """The cache a prefill leaves: the K and V rows ``ks`` / ``vs`` (L, B,
    KV, S, hd) of a prompt, in a cache of ``cache_len`` rows (zero past
    the prompt: zero codes and zero scales), quantized for a quantized
    ``kv_fmt``; ``pos`` is ``plen``.  On a sequence-split cache, this
    rank's rows of it (the ``kv_write`` op given the shard)."""
    from repro_torch.quant import kv_cache as kvc

    L, B, KV, S, hd = ks.shape
    rows = _seq_rows(cache_len)
    if rows is None and kv_fmt == "none":
        cache = {"k": ks, "v": vs, "pos": plen}
    else:
        kvw, _ = _kv_impls(kv_fmt, quant)
        code_dtype, code_dim = kvc.code_spec(kv_fmt, hd)
        n = S if rows is None else rows[1]
        alloc = torch.empty if rows is None else torch.zeros
        cache = {"pos": plen}
        for name in ("k", "v"):
            cache[name] = alloc((L, B, KV, n, code_dim),
                                dtype=code_dtype or ks.dtype,
                                device=ks.device)
            if kv_fmt != "none":
                cache[f"{name}_scale"] = alloc((L, B, KV, n),
                                               dtype=kvc.SCALE_DTYPE,
                                               device=ks.device)

        def flat(t):
            return None if t is None else t.reshape(L * B, KV, *t.shape[3:])

        # every layer's K and V rows in one write, in the compute dtype
        shard = () if rows is None else (rows[0], cache_len)
        kvw(flat(ks), flat(vs), flat(cache["k"]), flat(cache["v"]),
            flat(cache.get("k_scale")), flat(cache.get("v_scale")), None,
            *shard)
        if rows is not None:
            return cache
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
    return cache


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, quant: QuantConfig,
            cache_len: Optional[int] = None, kv_fmt: str = "none",
            prompt_len=None):
    """Run the full prompt; return (last-token logits, filled KV cache).
    ``batch["vision_embeds"]`` (the VLM's), when present, replaces the
    first positions' embeddings.

    ``prompt_len`` supports bucketed prefill: the token batch may be padded
    beyond the real prompt, and the last-token logits, the cache position
    and the logits stream are taken at ``prompt_len``.  Padding changes
    nothing for the real rows (attention is causal) and rows at index
    >= pos are masked until a decode tick overwrites them.

    ``prompt_len`` is an int or, for a batch of one, a 0-d integer tensor
    on the device: then nothing is read to the host (the engine captures
    one prefill a bucket as a CUDA graph and replays it for every length
    in the bucket).  The last real row is gathered on the device, the
    logits head's key is built there (one key for the one row: the bits
    of the int's shared key), and the cache's ``"pos"`` is that tensor.

    Tensor parallel (a model group): the blocks run as training's
    (``attention_block``, ``mlp_block``), the cache keeps this rank's KV
    heads or its rows (``axes.kv_split``, ``prefill_cache``), and the
    logits head is split over the vocab and gathered (``common.qlogits``):
    every rank returns the whole logits.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, tokens, cfg)
    if "vision_embeds" in batch:
        x = _splice(x, batch["vision_embeds"])
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        attn_out, (k, v) = attention_block(x, blk, positions, cfg)
        x = x + attn_out
        x = x + mlp_block(x, blk, cfg)
        ks.append(k.transpose(1, 2))           # (B, KV, S, hd)
        vs.append(v.transpose(1, 2))
    if isinstance(prompt_len, torch.Tensor):
        if B != 1:
            raise ValueError(f"a device prompt_len takes a batch of one, "
                             f"got {B} rows")
        plen = prompt_len.reshape(())
        last = (plen.long() - 1).reshape(1)
        x_last = x.index_select(1, last)[:, 0]
        folds = 2 * plen.reshape(1)
    else:
        plen = S if prompt_len is None else int(prompt_len)
        x_last = x[:, plen - 1]
        folds = 2 * plen
    h_last = cm.rmsnorm(x_last, params["final_norm"]).float()
    # even folds = prefill, odd folds = decode (pos == S after prefill, so a
    # bare fold of the position would reuse the first decode step's stream)
    with ops.prefill_launches():
        logits = cm.qlogits(h_last, _head_t(params, cfg), quant_cfg=quant,
                            folds=folds, vocab=cfg.padded_vocab)
    cache = prefill_cache(torch.stack(ks), torch.stack(vs), plen, cache_len,
                          kv_fmt, quant)
    return logits, cache


def decode_attention(x, blk, layer_cache, pos, cfg: ModelConfig,
                     quant: Optional[QuantConfig] = None,
                     kv_fmt: str = "none"):
    """One token's attention branch (B, d) in the compute dtype: each
    row's K/V written at its position (clamped into the cache, as the
    JAX package's dynamic_update_slice does) before attention reads it,
    each row attending to rows ``<= pos``.  ``layer_cache``: the layer's
    ``(k, v, k_scale, v_scale)`` views, written in place; ``pos`` (B,)
    int on the device.

    Tensor parallel: q, k and v column-parallel over this rank's heads
    and ``wo`` row-parallel (a float32 partial rounded once after the
    group's sum, ``common.row_parallel``).  On a cache split by heads the
    rank attends with its own heads; otherwise every rank needs every
    query head (gathered): on a sequence-split cache it writes the rows
    it holds, runs the attention's first pass over them, and the ranks'
    partials are gathered and merged (the ``decode_attn`` op's ``rows``),
    on a whole cache it attends whole; either way it keeps its own
    heads' context for ``wo``."""
    from repro_torch.parallel.collectives import gather_from_model

    cd = torch_dtype(cfg.compute_dtype)
    kvw, attend = _kv_impls(kv_fmt, quant)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    kc, vc, ksc, vsc = layer_cache
    positions = pos[:, None]
    h = cm.rmsnorm(x, blk["attn_norm"]).to(cd)
    q = torch.einsum("bd,dhk->bhk", h, blk["wq"].to(cd))
    k = torch.einsum("bd,dhk->bhk", h, blk["wk"].to(cd))
    v = torch.einsum("bd,dhk->bhk", h, blk["wv"].to(cd))
    q = cm.rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k = cm.rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    if kc.shape[1] != k.shape[1]:
        raise ValueError(f"the cache holds {kc.shape[1]} KV heads, this "
                         f"rank's wk {k.shape[1]}")
    n_loc = q.shape[1]
    # the whole cache's rows S, and this rank's (first row, S) when it
    # holds a sequence shard of them
    S, rows = kc.shape[2], None
    if pax.kv_split() == pax.KV_SEQ:
        S *= pax.model_axis().size
        rows = (pax.model_index() * kc.shape[2], S)
    # each slot's row at its position: one launch for K and V
    kvw(k[:, :, None], v[:, :, None], kc, vc, ksc, vsc,
        pos.clamp(max=S - 1).long(), *(rows or ()))
    if n_loc == cfg.padded_heads or k.shape[1] < cfg.n_kv_heads:
        # unsharded, or a rank's heads over its own KV heads
        ctx = attend(q, kc, vc, ksc, vsc, pos, n_kv=k.shape[1], scale=scale)
    else:
        q_all = gather_from_model(q, 1)
        shard = {} if rows is None else {"rows": rows,
                                         "gather": gather_from_model}
        ctx = attend(q_all, kc, vc, ksc, vsc, pos, n_kv=cfg.n_kv_heads,
                     scale=scale, **shard)
        h0 = pax.model_index() * n_loc
        ctx = ctx[:, h0:h0 + n_loc]
    if n_loc == cfg.padded_heads:
        return torch.einsum("bhk,hkd->bd", ctx.to(cd), blk["wo"].to(cd))
    return cm.reduce_partial(torch.einsum("bhk,hkd->bd", ctx.float(),
                                          blk["wo"].float()), cd)


def _decode_mlp(x, blk, cfg: ModelConfig):
    """One token's MLP branch (B, d): gate and up column-parallel over the
    rank's ``mlp`` slice, ``wo_mlp`` row-parallel (tensor parallel)."""
    cd = torch_dtype(cfg.compute_dtype)
    h2 = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
    gate = torch.einsum("bd,df->bf", h2, blk["wi_gate"].to(cd))
    up = torch.einsum("bd,df->bf", h2, blk["wi_up"].to(cd))
    act = _activation(gate, up, cfg.mlp_activation)
    if blk["wi_gate"].shape[1] == cfg.d_ff:
        return torch.einsum("bf,fd->bd", act, blk["wo_mlp"].to(cd))
    return cm.reduce_partial(torch.einsum("bf,fd->bd", act.float(),
                                          blk["wo_mlp"].float()), cd)


def layer_cache(cache, i: int):
    """Layer ``i``'s ``(k, v, k_scale, v_scale)`` views of a cache (the
    scales None for an unquantized one)."""
    scales = [cache[n][i] if n in cache else None
              for n in ("k_scale", "v_scale")]
    return (cache["k"][i], cache["v"][i], *scales)


def _decode_trunk(params, cache, token, pos, cfg: ModelConfig,
                  quant: Optional[QuantConfig] = None, kv_fmt: str = "none"):
    """Shared one-token trunk for lockstep and slot decode.

    ``pos`` is a (B,) int tensor on the device.  Each row's K/V is written
    at its own position before attention reads it, and each row attends
    to rows ``<= pos`` (``decode_attention``).  Writes the cache in place;
    returns the final-norm hidden states (B, d) float32.
    """
    x = _embed(params, token, cfg)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        x = x + decode_attention(x, blk, layer_cache(cache, i), pos, cfg,
                                 quant, kv_fmt)
        x = x + _decode_mlp(x, blk, cfg)
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
                        folds=2 * pos + 1, vocab=cfg.padded_vocab)
    cache["pos"] = pos + 1
    return logits, cache


@torch.no_grad()
def decode_slots(params, cache, tokens, active, cfg: ModelConfig,
                 quant: QuantConfig, kv_fmt: str = "none"):
    """One decode tick across all slots at per-slot positions.

    ``tokens``: (K,) ints on the device, the last token of each slot;
    ``cache["pos"]``: (K,) int32 on the device, each slot's position;
    ``active``: (K,) bools (a device tensor, or host bools), the slots that
    advance.  Inactive rows still flow through the batched GEMMs; their
    cache writes land at a stale position that is masked or overwritten by
    the next admission.  A slot at position p computes what
    ``decode_step`` computes for a row at ``pos == p``, and its quantized
    logits draw from stream ``2p + 1``, so its tokens match the oneshot
    driver's.  The cache, positions included (advanced by ``active``), is
    written in place, and nothing is read to the host, so the tick can be
    captured as a CUDA graph.
    """
    pos = cache["pos"]
    h_last = _decode_trunk(params, cache, tokens, pos, cfg, quant=quant,
                           kv_fmt=kv_fmt)
    logits = cm.qlogits(h_last, _head_t(params, cfg), quant_cfg=quant,
                        folds=2 * pos + 1, vocab=cfg.padded_vocab)
    pos.add_(torch.as_tensor(active, device=pos.device).to(pos.dtype))
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
        loss_fn=functools.partial(lm_loss, cfg=cfg, quant=quant),
        per_example_loss=functools.partial(lm_loss, cfg=cfg, quant=quant,
                                           per_example=True),
        ghost_mask=ghost_mask,
        ghost_aux=functools.partial(make_ghost_aux, cfg=cfg, quant=quant),
        prefill=functools.partial(prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(decode_step, cfg=cfg, quant=quant),
        decode_slots=functools.partial(decode_slots, cfg=cfg, quant=quant),
        slot_cache_spec=functools.partial(slot_cache_spec, cfg),
        kv_formats=("none", "int8", "luq_fp4"),
        param_axes=functools.partial(param_axes, cfg),
        cache_axes=functools.partial(kv_cache_axes, cfg),
    )
