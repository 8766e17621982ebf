"""Mixture-of-Experts LM (the kimi-k2 / arctic family): training and
oneshot serving.

The counterpart of ``repro.models.moe``.  Transformer blocks with the
dense family's GQA attention (``transformer.attention_block``) and a
top-k routed expert MLP; arctic adds a dense residual MLP beside it.
Params are a flat dict with the JAX package's leaf names and layouts:
``embed`` (V, d, tied with the logits), ``final_norm``, and the layer
stacks ``blocks.<leaf>``: the attention leaves, ``router`` (L, d, E)
float32, ``e_gate`` / ``e_up`` (L, E, d, f), ``e_down`` (L, E, f, d), and
arctic's ``r_gate`` / ``r_up`` (L, d, fr), ``r_down`` (L, fr, d).

Routing (:func:`_route`): float32 router logits of the float32 hidden
state, softmax, ``torch.topk`` (descending, as ``jax.lax.top_k``), the
top-k probabilities renormalised by ``max(sum, 1e-9)``; the router's
gradient flows through those gates alone.

Two dispatches, both per example as the reference's ``vmap`` over the
batch makes them, here with the batch as a leading axis:

* ``dense``: every expert computes every token, combined with the
  sparse gates;
* ``capacity``: each example's (token, slot) pairs take positions in
  their experts' queues by an exclusive cumsum over the (S k, E) counts,
  token-major then slot (:func:`_positions`); a pair at position >= C
  (:func:`_capacity`, C = max(1, min(S, ceil(S k factor / E))) over one
  sequence's S tokens) goes to slot C, which is dropped.  The dispatch is
  an out-of-place ``index_add`` into (B, E (C + 1), d), the combine an
  ``index_select`` back, both on the flattened (example, expert, slot)
  index, so every shape is static (nothing is read to the host: the step
  is captured in a CUDA graph) and each kept slot receives exactly one
  token.  The expert GEMMs are (B, E, C, d) x (E, d, f).

DPQuant: the ten projections of a block run through ``common.qproj``
under the layer's flag, with the reference's seeds: ``97 layer`` +0..3
(q, k, v, o), +10..12 (the experts' gate, up, down), +20..22 (the dense
residual's).  Each expert weight is quantized whole; the expert GEMMs'
activations and cotangents one row per example (``per_example=True``),
the grain the reference's quantizer sees inside its ``vmap``; attention
and the residual MLP quantize their batched operands whole, as the
reference's do outside it.  The embedding is not scaled by
sqrt(d_model).  Each block is recomputed in the backward under the
dense family's remat rule (``transformer._remat``).

Expert parallelism (a mesh whose ``model`` axis has degree > 1,
``repro_torch.parallel.axes``): each rank holds E / m experts (its
slices of ``e_gate``, ``e_up``, ``e_down``), the attention as the dense
family splits it, and arctic's dense residual MLP tensor parallel.  The
router and the dispatch (``_route``, ``_positions``) run replicated in
float32, so every rank computes the same slots, capacity and dropped
pairs as one process; a rank runs only its experts' slots, behind
``copy_to_model``, the gates reach the combine through it too (each
rank's cotangent covers its experts), and the experts' partial outputs,
and the residual's, are summed by ``reduce_from_model`` (in float32,
rounded to the compute dtype once, ``common.row_parallel``).

Serving runs every projection unquantized (the reference's flags are 0
there) and keeps an unquantized KV cache; the logits are the float32
product of the last hidden row with the float32 embedding, not the
quantized head.  ``prepare`` keeps a float32 copy of the embedding,
``head_f32``, for them (4.7 GB for kimi-k2's vocabulary), so a decode
step reads it once instead of casting the bf16 table anew.  Decode runs
each row's token alone through the capacity dispatch (C = 1, nothing
dropped), as the reference's per-row ``vmap`` does, so decode differs
from a prefill of the extended prompt wherever that prefill drops.
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
from repro_torch.parallel import axes as pax
from repro_torch.parallel.collectives import copy_to_model

ATTN_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
EXPERT_LEAVES = ("router", "e_gate", "e_up", "e_down")
RESIDUAL_LEAVES = ("r_gate", "r_up", "r_down")
# the router stays float32 (tiny and numerically sensitive)
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "e_gate", "e_up", "e_down",
                  "r_gate", "r_up", "r_down")


def block_leaves(cfg: ModelConfig) -> tuple:
    return (ATTN_LEAVES + EXPERT_LEAVES
            + (RESIDUAL_LEAVES if cfg.dense_ff_residual else ()))


def param_axes(cfg: ModelConfig) -> dict:
    """``{name: logical axes}`` of every parameter: the reference's
    ``moe_block_axes`` under the port's flat names."""
    axes = {k: v for k, v in tfm.BLOCK_AXES.items() if k in ATTN_LEAVES}
    axes["router"] = ("layers", "embed", None)
    axes["e_gate"] = ("layers", "experts", "embed", "expert_mlp")
    axes["e_up"] = ("layers", "experts", "embed", "expert_mlp")
    axes["e_down"] = ("layers", "experts", "expert_mlp", "embed")
    if cfg.dense_ff_residual:
        axes["r_gate"] = ("layers", "embed", "mlp")
        axes["r_up"] = ("layers", "embed", "mlp")
        axes["r_down"] = ("layers", "mlp", "embed")
    return {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            **{f"blocks.{k}": v for k, v in axes.items()}}


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    L, d, E, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    params = {
        "embed": cm.embed_init((cfg.padded_vocab, d), generator=gen,
                               device=device, dtype=pdt),
        "final_norm": torch.zeros((d,), dtype=pdt, device=device),
    }
    # the attention leaves of the dense stack, its MLP dropped (d_ff 0)
    blocks = tfm.init_block_stack(gen, cfg, device)
    params.update({k: v for k, v in blocks.items()
                   if k.split(".")[-1] in ATTN_LEAVES})
    init = functools.partial(cm.dense_init, generator=gen, device=device,
                             dtype=pdt)
    params["blocks.router"] = cm.dense_init((L, d, E), d, generator=gen,
                                            device=device)
    params["blocks.e_gate"] = init((L, E, d, f), d)
    params["blocks.e_up"] = init((L, E, d, f), d)
    params["blocks.e_down"] = init((L, E, f, d), f)
    if cfg.dense_ff_residual:
        fr = cfg.dense_ff_residual
        params["blocks.r_gate"] = init((L, d, fr), d)
        params["blocks.r_up"] = init((L, d, fr), d)
        params["blocks.r_down"] = init((L, fr, d), fr)
    return params


def prepare(params: dict, cfg: ModelConfig) -> dict:
    """For serving: the projections cast to the compute dtype once (the
    reference casts them on every call; the cast is deterministic), the
    router left float32, and ``head_f32``, the float32 embedding the
    logits read (the embedding itself when it is float32)."""
    cd = torch_dtype(cfg.compute_dtype)
    out = {name: (t.to(cd) if name.split(".")[-1] in _MATMUL_LEAVES else t)
           for name, t in params.items()}
    out["head_f32"] = params["embed"].float()
    return out


# --------------------------------------------------------------------------- #
# routing and dispatch
# --------------------------------------------------------------------------- #
def _route(h, router_w, cfg: ModelConfig):
    """Router probabilities and top-k of ``h`` (..., d): ids (..., k) int64
    and their renormalised float32 gates (..., k)."""
    logits = torch.einsum("...d,de->...e", h.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_ids, top_p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert of one sequence of ``n_tokens`` tokens."""
    factor = cfg.moe_capacity_factor
    return max(1, min(n_tokens,
                      int(math.ceil(n_tokens * cfg.top_k * factor
                                    / cfg.n_experts))))


def _positions(ids, n_experts: int, capacity: int):
    """Each (token, slot) pair's position in its expert's queue, per
    example: ``ids`` (B, S, k) -> (positions (B, S, k), overflow (B, S, k)),
    the exclusive cumsum of the (S k, E) assignment counts, token-major
    then slot; a pair at ``capacity`` or beyond overflows."""
    B, S, k = ids.shape
    arange = torch.arange(n_experts, device=ids.device)
    counts = (ids[..., None] == arange).long().reshape(B, S * k, n_experts)
    pos_flat = torch.cumsum(counts, dim=1) - counts
    pos = torch.gather(pos_flat.reshape(B, S, k, n_experts), -1,
                       ids[..., None])[..., 0]
    return pos, pos >= capacity


def _dispatch_index(ids, pos, overflow, n_experts: int, capacity: int):
    """The (B S k,) index of each pair's slot in the flattened (B, E, C +
    1) buffer, overflowing pairs at slot C."""
    B = ids.shape[0]
    slot = torch.where(overflow, capacity, pos)
    base = torch.arange(B, device=ids.device)[:, None, None] * (
        n_experts * (capacity + 1))
    return (base + ids * (capacity + 1) + slot).reshape(-1)


def moe_ffn_capacity(h, blk, flag, seed: int, cfg: ModelConfig,
                     quant: Optional[QuantConfig]):
    """Capacity-based scatter/gather MoE of each example of ``h`` (B, S, d).
    ``quant`` None: plain einsums (serving).  With this rank's shard of
    the experts, its experts' part of the output (module docstring)."""
    B, S, d = h.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    ids, gates = _route(h, blk["router"], cfg)              # (B, S, k)
    pos, overflow = _positions(ids, E, C)
    index = _dispatch_index(ids, pos, overflow, E, C)
    n_loc = blk["e_gate"].shape[0]
    split = cm.tp_split(n_loc, E, 1, 0, 1)
    e0 = 0 if split is None else split[0][1]
    if split is not None:
        h = copy_to_model(h)
    xk = h[:, :, None, :].expand(B, S, k, d).reshape(B * S * k, d)
    buf = h.new_zeros((B * E * (C + 1), d)).index_add(0, index, xk)
    xe = buf.reshape(B, E, C + 1, d)[:, e0:e0 + n_loc, :C]  # (B, E, C, d)
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag,
                           per_example=True, split=split)
    cd = h.dtype
    g = qp("becd,edf->becf", xe, blk["e_gate"].to(cd), seed=seed + 10)
    u = qp("becd,edf->becf", xe, blk["e_up"].to(cd), seed=seed + 11)
    ye = qp("becf,efd->becd", F.silu(g) * u, blk["e_down"].to(cd),
            seed=seed + 12)
    # (B, E, C + 1, d): the other ranks' experts and the dropped slot zero
    ye_pad = F.pad(ye, (0, 0, 0, 1, e0, E - e0 - n_loc))
    yk = ye_pad.reshape(B * E * (C + 1), d).index_select(0, index)
    w = torch.where(overflow, 0.0, gates)
    if split is None:
        return torch.einsum("bskd,bsk->bsd", yk.reshape(B, S, k, d),
                            w.to(ye.dtype))
    # this rank's experts' part in float32, rounded once after the sum
    return torch.einsum("bskd,bsk->bsd", yk.reshape(B, S, k, d).float(),
                        copy_to_model(w))


def moe_ffn_dense(h, blk, flag, seed: int, cfg: ModelConfig,
                  quant: Optional[QuantConfig]):
    """Every expert on every token of ``h`` (B, S, d), combined with the
    sparse gates; with this rank's shard of the experts, their part."""
    ids, gates = _route(h, blk["router"], cfg)              # (B, S, k)
    n_loc = blk["e_gate"].shape[0]
    split = cm.tp_split(n_loc, cfg.n_experts, None, 0, 1)
    e0 = 0 if split is None else split[1][1]
    if split is not None:
        h, gates = copy_to_model(h), copy_to_model(gates)
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag,
                           per_example=True)
    cd = h.dtype
    g = qp("bsd,edf->besf", h, blk["e_gate"].to(cd), seed=seed + 10,
           split=split)
    u = qp("bsd,edf->besf", h, blk["e_up"].to(cd), seed=seed + 11,
           split=split)
    y = qp("besf,efd->besd", F.silu(g) * u, blk["e_down"].to(cd),
           seed=seed + 12,
           split=None if split is None else (split[2], split[1], split[2]))
    arange = torch.arange(e0, e0 + n_loc, device=h.device)
    comb = ((ids[..., None] == arange).float() * gates[..., None]).sum(-2)
    if split is not None:
        return torch.einsum("besd,bse->bsd", y.float(), comb)
    return torch.einsum("besd,bse->bsd", y, comb.to(y.dtype))


def _ffn(cfg: ModelConfig):
    return moe_ffn_capacity if cfg.moe_impl == "capacity" else moe_ffn_dense


def _mlp(h, blk, flag, seed: int, cfg: ModelConfig,
         quant: Optional[QuantConfig]):
    """The routed experts and, for arctic, the dense residual MLP of the
    normed hidden state ``h`` (B, S, d).  The ranks' parts of each
    sharded one are summed by its own ``reduce_from_model``: the experts'
    sum is then the one-process combine's bits (a token's k terms, each
    on one rank, added once), which one reduction of both parts would
    not keep."""
    y = _ffn(cfg)(h, blk, flag, seed, cfg, quant)
    if blk["e_gate"].shape[0] < cfg.n_experts:
        y = cm.reduce_partial(y, h.dtype)
    if cfg.dense_ff_residual:
        col = cm.tp_split(blk["r_gate"].shape[1], cfg.dense_ff_residual,
                          None, 1, 2)
        row = None if col is None else (col[2], (0,) + col[2][1:], None)
        qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
        cd = h.dtype
        hr = h if col is None else copy_to_model(h)
        g = qp("bsd,df->bsf", hr, blk["r_gate"].to(cd), seed=seed + 20,
               split=col)
        u = qp("bsd,df->bsf", hr, blk["r_up"].to(cd), seed=seed + 21,
               split=col)
        r = qp("bsf,fd->bsd", *cm.row_parallel(F.silu(g) * u, blk["r_down"],
                                               cd, row),
               seed=seed + 22, split=row)
        y = y + (r if row is None else cm.reduce_partial(r, cd))
    return y


def moe_block(x, blk, *, flag, seed: int, positions, cfg: ModelConfig,
              quant: Optional[QuantConfig]):
    """One block: ``x`` plus attention, plus the MoE MLP; returns ``(x,
    (k, v))``."""
    attn_out, kv = tfm.attention_block(x, blk, positions, cfg, quant, flag,
                                       seed)
    x = x + attn_out
    h = cm.rmsnorm(x, blk["mlp_norm"]).to(x.dtype)
    return x + _mlp(h, blk, flag, seed, cfg, quant), kv


def _train_block(x, blk, **kw):
    return moe_block(x, blk, **kw)[0]


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def _embed(params, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype (unscaled, unlike dense_lm);
    a vocab-parallel lookup of a sharded embedding."""
    return tfm.vocab_lookup(params["embed"], tokens, cfg).to(
        torch_dtype(cfg.compute_dtype))


def forward_hidden(params, tokens, qflags, cfg: ModelConfig,
                   quant: QuantConfig):
    """Final-norm hidden states (B, S, d) of a training forward.
    ``qflags``: one host bool per layer, or the trainer's flags tensor."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    leaves = block_leaves(cfg)
    # one unbind per stacked leaf (see transformer.forward_hidden)
    stacks = {leaf: params[f"blocks.{leaf}"].unbind(0) for leaf in leaves}
    remat = tfm._remat(cfg)
    for i in range(cfg.n_layers):
        blk = {leaf: stacks[leaf][i] for leaf in leaves}
        block = functools.partial(_train_block, flag=qflags[i], seed=97 * i,
                                  positions=positions, cfg=cfg, quant=quant)
        if remat:
            # exact recomputation: the quantizers' draws are keyed by their
            # static (seed, fold) (see transformer.forward_hidden)
            x = torch.utils.checkpoint.checkpoint(
                block, x, blk, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, blk)
    return cm.rmsnorm(x, params["final_norm"])


def lm_loss(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig,
            per_example: bool = False):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S) with the tied
    head: the mean, or (B,) per example.  The JAX package's ``lm_loss``
    also takes an rng, which it deletes; the port leaves it out."""
    tokens = batch["tokens"]
    h = forward_hidden(params, tokens, qflags, cfg, quant)
    return cm.chunked_lm_loss(
        h[:, :-1], tokens[:, 1:], params["embed"], real_vocab=cfg.vocab_size,
        ce_chunk=cfg.ce_chunk, per_example=per_example,
        vocab_split=pax.split_of(params["embed"].shape[0], cfg.padded_vocab))


# --------------------------------------------------------------------------- #
# serving: prefill + lockstep decode with an unquantized KV cache
# --------------------------------------------------------------------------- #
def _layer(params: dict, cfg: ModelConfig, i: int) -> dict:
    return {leaf: params[f"blocks.{leaf}"][i] for leaf in block_leaves(cfg)}


def _logits(params, x_last, cfg: ModelConfig):
    """float32 logits of the final-norm last rows, against ``head_f32``
    (``prepare``'s), or the embedding cast here; a vocab shard's gathered
    (``common.qlogits`` at fmt none)."""
    head = params.get("head_f32")
    if head is None:
        head = params["embed"].float()
    h = cm.rmsnorm(x_last, params["final_norm"]).float()
    return cm.qlogits(h, head.T, quant_cfg=None, folds=0,
                      vocab=cfg.padded_vocab)


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, quant: QuantConfig,
            cache_len: Optional[int] = None):
    """Run the prompt; return the last token's float32 logits (B, V_pad)
    and the cache: ``k`` / ``v`` (L, B, KV, cache_len, hd) in the compute
    dtype, zero past the prompt, and ``pos`` (a host int)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = moe_block(x, _layer(params, cfg, i), flag=False,
                              seed=97 * i, positions=positions, cfg=cfg,
                              quant=None)
        ks.append(k.transpose(1, 2))           # (B, KV, S, hd)
        vs.append(v.transpose(1, 2))
    cache = tfm.prefill_cache(torch.stack(ks), torch.stack(vs), S, cache_len,
                              "none", None)
    return _logits(params, x[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, cache, token, cfg: ModelConfig, quant: QuantConfig):
    """Append one token (B,) to every row at ``cache["pos"]``; writes the
    cache in place and returns ``(logits, cache)``."""
    pos = int(cache["pos"])
    B = token.shape[0]
    x = _embed(params, token, cfg)
    pos_dev = torch.full((B,), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params, cfg, i)
        # the dense family's one-token attention, its KV write and, on a
        # model group, its split (transformer.decode_attention)
        x = x + tfm.decode_attention(x, blk, tfm.layer_cache(cache, i),
                                     pos_dev, cfg)
        h2 = cm.rmsnorm(x, blk["mlp_norm"]).to(x.dtype)
        # each row's token alone through the dispatch (S = 1)
        x = x + _mlp(h2[:, None], blk, False, 97 * i, cfg, None)[:, 0]
    cache["pos"] = pos + 1
    return _logits(params, x, cfg), cache


# --------------------------------------------------------------------------- #
# registry glue
# --------------------------------------------------------------------------- #
@register_family("moe_lm")
def build_moe_lm(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=functools.partial(prepare, cfg=cfg),
        loss_fn=functools.partial(lm_loss, cfg=cfg, quant=quant),
        prefill=functools.partial(prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(decode_step, cfg=cfg, quant=quant),
        kv_formats=("none",),
        param_axes=functools.partial(param_axes, cfg),
        cache_axes=functools.partial(tfm.kv_cache_axes, cfg),
    )
