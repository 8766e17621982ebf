"""BERT-style encoder for sequence classification (the paper's SNLI
experiment, trained with DP-AdamW).

The counterpart of ``repro.models.bert``: a pre-norm encoder with learned
position embeddings and a classification head on the [CLS] row (position
0), ``cls_w`` (d, classes) and ``cls_b`` (classes,), float32.  Params
are a flat dict with the JAX package's leaf names: ``embed`` (V, d),
``pos_embed`` (max_position, d), ``final_norm`` (d,), the head, and the
dense transformer's layer stacks ``blocks.<leaf>``
(``transformer.init_block_stack``).

Kept as the reference has them (properties, not faults):

* the norms are RMSNorm in the ``1 + scale`` form, not LayerNorm;
* the MLP is ``gelu(h @ wi_gate) @ wo_mlp`` with the tanh approximation
  (``jax.nn.gelu``'s default);
* the block stack holds a ``wi_up`` that no block reads: its
  per-example gradients are zero, and DP noise is still added to it.

Every projection runs through ``common.qproj`` -> ``fake_quant.qeinsum``
under the layer's DPQuant flag with the seeds ``97 * layer + j`` (q, k,
v, o, MLP in, MLP out: j = 0..5).  ``trainable_last_only`` freezes every
layer but the last, as the paper does (the Opacus recipe): the frozen
layers' stacked leaves are detached, the reference's ``stop_gradient``, so
their per-example gradients are exactly zero.  No CLI flag sets it, as in
the JAX package.  ``ModelConfig.remat`` recomputes each block in the
backward, as in the dense transformer.
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

# the block stack's leaves; ``wi_up`` is created but never read
BLOCK_LEAVES = tfm.BLOCK_LEAVES


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    return {
        "embed": cm.embed_init((cfg.padded_vocab, d), generator=gen,
                               device=device, dtype=pdt),
        "pos_embed": cm.embed_init((cfg.max_position, d), generator=gen,
                                   device=device, dtype=pdt),
        **tfm.init_block_stack(gen, cfg, device),
        "final_norm": torch.zeros((d,), dtype=pdt, device=device),
        "cls_w": cm.dense_init((d, cfg.num_classes), d, generator=gen,
                               device=device, dtype=torch.float32),
        "cls_b": torch.zeros((cfg.num_classes,), dtype=torch.float32,
                             device=device),
    }


def bert_block(x, blk, *, flag, seed: int, cfg: ModelConfig,
               quant: QuantConfig):
    """Bidirectional attention and a GeLU MLP, each pre-norm."""
    cd = x.dtype
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    h = cm.rmsnorm(x, blk["attn_norm"]).to(cd)
    q = qp("bsd,dhk->bshk", h, blk["wq"].to(cd), seed=seed)
    k = qp("bsd,dhk->bshk", h, blk["wk"].to(cd), seed=seed + 1)
    v = qp("bsd,dhk->bshk", h, blk["wv"].to(cd), seed=seed + 2)
    out = cm.chunked_causal_attention(
        q, k, v, chunk_q=cfg.attn_chunk_q, causal=False,
        scale=1.0 / math.sqrt(cfg.head_dim))
    x = x + qp("bshk,hkd->bsd", out, blk["wo"].to(cd), seed=seed + 3)
    h2 = cm.rmsnorm(x, blk["mlp_norm"]).to(cd)
    a = F.gelu(qp("bsd,df->bsf", h2, blk["wi_gate"].to(cd), seed=seed + 4),
               approximate="tanh")
    return x + qp("bsf,fd->bsd", a, blk["wo_mlp"].to(cd), seed=seed + 5)


def forward(params, tokens, qflags, cfg: ModelConfig, quant: QuantConfig,
            trainable_last_only: bool = False):
    """Final-norm hidden states (B, S, d) of ``tokens`` (B, S)."""
    cd = torch_dtype(cfg.compute_dtype)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cd)
    x = x + params["pos_embed"][:S][None].to(cd)
    stacks = {leaf: params[f"blocks.{leaf}"] for leaf in BLOCK_LEAVES}
    if trainable_last_only:
        # freeze all but the last encoder layer (paper A.4.2)
        stacks = {leaf: torch.cat([t[:-1].detach(), t[-1:]])
                  for leaf, t in stacks.items()}
    # one unbind per stacked leaf (see transformer.forward_hidden)
    stacks = {leaf: t.unbind(0) for leaf, t in stacks.items()}
    remat = tfm._remat(cfg)
    for i in range(cfg.n_layers):
        blk = {leaf: stacks[leaf][i] for leaf in BLOCK_LEAVES}
        block = functools.partial(bert_block, flag=qflags[i], seed=97 * i,
                                  cfg=cfg, quant=quant)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block, x, blk, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, blk)
    return cm.rmsnorm(x, params["final_norm"])


def classify(params, tokens, qflags, cfg: ModelConfig, quant: QuantConfig,
             trainable_last_only: bool = False):
    """(B, classes) float32 logits of the [CLS] row."""
    h = forward(params, tokens, qflags, cfg, quant, trainable_last_only)
    return h[:, 0].float() @ params["cls_w"] + params["cls_b"]


def loss_fn(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig,
            trainable_last_only: bool = False):
    """Mean cross-entropy of ``batch`` = {"tokens", "label"}.  The JAX
    package's ``loss_fn`` also takes an rng, which it deletes; the port
    leaves it out."""
    logits = classify(params, batch["tokens"], qflags, cfg, quant,
                      trainable_last_only)
    return cm.softmax_xent(logits, batch["label"])


@register_family("bert")
def build_bert(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=lambda params: params,
        forward=functools.partial(classify, cfg=cfg, quant=quant),
        loss_fn=functools.partial(loss_fn, cfg=cfg, quant=quant),
    )
