"""Griffin / RecurrentGemma hybrid: RG-LRU recurrent blocks and local
attention, training and oneshot serving.

The counterpart of ``repro.models.griffin``.  The layer pattern is
(rec, rec, local-attn), repeated: layers are grouped into *superblocks*
of one pattern period, plus a recurrent tail when the depth is not a
multiple of the period (38 = 12 * 3 + 2 for the 9b config).  Every layer
is a mixer (RG-LRU or attention) and a GeGLU MLP, each pre-norm and
residual.

RG-LRU (Griffin, De et al. 2024):

    r_t = sigmoid(y_t W_a);  i_t = sigmoid(y_t W_x)
    log a_t = -c softplus(Lambda) r_t                 (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t y_t)

Training and prefill evaluate the linear recurrence ``h_t = a_t h_{t-1} +
b_t`` by recursive doubling (:func:`rglru_scan`, ceil(log2 S) elementwise
steps, what the reference's ``associative_scan`` computes in another
association order); decode is the O(1) update.  The local attention is
MQA (one KV head) with RoPE over a sliding window of ``attn_window``
positions; decode keeps a ring cache of ``min(attn_window, cache_len)``
rows, position ``p`` in slot ``p % win``.

Params are a flat dict with the JAX package's leaf names and layouts:
``embed`` (V, d, tied with the logits), ``final_norm``, the superblock
stacks ``superblocks.{rec1,rec2,attn}.<leaf>`` with a leading superblock
axis and the tail's ``tail.<leaf>`` with a leading tail-layer axis (dense
gate matrices ``gate_a`` / ``gate_x`` (W, W), as in the reference).

DPQuant: every projection runs through ``common.qproj`` under its layer's
flag, superblock ``s``'s layers taking ``qflags[3 s + j]`` and the tail's
layer ``t`` ``qflags[3 n_super + t]``, with the reference's seeds: a
superblock's rec1 at ``397 s`` (mixer + 0..4, MLP + 5..7), rec2 at ``397 s
+ 11``, attention at ``397 s + 23``; tail layer ``t`` at ``1_000_003 + 397
t``.  With ``ModelConfig.remat`` each superblock is recomputed in the
backward under the dense transformer's rule (``transformer._remat``); the
tail is not, as in the reference.

Dtypes follow the reference's promotions at bf16 compute with float32
params.  The conv multiplies its bf16 input by the float32 ``conv_w``
(float32 out), so both gate products take a float32 input against a bf16
weight and run in float32 (``fake_quant.einsum`` promotes as
``jnp.einsum`` does); decode casts ``conv_w`` to bf16 first and then adds
the float32 ``conv_b``.  So bf16 decode and prefill differ by
construction, as Mamba-2's do; they agree in float32.

The reference's prefill stores only ``min(attn_window, S)`` ring rows
(``S`` the prompt length) and its decode then wraps the ring at ``S``:
with a prompt shorter than the window its decode attends over the last
``S`` positions only.  This port sizes the ring by ``cache_len`` and
attends over the last ``attn_window`` positions, as the training forward
does.
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
from repro_torch.models.mamba2 import _causal_conv, _softplus
from repro_torch.models.registry import Model, register_family
from repro_torch.quant.fake_quant import einsum

C_RGLRU = 8.0
REC_LEAVES = ("norm", "w_x", "w_gate", "conv_w", "conv_b", "gate_a",
              "gate_x", "lam", "w_out")
ATTN_LEAVES = ("norm", "wq", "wk", "wv", "wo")
MLP_LEAVES = ("mlp_norm", "wi_gate", "wi_up", "wo_mlp")
GROUP_LEAVES = {"rec1": REC_LEAVES + MLP_LEAVES,
                "rec2": REC_LEAVES + MLP_LEAVES,
                "attn": ATTN_LEAVES + MLP_LEAVES}
_MATMUL_LEAVES = ("w_x", "w_gate", "gate_a", "gate_x", "w_out", "wq", "wk",
                  "wv", "wo", "wi_gate", "wi_up", "wo_mlp")
TAIL_SEED = 1_000_003
SEED_STRIDE = 397


def _layout(cfg: ModelConfig):
    """(period, superblocks, tail layers)."""
    period = len(cfg.block_pattern) or 3
    n_super = cfg.n_layers // period
    return period, n_super, cfg.n_layers - n_super * period


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def _init_rec(init, cfg: ModelConfig, n: int, pdt, device) -> dict:
    d, W = cfg.d_model, cfg.lru_width
    lam = torch.linspace(-2.0, 2.0, W, dtype=torch.float32, device=device)
    return {
        "norm": torch.zeros((n, d), dtype=pdt, device=device),
        "w_x": init((n, d, W), d),
        "w_gate": init((n, d, W), d),
        "conv_w": init((n, cfg.conv_width, W), cfg.conv_width),
        "conv_b": torch.zeros((n, W), dtype=pdt, device=device),
        "gate_a": init((n, W, W), W),
        "gate_x": init((n, W, W), W),
        "lam": lam.expand(n, W).contiguous(),
        "w_out": init((n, W, d), W),
    }


def _init_attn(init, cfg: ModelConfig, n: int, pdt, device) -> dict:
    d, hp, hd = cfg.d_model, cfg.padded_heads, cfg.head_dim
    return {
        "norm": torch.zeros((n, d), dtype=pdt, device=device),
        "wq": init((n, d, hp, hd), d),
        "wk": init((n, d, 1, hd), d),
        "wv": init((n, d, 1, hd), d),
        "wo": init((n, hp, hd, d), hp * hd),
    }


def _init_mlp(init, cfg: ModelConfig, n: int, pdt, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": torch.zeros((n, d), dtype=pdt, device=device),
        "wi_gate": init((n, d, f), d),
        "wi_up": init((n, d, f), d),
        "wo_mlp": init((n, f, d), f),
    }


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    pdt = torch_dtype(cfg.param_dtype)
    _, n_super, n_tail = _layout(cfg)
    init = functools.partial(cm.dense_init, generator=gen, device=device,
                             dtype=pdt)
    parts = {
        "superblocks.rec1": {**_init_rec(init, cfg, n_super, pdt, device),
                             **_init_mlp(init, cfg, n_super, pdt, device)},
        "superblocks.rec2": {**_init_rec(init, cfg, n_super, pdt, device),
                             **_init_mlp(init, cfg, n_super, pdt, device)},
        "superblocks.attn": {**_init_attn(init, cfg, n_super, pdt, device),
                             **_init_mlp(init, cfg, n_super, pdt, device)},
    }
    params = {
        "embed": cm.embed_init((cfg.padded_vocab, cfg.d_model), generator=gen,
                               device=device, dtype=pdt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=pdt, device=device),
    }
    if n_tail:
        parts["tail"] = {**_init_rec(init, cfg, n_tail, pdt, device),
                         **_init_mlp(init, cfg, n_tail, pdt, device)}
    for prefix, leaves in parts.items():
        params.update({f"{prefix}.{k}": v for k, v in leaves.items()})
    return params


def prepare(params: dict, cfg: ModelConfig) -> dict:
    """The projections cast to the compute dtype once, for serving (the
    reference casts them on every call; the cast is deterministic).
    ``conv_w`` stays float32: prefill's conv reads it so."""
    cd = torch_dtype(cfg.compute_dtype)
    return {name: (t.to(cd) if name.split(".")[-1] in _MATMUL_LEAVES else t)
            for name, t in params.items()}


def _superblock(params: dict, s: int) -> dict:
    return {g: {leaf: params[f"superblocks.{g}.{leaf}"][s] for leaf in leaves}
            for g, leaves in GROUP_LEAVES.items()}


def _tail(params: dict, t: int) -> dict:
    return {leaf: params[f"tail.{leaf}"][t]
            for leaf in REC_LEAVES + MLP_LEAVES}


def _embed(params, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype, times ``sqrt(d_model)``
    rounded to that dtype."""
    cd = torch_dtype(cfg.compute_dtype)
    scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=cd))
    return params["embed"][tokens].to(cd) * scale


# --------------------------------------------------------------------------- #
# RG-LRU
# --------------------------------------------------------------------------- #
def rglru_scan(log_a, inp, h0=None):
    """``h_t = exp(log_a_t) h_{t-1} + inp_t`` along axis 1 (S), from
    ``h_{-1} = h0`` (or 0), by recursive doubling: after the step of
    offset ``d`` each position holds the composition of its last ``2 d``
    steps, ``(a, b) . (a', b') = (a a', a' b + b')``.  ceil(log2 S) steps
    of out-of-place elementwise work: it runs under autograd,
    ``torch.func.vmap`` and a CUDA graph capture alike."""
    a = torch.exp(log_a)
    b = inp
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gates(xb, r_pre, i_pre, lam):
    """The RG-LRU's decay ``log a`` and input ``sqrt(1 - a^2) i x`` from the
    gate pre-activations, float32."""
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    log_a = -C_RGLRU * _softplus(lam) * r
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return log_a, mult * i * xb.float()


def rec_mixer(x, prm, flag, seed: int, cfg: ModelConfig, quant,
              conv_state=None, h0=None):
    """The RG-LRU mixer (training and prefill); returns the residual
    branch and ``(conv state, last h)``.  ``quant`` None: plain einsums
    (serving)."""
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    cd = x.dtype
    y = cm.rmsnorm(x, prm["norm"]).to(cd)
    xb = qp("bsd,dw->bsw", y, prm["w_x"].to(cd), seed=seed)
    gate = qp("bsd,dw->bsw", y, prm["w_gate"].to(cd), seed=seed + 1)
    xb, new_conv = _causal_conv(xb, prm["conv_w"], prm["conv_b"],
                                state=conv_state, activation=None)
    log_a, inp = _gates(
        xb, qp("bsw,wu->bsu", xb, prm["gate_a"].to(cd), seed=seed + 2),
        qp("bsw,wu->bsu", xb, prm["gate_x"].to(cd), seed=seed + 3),
        prm["lam"][None, None, :])
    h = rglru_scan(log_a, inp, h0=h0)
    out = h.to(cd) * F.gelu(gate, approximate="tanh")
    res = qp("bsw,wd->bsd", out, prm["w_out"].to(cd), seed=seed + 4)
    return res, (new_conv, h[:, -1])


def attn_mixer(x, prm, flag, seed: int, positions, cfg: ModelConfig, quant):
    """Local MQA attention (one KV head, RoPE, a window of
    ``cfg.attn_window``); returns the residual branch and the (B, S, 1,
    hd) K and V."""
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    cd = x.dtype
    h = cm.rmsnorm(x, prm["norm"]).to(cd)
    q = qp("bsd,dhk->bshk", h, prm["wq"].to(cd), seed=seed)
    k = qp("bsd,dhk->bshk", h, prm["wk"].to(cd), seed=seed + 1)
    v = qp("bsd,dhk->bshk", h, prm["wv"].to(cd), seed=seed + 2)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    hp = cfg.padded_heads
    out = cm.chunked_causal_attention(
        q, cm.repeat_kv(k, hp), cm.repeat_kv(v, hp),
        chunk_q=cfg.attn_chunk_q, causal=True, window=cfg.attn_window,
        scale=1.0 / math.sqrt(cfg.head_dim))
    res = qp("bshk,hkd->bsd", out, prm["wo"].to(cd), seed=seed + 3)
    return res, (k, v)


def mlp(x, prm, flag, seed: int, cfg: ModelConfig, quant):
    """The GeGLU MLP (tanh GeLU, ``jax.nn.gelu``'s default)."""
    qp = functools.partial(cm.qproj, quant_cfg=quant, flag=flag)
    cd = x.dtype
    h = cm.rmsnorm(x, prm["mlp_norm"]).to(cd)
    g = qp("bsd,df->bsf", h, prm["wi_gate"].to(cd), seed=seed + 5)
    u = qp("bsd,df->bsf", h, prm["wi_up"].to(cd), seed=seed + 6)
    return qp("bsf,fd->bsd", F.gelu(g, approximate="tanh") * u,
              prm["wo_mlp"].to(cd), seed=seed + 7)


def _rec_layer(x, prm, flag, seed: int, cfg: ModelConfig, quant):
    """A recurrent layer: ``x`` plus the RG-LRU mixer, plus the MLP;
    returns ``(x, (conv state, last h))``."""
    r, state = rec_mixer(x, prm, flag, seed, cfg, quant)
    x = x + r
    return x + mlp(x, prm, flag, seed, cfg, quant), state


def _attn_layer(x, prm, flag, seed: int, positions, cfg: ModelConfig, quant):
    """An attention layer; returns ``(x, (k, v))``."""
    a, kv = attn_mixer(x, prm, flag, seed, positions, cfg, quant)
    x = x + a
    return x + mlp(x, prm, flag, seed, cfg, quant), kv


def _superblock_fwd(x, sb, *, flags, seed: int, positions, cfg: ModelConfig,
                    quant):
    """One (rec, rec, attn) superblock of the training forward."""
    x, _ = _rec_layer(x, sb["rec1"], flags[0], seed, cfg, quant)
    x, _ = _rec_layer(x, sb["rec2"], flags[1], seed + 11, cfg, quant)
    x, _ = _attn_layer(x, sb["attn"], flags[2], seed + 23, positions, cfg,
                       quant)
    return x


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def forward_hidden(params, tokens, qflags, cfg: ModelConfig,
                   quant: QuantConfig):
    """Final-norm hidden states (B, S, d) of a training forward: the
    superblocks, each recomputed in the backward under remat, then the
    tail.  ``qflags``: one host bool per layer, or the trainer's flags
    tensor."""
    period, n_super, n_tail = _layout(cfg)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    # one unbind per stacked leaf (see transformer.forward_hidden)
    stacks = {g: {leaf: params[f"superblocks.{g}.{leaf}"].unbind(0)
                  for leaf in leaves} for g, leaves in GROUP_LEAVES.items()}
    remat = tfm._remat(cfg)
    for s in range(n_super):
        sb = {g: {leaf: t[s] for leaf, t in st.items()}
              for g, st in stacks.items()}
        block = functools.partial(
            _superblock_fwd, flags=[qflags[period * s + j] for j in range(3)],
            seed=SEED_STRIDE * s, positions=positions, cfg=cfg, quant=quant)
        if remat:
            # exact recomputation: the quantizers' draws are keyed by their
            # static (seed, fold) (see transformer.forward_hidden)
            x = torch.utils.checkpoint.checkpoint(
                block, x, sb, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, sb)
    if n_tail:
        tail = {leaf: params[f"tail.{leaf}"].unbind(0)
                for leaf in REC_LEAVES + MLP_LEAVES}
        for t in range(n_tail):
            prm = {leaf: v[t] for leaf, v in tail.items()}
            x, _ = _rec_layer(x, prm, qflags[period * n_super + t],
                              TAIL_SEED + SEED_STRIDE * t, cfg, quant)
    return cm.rmsnorm(x, params["final_norm"])


def lm_loss(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S) with the
    tied head.  The JAX package's ``lm_loss`` also takes an rng, which it
    deletes; the port leaves it out."""
    tokens = batch["tokens"]
    h = forward_hidden(params, tokens, qflags, cfg, quant)
    return cm.chunked_lm_loss(h[:, :-1], tokens[:, 1:], params["embed"],
                              real_vocab=cfg.vocab_size,
                              ce_chunk=cfg.ce_chunk)


# --------------------------------------------------------------------------- #
# serving: O(1) recurrent state and a ring KV cache
# --------------------------------------------------------------------------- #
def _window(cfg: ModelConfig, cache_len) -> int:
    """Ring rows of a cache that serves ``cache_len`` positions (None: any
    number)."""
    return cfg.attn_window if cache_len is None else min(cfg.attn_window,
                                                         cache_len)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``{name: (shape, dtype)}`` of a cache serving ``seq_len`` positions
    (nested as the cache; ``pos`` is host-side): the recurrent layers'
    ``h`` (float32) and conv state, the attention layers' ring of
    ``min(attn_window, seq_len)`` K and V rows."""
    cd = torch_dtype(cfg.compute_dtype)
    _, n_super, n_tail = _layout(cfg)
    W, win = cfg.lru_width, _window(cfg, seq_len)

    def rec_state(n):
        return {"h": ((n, batch, W), torch.float32),
                "conv": ((n, batch, cfg.conv_width - 1, W), cd)}

    ring = ((n_super, batch, 1, win, cfg.head_dim), cd)
    spec = {"rec1": rec_state(n_super), "rec2": rec_state(n_super),
            "attn": {"k": ring, "v": ring}, "pos": ((), torch.int32)}
    if n_tail:
        spec["tail"] = rec_state(n_tail)
    return spec


def _ring(k, win: int):
    """(B, S, 1, hd) -> the (B, 1, win, hd) ring of the last ``min(S,
    win)`` positions, position ``p`` in slot ``p % win``, zeros elsewhere."""
    S = k.shape[1]
    m = min(S, win)
    ring = k.new_zeros((k.shape[0], k.shape[2], win, k.shape[3]))
    slots = torch.arange(S - m, S, device=k.device) % win
    ring[:, :, slots] = k[:, S - m:].transpose(1, 2)
    return ring


def _stack_states(states: list) -> dict:
    return {"conv": torch.stack([c for c, _ in states]),
            "h": torch.stack([h for _, h in states])}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, quant: QuantConfig,
            cache_len=None):
    """Run the prompt; return the last token's float32 logits (B, V_pad)
    and the cache (see :func:`cache_spec`; ``pos`` a host int).
    ``cache_len``: the positions the cache is to serve, prompt included
    (None: any number); the ring holds ``min(attn_window, cache_len)``
    rows.  Every projection is unquantized, as the reference's zero flags
    make it, and the logits are the exact float32 product."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cache_len is not None and cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    _, n_super, n_tail = _layout(cfg)
    win = _window(cfg, cache_len)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    st1, st2, ks, vs = [], [], [], []
    for s in range(n_super):
        sb = _superblock(params, s)
        x, state = _rec_layer(x, sb["rec1"], False, 0, cfg, None)
        st1.append(state)
        x, state = _rec_layer(x, sb["rec2"], False, 0, cfg, None)
        st2.append(state)
        x, (k, v) = _attn_layer(x, sb["attn"], False, 0, positions, cfg,
                                None)
        ks.append(_ring(k, win))
        vs.append(_ring(v, win))
    cache = {"rec1": _stack_states(st1), "rec2": _stack_states(st2),
             "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}, "pos": S}
    if n_tail:
        states = []
        for t in range(n_tail):
            x, state = _rec_layer(x, _tail(params, t), False, 0, cfg, None)
            states.append(state)
        cache["tail"] = _stack_states(states)
    h_last = cm.rmsnorm(x[:, -1], params["final_norm"]).float()
    return h_last @ params["embed"].float().T, cache


def _rec_decode(x, prm, st: dict, i: int, cd):
    """One token's RG-LRU update of (B, d) ``x``; writes layer ``i`` of the
    state ``st`` in place, returns the residual branch."""
    y = cm.rmsnorm(x, prm["norm"]).to(cd)
    xb = torch.einsum("bd,dw->bw", y, prm["w_x"].to(cd))
    gate = torch.einsum("bd,dw->bw", y, prm["w_gate"].to(cd))
    xw = torch.cat([st["conv"][i].to(cd), xb[:, None, :]], dim=1)
    xb = (torch.einsum("bwd,wd->bd", xw, prm["conv_w"].to(cd))
          + prm["conv_b"][None, :])
    log_a, inp = _gates(xb, einsum("bw,wu->bu", xb, prm["gate_a"].to(cd)),
                        einsum("bw,wu->bu", xb, prm["gate_x"].to(cd)),
                        prm["lam"][None, :])
    h = torch.exp(log_a) * st["h"][i] + inp
    st["conv"][i] = xw[:, 1:]
    st["h"][i] = h
    out = h.to(cd) * F.gelu(gate, approximate="tanh")
    return torch.einsum("bw,wd->bd", out, prm["w_out"].to(cd))


def _mlp_decode(x, prm, cd):
    h = cm.rmsnorm(x, prm["mlp_norm"]).to(cd)
    g = torch.einsum("bd,df->bf", h, prm["wi_gate"].to(cd))
    u = torch.einsum("bd,df->bf", h, prm["wi_up"].to(cd))
    return torch.einsum("bf,fd->bd", F.gelu(g, approximate="tanh") * u,
                        prm["wo_mlp"].to(cd))


def _attn_decode(x, prm, ring: dict, i: int, pos: int, cfg: ModelConfig, cd):
    """One token's windowed MQA: writes its K and V into slot ``pos %
    win`` of layer ``i``'s ring, attends over the last ``win`` positions
    (slot ``j`` holds position ``pos - ((pos - j) mod win)``)."""
    B = x.shape[0]
    kc, vc = ring["k"][i], ring["v"][i]              # (B, 1, win, hd) views
    win = kc.shape[2]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    h = cm.rmsnorm(x, prm["norm"]).to(cd)
    q = torch.einsum("bd,dhk->bhk", h, prm["wq"].to(cd))
    k = torch.einsum("bd,dhk->bhk", h, prm["wk"].to(cd))
    v = torch.einsum("bd,dhk->bhk", h, prm["wv"].to(cd))
    q = cm.rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k = cm.rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    kc[:, :, pos % win] = k.to(cd)
    vc[:, :, pos % win] = v.to(cd)
    j = torch.arange(win, device=x.device)
    valid = pos - torch.remainder(pos - j, win) >= max(0, pos - win + 1)
    scores = torch.einsum("bhk,bgsk->bhs", q.float(),
                          kc.float()) / math.sqrt(cfg.head_dim)
    probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
    ctx = torch.einsum("bhs,bgsk->bhk", probs.to(cd), vc)
    return torch.einsum("bhk,hkd->bd", ctx, prm["wo"].to(cd))


@torch.no_grad()
def decode_step(params, cache, token, cfg: ModelConfig, quant: QuantConfig):
    """Append one token (B,) to every row at ``cache["pos"]``; writes the
    cache in place and returns ``(logits, cache)``."""
    cd = torch_dtype(cfg.compute_dtype)
    _, n_super, n_tail = _layout(cfg)
    pos = int(cache["pos"])
    x = _embed(params, token, cfg)
    for s in range(n_super):
        sb = _superblock(params, s)
        for g in ("rec1", "rec2"):
            x = x + _rec_decode(x, sb[g], cache[g], s, cd)
            x = x + _mlp_decode(x, sb[g], cd)
        x = x + _attn_decode(x, sb["attn"], cache["attn"], s, pos, cfg, cd)
        x = x + _mlp_decode(x, sb["attn"], cd)
    for t in range(n_tail):
        prm = _tail(params, t)
        x = x + _rec_decode(x, prm, cache["tail"], t, cd)
        x = x + _mlp_decode(x, prm, cd)
    h_last = cm.rmsnorm(x, params["final_norm"]).float()
    cache["pos"] = pos + 1
    return h_last @ params["embed"].float().T, cache


# --------------------------------------------------------------------------- #
# registry glue
# --------------------------------------------------------------------------- #
@register_family("hybrid")
def build_hybrid(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=functools.partial(prepare, cfg=cfg),
        loss_fn=functools.partial(lm_loss, cfg=cfg, quant=quant),
        prefill=functools.partial(prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(decode_step, cfg=cfg, quant=quant),
        kv_formats=("none",),
    )
