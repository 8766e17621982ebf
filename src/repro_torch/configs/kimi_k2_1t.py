"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 [arXiv:2501.kimi2; unverified].

``sharding_overrides`` are the JAX package's (experts over (pod, model),
expert hidden over data, the batch over data alone); the port's train
step reads the batch rule.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe_lm",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=0, expert_d_ff=2048, n_experts=384, top_k=8,
    vocab_size=163_840, mlp_activation="swiglu", moe_impl="capacity",
    tie_embeddings=True, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="bfloat16",
    attn_chunk_q=512, ce_chunk=512,
    sharding_overrides=(
        ("experts", (("pod", "model"), ("model",))),
        ("expert_mlp", (("data",),)),
        ("batch", (("data",),)),
    ),
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe_lm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=0, expert_d_ff=96, n_experts=8, top_k=2,
    vocab_size=173, mlp_activation="swiglu", moe_impl="capacity",
    tie_embeddings=True, compute_dtype="float32",
    attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("kimi-k2-1t-a32b", FULL, SMOKE)
