"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

Heads padded 56 -> 64 (zero-initialized pad heads).  Dense residual MLP
width = d_model (the hf config's dense FFN).  ``sharding_overrides`` are
the JAX package's (experts over (pod, model), expert hidden over data, the
batch over data alone); the port's train step reads the batch rule.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="arctic-480b", family="moe_lm",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=0, expert_d_ff=4864, n_experts=128, top_k=2,
    dense_ff_residual=7168,
    vocab_size=32_000, mlp_activation="swiglu", moe_impl="capacity",
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
    name="arctic-smoke", family="moe_lm",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
    d_ff=0, expert_d_ff=64, n_experts=4, top_k=2, dense_ff_residual=48,
    vocab_size=157, mlp_activation="swiglu", moe_impl="capacity",
    tie_embeddings=True, compute_dtype="float32", pad_heads_to=2,
    attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("arctic-480b", FULL, SMOKE)
