"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention (window 2048), pattern 1:2
attn:recurrent -> (rec, rec, attn) x 12 + (rec, rec) [arXiv:2402.19427]."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, lru_width=4096, conv_width=4, attn_window=2048,
    block_pattern=("rec", "rec", "attn"),
    vocab_size=256_000, mlp_activation="geglu",
    tie_embeddings=True, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="float32",
    attn_chunk_q=512, ce_chunk=512,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=8, d_model=48, n_heads=4, n_kv_heads=1, head_dim=12,
    d_ff=96, lru_width=64, conv_width=4, attn_window=8,
    block_pattern=("rec", "rec", "attn"),
    vocab_size=151, compute_dtype="float32",
    attn_chunk_q=8, ce_chunk=16, pad_vocab_to=16,
)

register("recurrentgemma-9b", FULL, SMOKE)
