"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256  [arXiv:2403.08295; hf]."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="gemma-7b", family="dense_lm",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256_000, mlp_activation="geglu",
    tie_embeddings=True, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="float32",
    attn_chunk_q=512, ce_chunk=512,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke", family="dense_lm",
    n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=256, vocab_size=409, mlp_activation="geglu",
    tie_embeddings=True, compute_dtype="float32",
    attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("gemma-7b", FULL, SMOKE)
