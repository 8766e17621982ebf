"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="stablelm-3b", family="dense_lm",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50_304, mlp_activation="swiglu",
    tie_embeddings=False, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="float32",
    attn_chunk_q=512, ce_chunk=512,
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke", family="dense_lm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab_size=199, mlp_activation="swiglu",
    tie_embeddings=False, compute_dtype="float32",
    attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("stablelm-3b", FULL, SMOKE)
