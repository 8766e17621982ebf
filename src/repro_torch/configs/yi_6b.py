"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA, SwiGLU [arXiv:2403.04652; hf]."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="yi-6b", family="dense_lm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64_000, mlp_activation="swiglu",
    tie_embeddings=False, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="float32",
    attn_chunk_q=512, ce_chunk=512,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense_lm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=223, mlp_activation="swiglu",
    tie_embeddings=False, compute_dtype="float32",
    attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("yi-6b", FULL, SMOKE)
