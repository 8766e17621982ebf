"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT frontend STUB (256 precomputed patch embeddings)
[arXiv:2404.16821; hf].

Heads padded 14 -> 16; vocab padded to 151680 (128-multiple).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151_655, n_vision_tokens=256,
    mlp_activation="swiglu", tie_embeddings=True, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="float32",
    attn_chunk_q=512, ce_chunk=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=211, n_vision_tokens=4,
    mlp_activation="swiglu", tie_embeddings=True, pad_heads_to=4,
    compute_dtype="float32", attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("internvl2-1b", FULL, SMOKE)
