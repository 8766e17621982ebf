"""BERT-base for SNLI classification (paper's NLP experiment, DP-AdamW)."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="bert-snli", family="bert",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=30_522, num_classes=3, max_position=128,
    mlp_activation="gelu", compute_dtype="float32", pad_heads_to=1,
    pad_vocab_to=2, attn_chunk_q=128, ce_chunk=128,
)

SMOKE = ModelConfig(
    name="bert-smoke", family="bert",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
    d_ff=96, vocab_size=149, num_classes=3, max_position=32,
    compute_dtype="float32", attn_chunk_q=16, pad_vocab_to=16,
)

register("bert-snli", FULL, SMOKE)
