"""whisper-medium [audio] — 24L enc + 24L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865; conv frontend STUB (precomputed frame embeddings)
[arXiv:2212.04356; unverified].

Vocab padded to 51968 (128-multiple).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51_865, mlp_activation="gelu",
    tie_embeddings=True, pad_heads_to=16,
    compute_dtype="bfloat16", param_dtype="float32",
    attn_chunk_q=512, ce_chunk=512,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
    d_ff=128, vocab_size=131, mlp_activation="gelu",
    tie_embeddings=True, compute_dtype="float32",
    attn_chunk_q=16, ce_chunk=16, pad_vocab_to=16,
)

register("whisper-medium", FULL, SMOKE)
