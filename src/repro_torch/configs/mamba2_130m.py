"""mamba2-130m [ssm] — 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*d_model = 1536, head_dim 64 -> 24 SSD heads, chunk 256.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, d_inner=1536, ssm_heads=24, ssm_head_dim=64,
    ssm_state=128, ssm_chunk=256, conv_width=4,
    vocab_size=50_280,
    compute_dtype="bfloat16", param_dtype="float32",
    ce_chunk=512,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, d_inner=128, ssm_heads=4, ssm_head_dim=32,
    ssm_state=16, ssm_chunk=16, conv_width=4,
    vocab_size=127, compute_dtype="float32", ce_chunk=16, pad_vocab_to=16,
)

register("mamba2-130m", FULL, SMOKE)
