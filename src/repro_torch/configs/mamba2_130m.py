"""mamba2-130m: 24L d_model=768, attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060].  d_inner = 1536, 24 SSD heads
of dim 64.  O(1) decode state -> runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern="M",
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    num_layers=3,
    d_model=96,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    layer_pattern="M",
    ssm_state_dim=16,
    ssm_head_dim=24,
    ssm_chunk=8,
    tie_embeddings=True,
)
