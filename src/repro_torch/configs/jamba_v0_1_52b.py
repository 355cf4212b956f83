"""jamba-v0.1-52b: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Mamba+attention 1:7 interleave, MoE 16 experts top-2 every other layer
[arXiv:2403.19887].  Period-8 super-block "MMMMAMMM" with MoE at odd
layer indices.  Hybrid -> runs the long_500k cell (SSM state + 4 full-attn
layer caches).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern="MMMMAMMM",
    num_experts=16,
    num_experts_per_token=2,
    moe_layer_period=2,
    ssm_state_dim=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    use_grad_accum_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    layer_pattern="MMAM",
    num_experts=4,
    num_experts_per_token=2,
    moe_layer_period=2,
    ssm_state_dim=16,
    ssm_head_dim=32,
    ssm_chunk=8,
    attention_impl="naive",
)
