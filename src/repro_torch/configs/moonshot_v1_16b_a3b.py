"""moonshot-v1-16b-a3b: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert)
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_experts_per_token=6,
    use_grad_accum_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=8,
    d_ff=64,
    vocab_size=512,
    num_experts=8,
    num_experts_per_token=2,
    attention_impl="naive",
)
