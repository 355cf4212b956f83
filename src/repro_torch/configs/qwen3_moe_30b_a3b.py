"""qwen3-moe-30b-a3b: 48L d_model=2048 32H (GQA kv=4) d_ff=768 (expert)
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].  QK-norm per
the Qwen3 family signature.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_token=8,
    qk_norm=True,
    use_grad_accum_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=48,
    vocab_size=512,
    num_experts=8,
    num_experts_per_token=2,
    qk_norm=True,
    attention_impl="naive",
)
