"""h2o-danube-3-4b: 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.

llama+mistral mix with sliding-window attention [arXiv:2401.16818].
SWA window 4096 -> bounded KV cache; runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=500_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="h2o-danube-3-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    sliding_window=16,
    attention_impl="naive",
)
