"""stablelm-1.6b: 24L d_model=2048 32H (kv=32, full MHA) d_ff=5632 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-1.6b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=8,
    d_ff=320,
    vocab_size=512,
    attention_impl="naive",
)
