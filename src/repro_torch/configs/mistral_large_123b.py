"""mistral-large-123b: 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

[hf:mistralai/Mistral-Large-Instruct-2407]. The FSDP+TP stress case:
grad-accumulation microbatches keep the remat carries inside v5e HBM.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    use_grad_accum_microbatches=4,
)

SMOKE_CONFIG = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    num_layers=3,
    d_model=192,
    num_heads=12,
    num_kv_heads=2,
    d_ff=448,
    vocab_size=512,
    attention_impl="naive",
)
