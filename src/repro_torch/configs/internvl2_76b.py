"""internvl2-76b: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + InternLM2 [arXiv:2404.16821].  VLM: the vision frontend is a
stub, as in the JAX package — precomputed patch embeddings
[B, 256, d_model] arrive as inputs; a learned projector maps them into the
LM.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_stub",
    num_frontend_tokens=256,
    use_grad_accum_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-76b-smoke",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    frontend="vision_stub",
    num_frontend_tokens=4,
    attention_impl="naive",
)
