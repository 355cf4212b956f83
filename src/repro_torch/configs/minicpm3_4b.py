"""minicpm3-4b: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA.

[hf:openbmb/MiniCPM3-4B]. Multi-head latent attention: KV cache stores the
compressed latent (R=256) + rope key (P=32) per token; decode uses the
weight-absorbed path.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    head_dim=96,  # nope + rope
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm3-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=8,
    d_ff=256,
    vocab_size=512,
    attention_kind="mla",
    q_lora_rank=64,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    head_dim=24,
    attention_impl="naive",
)
