"""seamless-m4t-medium: enc-dec 12L+12L d_model=1024 16H d_ff=4096
vocab=256206 [arXiv:2308.11596].  The speech frontend is a STUB — inputs
are precomputed fbank-frame embeddings [B, T_src, d_model] with
T_src = tgt_len / 4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    encoder_seq_ratio=4,
    frontend="audio_stub",
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=8,
    d_ff=256,
    vocab_size=512,
    is_encoder_decoder=True,
    num_encoder_layers=2,
    encoder_seq_ratio=4,
    frontend="audio_stub",
    attention_impl="naive",
)
