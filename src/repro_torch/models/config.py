"""Model configuration shared by every architecture in the zoo.

The port's own copy of the JAX package's ``ModelConfig``, field for field,
so that a config module reads the same in both packages.  One dataclass
covers dense / MoE / SSM / hybrid / enc-dec / VLM / audio families;
family-specific fields default to "off".  The port runs every family
(``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention ---
    attention_kind: str = "gqa"  # gqa | mha | mla
    sliding_window: Optional[int] = None  # SWA window (tokens), None = full
    rope_theta: float = 10_000.0
    qk_norm: bool = False

    # --- MLA (multi-head latent attention) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_layer_period: int = 1  # every k-th layer is MoE (1 = all)
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    moe_impl: str = "gspmd"  # gspmd (scatter) | shard_map (explicit a2a EP)

    # --- SSM / hybrid ---
    # layer pattern: string over {"A" (attention), "M" (mamba)}, one char per
    # layer within a repeating period; replicated to num_layers.
    layer_pattern: Optional[str] = None
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    hybrid_attn_window: Optional[int] = None  # window for attn layers in hybrids

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_ratio: int = 4  # src_len = tgt_len // ratio for shape cells

    # --- modality frontends (stubs: precomputed embeddings as inputs) ---
    frontend: Optional[str] = None  # "vision_stub" | "audio_stub"
    num_frontend_tokens: int = 0  # patches / frames consumed per example

    # --- numerics ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    logits_dtype: str = "float32"

    # --- runtime / performance knobs (hillclimbed in §Perf) ---
    attention_impl: str = "chunked"  # chunked | naive
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    remat: str = "full"  # full | none
    scan_layers: bool = True
    use_grad_accum_microbatches: int = 1  # >1 -> grad-accumulation scan
    decode_seq_shards: bool = True  # flash-decoding style KV-seq sharding

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attention_kind == "mla" and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    # ------------------------------------------------------------------
    @property
    def pattern(self) -> str:
        """Per-layer block types, length == num_layers."""
        if self.layer_pattern is None:
            base = "M" if self.family == "ssm" else "A"
            return base * self.num_layers
        reps = -(-self.num_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.num_layers]

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        if self.moe_layer_period <= 1:
            return True
        # Jamba/DeepSeek convention: every `period`-th layer starting at 1
        return (i % self.moe_layer_period) == (self.moe_layer_period - 1)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb + d  # final norm
        for i, kind in enumerate(self.pattern):
            total += 2 * d  # pre-norms
            if kind == "A":
                total += self._attn_params()
            else:
                total += self._ssm_params()
            if kind == "A" or self.family != "ssm":
                total += self._ffn_params(i)
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                total += 2 * d + self._attn_params() + self._ffn_params(0)
            # decoder cross-attention
            total += self.num_layers * (self._attn_params() + d)
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention_kind == "mla":
            hd = self.qk_nope_dim + self.qk_rope_dim
            q = (
                d * self.q_lora_rank + self.q_lora_rank * self.num_heads * hd
                if self.q_lora_rank
                else d * self.num_heads * hd
            )
            kv = d * (self.kv_lora_rank + self.qk_rope_dim)
            kv += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
            o = self.num_heads * self.v_head_dim * d
            return q + kv + o
        h, k, hd = self.num_heads, self.num_kv_heads, self.head_dim
        return d * h * hd + 2 * d * k * hd + h * hd * d

    def _ffn_params(self, layer_idx: int) -> int:
        d, f = self.d_model, self.d_ff
        dense = 3 * d * f  # SwiGLU
        if self.is_moe_layer(layer_idx):
            e = self.num_experts + self.num_shared_experts
            return e * dense + d * self.num_experts  # + router
        return dense

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        n, hds = self.ssm_state_dim, self.ssm_heads
        in_proj = d * (2 * di + 2 * n + hds)  # z, x, B, C, dt
        conv = self.ssm_conv_width * (di + 2 * n)
        out = di * d
        extras = hds * 2 + di  # A_log, dt_bias, (D)
        return in_proj + conv + out + extras

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if self.num_experts == 0:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        dense = 3 * self.d_model * self.d_ff
        inactive = moe_layers * (
            self.num_experts - self.num_experts_per_token
        ) * dense
        return total - inactive
