"""Architecture configuration (a copy of ``repro/models/arch.py``).

One ``ArchConfig`` describes any of the reference's 10 architectures (dense
/ GQA / MQA / MoE decoder-only transformers, the VLM and audio backbones,
the ssm and hybrid recurrent families). Family-specific fields are
zero/empty when unused. The port keeps its own copy, as it imports nothing
of the JAX package; ``repro_torch/configs`` holds the archs it can run.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "vlm", "audio", "ssm", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0            # 0 for attention-free (rwkv)
    num_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # recurrent / hybrid
    rwkv_head_size: int = 64      # RWKV-6 head size
    window: int = 0               # local-attention window (recurrentgemma)
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0                # RG-LRU width (0 -> d_model)
    conv_width: int = 4

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    num_frames: int = 0           # encoder positions from the stub frontend

    # vlm (phi-3-vision)
    num_patches: int = 0
    d_patch: int = 0              # stub patch-embedding dim

    # numerics / runtime
    mlp_type: str = "swiglu"      # 'swiglu' (3 mats) | 'gelu' (2 mats)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    attention_impl: str = "auto"  # 'full' | 'chunked' | 'auto'
    attention_chunk: int = 1024   # kv-chunk for flash-style attention
    remat: bool = True            # checkpoint each layer in train_step
    scan_layers: bool = True      # lax.scan over stacked layer params

    # annotations
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def q_per_kv(self) -> int:
        return max(self.num_heads, 1) // max(self.num_kv_heads, 1)

    @property
    def mlp_mats(self) -> int:
        return 2 if self.mlp_type == "gelu" else 3

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), used by
        config sanity tests and the 6*N*D roofline term."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        h, g = max(self.num_heads, 1), max(self.num_kv_heads, 1)
        attn = d * (h * hd) + 2 * d * (g * hd) + (h * hd) * d
        if self.family == "moe":
            mlp = self.num_experts * (self.mlp_mats * d * ff) + d * self.num_experts
        else:
            mlp = self.mlp_mats * d * ff
        if self.name.startswith("rwkv"):
            # time-mix: r,k,v,w,g,o (6 d^2-ish) + channel-mix 3*d*ff approx
            per_layer = 6 * d * d + 2 * d * ff + d * ff
        elif self.family == "hybrid":
            n_att = sum(1 for b in self._pattern() if b == "attn")
            n_rec = self.num_layers - n_att
            rnn = self.d_rnn or d
            att_l = attn + 3 * d * ff
            rec_l = 2 * d * rnn + 2 * rnn + rnn * d + 3 * d * ff
            return v * d + n_att * att_l + n_rec * rec_l + v * d
        elif self.family == "audio":
            dec_l = 2 * attn + 2 * d * ff  # self+cross attn, gelu mlp (2 mats)
            enc_l = attn + 2 * d * ff
            return (v * d + self.encoder_layers * enc_l
                    + self.num_layers * dec_l + v * d)
        else:
            per_layer = attn + mlp
            return v * d + self.num_layers * per_layer + v * d
        return v * d + self.num_layers * per_layer + v * d

    def active_param_count(self) -> int:
        """Parameters touched per token (= param_count for dense)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        hd = self.resolved_head_dim
        h, g = self.num_heads, self.num_kv_heads
        attn = d * (h * hd) + 2 * d * (g * hd) + (h * hd) * d
        mlp_active = (self.experts_per_token * (self.mlp_mats * d * ff)
                      + d * self.num_experts)
        per_layer = attn + mlp_active
        return self.vocab_size * d + self.num_layers * per_layer + self.vocab_size * d

    def _pattern(self) -> tuple[str, ...]:
        if not self.block_pattern:
            return ()
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic state): ssm + hybrid
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
