"""Model configuration: one dataclass covers all 10 assigned architectures.

A copy of ``repro.models.config`` (pure data; the port imports nothing of
``repro``).  Heterogeneous stacks (gemma3's 5 local:1 global, jamba's
1 attn:7 mamba with alternating MoE) are expressed as a repeating **layer
pattern**: a tuple of ``LayerSpec`` of length p.  The stack is
``n_layers // p`` pattern blocks and the ``n_layers % p`` remainder; the
port's :class:`repro_torch.models.model.Transformer` keeps its layers in
that order (block b, position s is layer ``b * p + s``; then the tail).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Mixer kinds
ATTN = "attn"
MAMBA = "mamba"
# FFN kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's shape within the repeating pattern."""

    mixer: str = ATTN            # "attn" | "mamba"
    ffn: str = DENSE             # "dense" | "moe" | "none"
    window: int = 0              # 0 = full attention; >0 = local/SWA window
    rope_theta: float = 10_000.0
    cross_attn: bool = False     # decoder layers attending to encoder output


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # --- MoE ---
    n_experts: int = 0
    topk_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- misc ---
    act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU) | relu2 (squared ReLU)
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # --- encoder-decoder (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500       # stub audio frontend frames

    # --- VLM (llava) ---
    n_patches: int = 0           # stub vision frontend patch count
    patch_dim: int = 1024        # raw patch-embedding dim before projection

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- training-time knobs (overridable per run) ---
    remat_policy: str = "minimal"  # none | minimal | full
    scan_blocks: bool = True

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so the 'vocab' axis shards evenly at TP=16."""
        return -(-self.vocab_size // 256) * 256

    @property
    def pattern_len(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def tail_specs(self) -> Tuple[LayerSpec, ...]:
        return self.pattern[: self.n_layers % self.pattern_len]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + stacks); used for 6ND."""
        d = self.d_model
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        specs = list(self.pattern) * self.n_blocks + list(self.tail_specs)
        for s in specs:
            total += self.layer_params(s)
        if self.is_encdec:
            enc = LayerSpec(mixer=ATTN, ffn=DENSE)
            total += self.n_enc_layers * self.layer_params(enc)
        if self.n_patches:
            total += self.patch_dim * d
        total += d  # final norm
        return total

    def layer_params(self, s: LayerSpec) -> int:
        d = self.d_model
        n = 0
        if s.mixer == ATTN:
            n += d * self.n_heads * self.head_dim  # wq
            n += 2 * d * self.n_kv_heads * self.head_dim  # wk, wv
            n += self.n_heads * self.head_dim * d  # wo
            n += d  # norm
            if s.cross_attn:
                n += d * self.n_heads * self.head_dim
                n += 2 * d * self.n_kv_heads * self.head_dim
                n += self.n_heads * self.head_dim * d
                n += d
        elif s.mixer == MAMBA:
            di, ns, hs = self.d_inner, self.ssm_state, self.ssm_heads
            n += d * (2 * di + 2 * ns + hs)  # in_proj (z, x, B, C, dt)
            n += self.ssm_conv_width * (di + 2 * ns)  # depthwise conv
            n += 2 * hs  # A_log, D
            n += di * d  # out_proj
            n += d + di  # pre-norm + gated rmsnorm
        if s.ffn == DENSE:
            mult = 3 if self.act in ("silu", "gelu") else 2
            n += mult * d * self.d_ff + d
        elif s.ffn == MOE:
            mult = 3 if self.act in ("silu", "gelu") else 2
            n += self.n_experts * mult * d * self.d_ff
            n += d * self.n_experts  # router
            n += d
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k of E experts) for 6·N_active·D."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        mult = 3 if self.act in ("silu", "gelu") else 2
        per_expert = mult * d * self.d_ff
        total = self.param_count()
        specs = list(self.pattern) * self.n_blocks + list(self.tail_specs)
        n_moe = sum(1 for s in specs if s.ffn == MOE)
        total -= n_moe * (self.n_experts - self.topk_experts) * per_expert
        return total
