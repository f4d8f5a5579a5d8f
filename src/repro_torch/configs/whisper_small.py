"""whisper-small [audio]: enc-dec, conv frontend stubbed to frame embeddings.

12L (dec) d_model=768 12H (kv=12) d_ff=3072 vocab=51865 [arXiv:2212.04356].
Adaptations (DESIGN.md): learned positions -> parameter-free sinusoidal so
the assigned 32k decode shapes lower; conv frontend is a stub per the brief
(input_specs supplies 1500 precomputed frame embeddings).
"""

from repro_torch.models.config import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pattern=(LayerSpec(mixer=ATTN, ffn=DENSE, cross_attn=True),),
    act="gelu_plain",
    norm="layernorm",
    is_encdec=True,
    n_enc_layers=12,
    enc_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(mixer=ATTN, ffn=DENSE, cross_attn=True),),
    act="gelu_plain",
    norm="layernorm",
    is_encdec=True,
    n_enc_layers=2,
    enc_frames=16,
)
