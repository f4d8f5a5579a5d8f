"""llava-next-34b [vlm]: yi-34b backbone + anyres patch embeddings (stub).

60L d=7168 56H kv=8 ff=20480 v=64000; the vision tower is a STUB per the
brief — input_specs() supplies 2880 precomputed patch embeddings (anyres:
base 576 + 4 tiles × 576) which replace the first 2880 token positions.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    pattern=(LayerSpec(rope_theta=5_000_000.0),),
    act="silu",
    norm="rmsnorm",
    n_patches=2880,
    patch_dim=1024,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(rope_theta=5_000_000.0),),
    act="silu",
    norm="rmsnorm",
    n_patches=8,
    patch_dim=32,
)
