"""yi-34b [dense]: llama-arch GQA. 60L d=7168 56H kv=8 ff=20480 v=64000."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
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
)

SMOKE = ModelConfig(
    name="yi-34b-smoke",
    family="dense",
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
)
