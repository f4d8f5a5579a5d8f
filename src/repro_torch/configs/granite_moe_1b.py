"""granite-moe-1b-a400m [moe]: 32 experts top-8. 24L d=1024 16H kv=8
ff=512 (per expert) vocab=49155 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.models.config import MOE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(LayerSpec(ffn=MOE),),
    n_experts=32,
    topk_experts=8,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    pattern=(LayerSpec(ffn=MOE),),
    n_experts=8,
    topk_experts=4,
    # drop-free capacity (= E/k): exact train/decode equivalence in tests
    capacity_factor=2.0,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)
