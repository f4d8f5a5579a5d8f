"""mixtral-8x22b [moe]: 8 experts top-2, SWA. 56L d=6144 48H kv=8
ff=16384 (per expert) vocab=32768 [arXiv:2401.04088]; window 4096 per the
assignment."""

from repro_torch.models.config import MOE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec(ffn=MOE, window=4096, rope_theta=1_000_000.0),),
    n_experts=8,
    topk_experts=2,
    act="silu",
    norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(ffn=MOE, window=8, rope_theta=1_000_000.0),),
    n_experts=4,
    topk_experts=2,
    # drop-free capacity (= E/k): exact train/decode equivalence in tests
    capacity_factor=2.0,
    act="silu",
    norm="rmsnorm",
)
