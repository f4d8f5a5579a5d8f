"""gemma3-1b [dense]: 5 local : 1 global, 26L d=1152 4H kv=1 hd=256
ff=6912 vocab=262144, tied embeddings [hf:google/gemma-3-1b-pt].

Pattern block = 6 layers (5×local(window 512, θ=10k) + 1×global(θ=1M));
26 = 4 blocks + 2 tail local layers.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(window=512, rope_theta=10_000.0)
_GLOBAL = LayerSpec(window=0, rope_theta=1_000_000.0)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    family="dense",
    n_layers=8,  # one full pattern block + 2 tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(
        LayerSpec(window=8, rope_theta=10_000.0),
        LayerSpec(window=8, rope_theta=10_000.0),
        LayerSpec(window=8, rope_theta=10_000.0),
        LayerSpec(window=8, rope_theta=10_000.0),
        LayerSpec(window=8, rope_theta=10_000.0),
        LayerSpec(window=0, rope_theta=1_000_000.0),
    ),
    act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
)
