"""mamba2-780m [ssm]: attention-free SSD. 48L d=1536 vocab=50280
ssm_state=128 [arXiv:2405.21060]. d_inner=3072, 48 SSD heads of dim 64."""

from repro_torch.models.config import MAMBA, NONE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,     # placeholders: no attention layers exist in the pattern
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(mixer=MAMBA, ffn=NONE),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    pattern=(LayerSpec(mixer=MAMBA, ffn=NONE),),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)
