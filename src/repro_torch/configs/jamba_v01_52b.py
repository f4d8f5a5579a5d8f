"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE every 2nd
layer. 32L d=4096 32H kv=8 ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887].

Pattern block = 8 layers: position 0 is attention, 1-7 mamba; MoE FFN at odd
positions (4 per block -> 16 MoE layers of 32, the paper's every-2nd-layer).
Adaptation (DESIGN.md): Jamba ships Mamba-1 scans; we implement the Mamba-2
SSD dual (chunked matmul form) — the TPU-native equivalent — keeping the
published state size (N=16) and d_inner=2·d_model.
"""

from repro_torch.models.config import ATTN, DENSE, MAMBA, MOE, LayerSpec, ModelConfig

_P = (
    LayerSpec(mixer=ATTN, ffn=DENSE),
    LayerSpec(mixer=MAMBA, ffn=MOE),
    LayerSpec(mixer=MAMBA, ffn=DENSE),
    LayerSpec(mixer=MAMBA, ffn=MOE),
    LayerSpec(mixer=MAMBA, ffn=DENSE),
    LayerSpec(mixer=MAMBA, ffn=MOE),
    LayerSpec(mixer=MAMBA, ffn=DENSE),
    LayerSpec(mixer=MAMBA, ffn=MOE),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=_P,
    n_experts=16,
    topk_experts=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    act="silu",
    norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    n_layers=8,  # one pattern block
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=_P,
    n_experts=4,
    topk_experts=2,
    # drop-free capacity (= E/k): exact train/decode equivalence in tests
    capacity_factor=2.0,
    ssm_state=8,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    act="silu",
    norm="rmsnorm",
)
