"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP, layernorm.
96L d=18432 96H kv=8 hd=192 ff=73728 vocab=256000 [arXiv:2402.16819]."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    pattern=(LayerSpec(),),
    act="relu2",
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=256,
    vocab_size=512,
    pattern=(LayerSpec(),),
    act="relu2",
    norm="layernorm",
)
