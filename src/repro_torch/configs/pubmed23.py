"""PUBMED23 / Task-1 index configs — the paper's own hyperparameters.

A copy of ``repro.configs.pubmed23``.  23M x 384-dim fp32 vectors (36 GB
raw); the challenge's limits were 16 GB RAM, 8 CPU cores and recall@30
> 0.7.  Table 1's settings are reproduced verbatim; the recalls in the
comments are the paper's PUBMED23 figures, not the port's.
``repro_torch.benchmarks.task1_table1`` runs them.
"""

from repro_torch.core.types import ForestConfig, QuantizerConfig, SearchParams

N_POINTS = 23_000_000
DIM = 384

# Index (paper §3.1): ≤160 trees, ~100-point leaves, 384-bit sketches,
# 4-bit codes sharing the MSB plane with the sketch.
FOREST = ForestConfig(n_trees=160, bits=4, key_bits=448, leaf_size=100, seed=0)
QUANT = QuantizerConfig(bits=4)

# Table 1 rows (n, k1, k2, h) — the 16 submitted hyperparameter combos.
TABLE1 = [
    SearchParams(k1=1420, k2=370, h=2, k=30),   # n=160: recall 72.9% (paper)
    SearchParams(k1=1420, k2=360, h=2, k=30),
    SearchParams(k1=1300, k2=350, h=2, k=30),
    SearchParams(k1=1300, k2=340, h=2, k=30),
    SearchParams(k1=1200, k2=330, h=2, k=30),
    SearchParams(k1=1200, k2=320, h=2, k=30),
    SearchParams(k1=1100, k2=310, h=2, k=30),
    SearchParams(k1=1100, k2=300, h=2, k=30),
    SearchParams(k1=4000, k2=1000, h=2, k=30),  # n=120: recall 79.1% (paper)
    SearchParams(k1=3200, k2=1000, h=2, k=30),
    SearchParams(k1=2800, k2=1000, h=2, k=30),
    SearchParams(k1=2400, k2=1000, h=2, k=30),
    SearchParams(k1=2000, k2=1000, h=2, k=30),
    SearchParams(k1=1800, k2=1000, h=2, k=30),
    SearchParams(k1=1600, k2=1000, h=2, k=30),
    SearchParams(k1=1600, k2=800, h=2, k=30),
]
TABLE1_TREES = [160] * 8 + [120] * 8


# RAM budget (paper §3.1): ~76 MB/tree × ≤160 trees + ~1.1 GB sketches +
# 4-bit codes with one bitplane shared => ~4.5 GB stage-2.
#
# A "tree" = per-tree point order + rank directory.  With 32-bit ids the
# order alone is 92 MB; the paper's 76 MB implies ⌈log2 23M⌉ = 25-bit
# packed ids (23M·25/8 = 72 MB + directory ≈ 76 MB) — the budget below
# models that packed layout (the search holds int32 ids in memory).
def memory_budget_bytes(n_trees: int = 160) -> dict:
    id_bits = max(1, (N_POINTS - 1).bit_length())            # 25
    order = N_POINTS * id_bits // 8                           # 72 MB
    directory = N_POINTS // FOREST.leaf_size * (FOREST.key_bits // 8)
    sketches = N_POINTS * DIM // 8                            # 1.10 GB
    codes = N_POINTS * DIM // 2                               # 4.42 GB
    shared = N_POINTS * DIM // 8                              # MSB plane
    return {
        "per_tree": order + directory,
        "forest": n_trees * (order + directory),
        "sketches": sketches,
        "codes": codes,
        "stage2_combined": sketches + codes - shared,
    }
