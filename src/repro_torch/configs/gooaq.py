"""GOOAQ / Task-2 graph-construction configs — paper Table 2 verbatim.

A copy of ``repro.configs.gooaq``.  3M x 384-dim vectors; the challenge's
limits were 16 GB / 8 CPU cores, recall@15 > 0.8, ranked by construction
time.  The times in the comments are the paper's 8-core CPU figures, not
the port's.
"""

from repro_torch.core.types import ForestConfig, GraphParams

N_POINTS = 3_000_000
DIM = 384

FOREST = ForestConfig(bits=4, key_bits=448, leaf_size=100, seed=0)

# Table 2: (time s, recall %) — n, k1, k2
TABLE2 = [
    GraphParams(n_orders=80, k1=96, k2=60, k=15),     # 74 s,  80.5%
    GraphParams(n_orders=112, k1=106, k2=75, k=15),   # 109 s, 85.5%
    GraphParams(n_orders=160, k1=130, k2=100, k=15),  # 164 s, 90.5%
    GraphParams(n_orders=280, k1=168, k2=150, k=15),  # 330 s, 95.5%
    GraphParams(n_orders=720, k1=170, k2=300, k=15),  # 856 s, 98.5%
]
