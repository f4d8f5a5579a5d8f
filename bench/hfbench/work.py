"""The yardstick of the roofline metrics: peaks of the card and the work of each operation.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor
cores, the figures the port's kernel bench used.  A card set below 700 W
runs slower; the run prints its power limit beside the metrics.

Work is counted from the cell's own parameters, never from the program:
each input read once, each output written once, and a read through indices
counts the distinct rows the indices name.  Where that count depends on the
data (windows of many queries falling on one table), it is the expected
number of distinct rows when ``draws`` rows are named uniformly at random,
``n (1 - exp(-draws / n))``.
"""

from __future__ import annotations

import math
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

Work = Tuple[float, float]  # (bytes, operations)


def least_seconds(work: Work) -> float:
    """The least time the card could take: bytes or operations, whichever is longer."""
    n_bytes, n_ops = work
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def distinct_rows(n: float, draws: float) -> float:
    if n <= 0 or draws <= 0:
        return 0.0
    return n * -math.expm1(-draws / n)


def sketch_words(d: int) -> int:
    return -(-d // 32)


def code_words(d: int) -> int:
    return -(-d // 8)


def key_words(key_bits: int) -> int:
    return -(-key_bits // 32)


def hamming_rows(q: int, k: int, table_rows: int, words: int, *,
                 queries_in_table: bool = False) -> Work:
    """Hamming distances of q query sketches to k rows each of a table named by
    (q, k) int32 indices: the query words, the distinct table rows, the
    indices in, the (q, k) int32 distances out; an XOR, a popcount and an add
    per word.  ``queries_in_table``: the queries are the table's own rows."""
    rows = table_rows if queries_in_table else distinct_rows(table_rows, q * k)
    n_bytes = 4.0 * words * (0 if queries_in_table else q) + 4.0 * words * rows
    n_bytes += 4.0 * q * k * 2
    return n_bytes, 3.0 * q * k * words


def qdist_windows(q: int, starts: int, window: int, d: int, table_rows: int) -> Work:
    """Squared distances of q float32 queries to ``starts`` windows of
    ``window`` rows each of nibble-packed codes: the queries, the int32
    starts, the distinct code rows and the (d, 16) centroids in, the float32
    distances out; a subtract, a multiply and an add per dimension."""
    c = starts * window
    n_bytes = 4.0 * q * d + 4.0 * q * starts + 64.0 * d
    n_bytes += 4.0 * code_words(d) * distinct_rows(table_rows, q * c) + 4.0 * q * c
    return n_bytes, 3.0 * q * c * d


def pack_bits(rows: int, k: int) -> Work:
    """(rows, k) bytes of {0, 1} in, (rows, ceil(k/32)) 32-bit words out."""
    return float(rows) * k + 4.0 * rows * -(-k // 32), 0.0


def search_path(q: int, n: int, d: int, trees: int, k1: int, k2: int, h: int, k: int
                ) -> float:
    """Least seconds of one search call of q queries, summed over its steps.

    Per tree, the table rows its windows name (order entries, master ranks,
    sketches) and the Hamming operations; then stage 2's code rows and
    distance operations, and the (q, k) ids and distances out.  Intermediate
    candidate lists are not counted: a fused path need not write them.
    """
    ws = sketch_words(d)
    rows = distinct_rows(n, q * k1)
    total = 0.0
    for _ in range(trees):
        total += least_seconds(((8.0 + 4.0 * ws) * rows + 4.0 * ws * q,
                                3.0 * q * k1 * ws))
    w = min(2 * h + 1, n)
    stage2 = (4.0 * q * d + 64.0 * d
              + 4.0 * code_words(d) * distinct_rows(n, q * k2 * w) + 8.0 * q * k,
              3.0 * q * k2 * w * d)
    return total + least_seconds(stage2)
