"""The plain reference against the program on the CPU: the same index, the
same search answers and the same graph, bit for bit, at toy sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hfbench import check, data
from hfbench.kind import index_config, index_fields, program, reference_search
from reference import plain

BASE = {"rows": 2000, "dim": 32, "n_trees": 5, "bits": 4, "leaf_size": 16, "forest_seed": 3,
        "quant_bits": 4, "sample_limit": 700, "store_points": True,
        "assumed": {"n_clusters": 8, "intrinsic_rank": 4, "noise": 0.9}}


@pytest.fixture(scope="module", params=[64, 128], ids=["two_planes", "every_plane"])
def case(request):
    cfg = dict(BASE, key_bits=request.param)
    rows = data.draw(cfg, 48, 7 + request.param, torch.device("cpu"))
    p = program()
    pts, qs = rows[: cfg["rows"]], rows[cfg["rows"]:]
    index = p.HilbertIndex.build(pts, index_config(p, cfg), device="cpu")
    return cfg, pts, qs, index, p


def test_index_state_is_bit_equal(case):
    cfg, pts, _, index, _ = case
    got = check.index_state(index_fields(index), plain.build_index(pts, cfg))
    assert got == {"quant": 0.0, "codes": 0.0, "forest": 0.0, "master": 0.0}


@pytest.mark.parametrize("k1,k2,h,k", [(32, 24, 2, 10), (16, 40, 1, 5)])
def test_search_answers_are_bit_equal(case, k1, k2, h, k):
    cfg, pts, qs, index, p = case
    params = {"k1": k1, "k2": k2, "h": h, "k": k}
    ids, d = index.search(qs, p.SearchParams(**params))
    rid, rd = reference_search(pts, qs, cfg, params)
    assert torch.equal(ids.long(), rid) and torch.equal(d, rd)


def test_graph_rows_are_bit_equal(case):
    cfg, pts, _, index, p = case
    g = {"n_orders": 4, "k1": 12, "k2": 10, "k": 4, "seed": 1}
    ids, d = index.knn_graph(p.GraphParams(**g))
    rows = torch.arange(0, cfg["rows"], 3)
    rid, rd = plain.graph_rows(pts, rows, cfg, g)
    assert torch.equal(ids[rows].long(), rid) and torch.equal(d[rows], rd)


def test_packing_matches_the_programs_layout():
    from repro_torch.core.quantize import pack_codes
    from repro_torch.kernels.bitpack import pack_bits_ref

    rng = np.random.default_rng(0)
    bits = torch.as_tensor(rng.integers(0, 2, (50, 70)).astype(np.uint8))
    codes = torch.as_tensor(rng.integers(0, 16, (50, 21)).astype(np.uint8))
    assert torch.equal(plain.pack_rows(bits), pack_bits_ref(bits))
    assert torch.equal(plain.pack_nibbles(codes), pack_codes(codes))


def test_hamming_by_table_lookup():
    table = plain._popcount_table("cpu")
    a = torch.tensor([[-1, 0, 0x0F0F0F0F]], dtype=torch.int32)
    b = torch.tensor([[0, 0, 0]], dtype=torch.int32)
    assert int(plain.hamming(a, b, table)) == 32 + 0 + 16
