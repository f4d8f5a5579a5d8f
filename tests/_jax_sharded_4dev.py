"""The JAX package's sharded code on 4 virtual CPU devices, results to an npz.

Run as ``python tests/_jax_sharded_4dev.py OUT.npz`` (it sets its own
``XLA_FLAGS``); ``tests/test_torch_sharded.py`` runs it in a subprocess so
the pytest process keeps its one-device view, then holds the port's
4-shard counterparts to what it saves:

* ``ShardedHilbertIndex.build`` over 4 shards and ``search`` with the tree
  and gather merges (``s_*``), and the keys of ``memory_report``;
* one Hilbert order of the sharded Task 2: ``distributed_hilbert_order``
  (``o_*``), ``halo_window_candidates`` (``h_*``), ``route_home``
  (``r_*``) and ``_merge_sharded`` from an empty top-k2 (``m_*``).
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.core import distributed, quantize, sketch  # noqa: E402
from repro.data import ann_datasets  # noqa: E402
from repro.index import (ForestConfig, IndexConfig, SearchParams,  # noqa: E402
                         ShardedHilbertIndex)
from repro.launch.mesh import data_mesh  # noqa: E402

N, D, Q = 2048, 24, 16
FOREST = dict(n_trees=2, bits=4, key_bits=96, leaf_size=16, seed=0)
SEARCH = dict(k1=64, k2=128, h=2, k=10)
GRAPH_K1, GRAPH_K2, GRAPH_SEED = 16, 32, 0


def main(out_path: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    mesh = data_mesh(4)
    data, queries = ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8,
                                                              seed=0)
    cfg = IndexConfig(forest=ForestConfig(**FOREST))
    out = {}

    idx = ShardedHilbertIndex.build(jnp.asarray(data), cfg, mesh=mesh)
    sp = SearchParams(**SEARCH)
    for merge in ("tree", "gather"):
        ids, d2 = idx.search(jnp.asarray(queries), sp, merge=merge)
        out[f"s_{merge}_ids"], out[f"s_{merge}_d2"] = np.asarray(ids), np.asarray(d2)
    out["s_n_valid"] = np.asarray(idx.n_valid)
    out["s_id_map"] = np.asarray(idx.stack.id_map)
    out["s_report_keys"] = np.asarray(json.dumps(sorted(idx.memory_report())))

    # One order of the sharded Task 2, as distributed_knn_graph runs it.
    pts = jnp.asarray(data)
    quant = quantize.fit(pts, bits=4)
    sks = sketch.sketches_from_codes(quantize.encode(quant, pts), bits=4)
    lo, hi = jnp.min(pts, axis=0), jnp.max(pts, axis=0)
    rng = np.random.default_rng(GRAPH_SEED)
    perm = jnp.asarray(rng.permutation(D).astype(np.int32))
    flip = jnp.asarray(rng.integers(0, 2, D).astype(bool))
    rows = NamedSharding(mesh, P("data", None))
    keys_o, pay_o, n_valid, ovf = distributed.distributed_hilbert_order(
        jax.device_put(pts, rows), mesh, cfg.forest, lo, hi, perm, flip,
        payload={"sk": jax.device_put(sks, rows)})
    cand_g, cand_d = distributed.halo_window_candidates(
        pay_o["gid"], pay_o["sk"], n_valid, mesh, GRAPH_K1)
    home_c, home_d, ovf2 = distributed.route_home(pay_o["gid"], cand_g, cand_d, mesh, N)
    best_id = np.full((N, GRAPH_K2), -1, np.int32)
    best_d = np.full((N, GRAPH_K2), 2**30, np.int32)
    m_ids, m_d = distributed._merge_sharded(
        jnp.asarray(best_id), jnp.asarray(best_d),
        jnp.asarray(np.asarray(home_c)), jnp.asarray(np.asarray(home_d)), GRAPH_K2)
    for name, v in (("o_keys", keys_o), ("o_gid", pay_o["gid"]), ("o_sk", pay_o["sk"]),
                    ("o_n_valid", n_valid), ("o_overflow", ovf),
                    ("h_cand", cand_g), ("h_dist", cand_d),
                    ("r_cand", home_c), ("r_dist", home_d), ("r_overflow", ovf2),
                    ("m_ids", m_ids), ("m_d", m_d)):
        out[name] = np.asarray(v)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
