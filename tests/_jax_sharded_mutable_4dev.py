"""The JAX package's ShardedMutableHilbertIndex on 4 virtual CPU devices.

Run as ``python tests/_jax_sharded_mutable_4dev.py OUT_DIR`` (it sets its
own ``XLA_FLAGS``).  The port's tests call :func:`reference`, which runs
it once per pytest run in a subprocess, so the pytest processes keep
their one-device view, and import :func:`run_script` from it to drive the
port through the same operations.

Under jax 0.9.0 three host-side reads that ``repro.index.sharded_mutable``
makes index a ``P('data')``-sharded array by shard and raise
``ShardingTypeError``: ``_owned_rows`` (``seg.points[s]``, reached by every
tier merge and by ``compact()``), and ``_seg_shard_uid``
(``seg.stack.codes[s]``) and ``shard_index_from_stack`` (``stack.orders[s]``
and the other leaves), both reached by every ``save()``.  Inside this
process only, the three are replaced by versions that copy the whole array
to the host first and then take shard ``s``: the same values, with no
sharded indexing.  Nothing in ``src/repro`` changes.

``OUT_DIR`` receives:

* ``ref.npz``: after each stage of :func:`run_script`, the index's state
  (``<stage>/...``, see :func:`state_arrays`) and its searches under the
  tree merge, the gather merge and the pruned tree (``<stage>/search/*``);
  the keys of ``memory_report()``; ``repro.obs.recall.live_points`` of the
  sharded-mutable index after stage ``stream`` (``lp_mut_*``) and of a
  static 4-shard ``ShardedHilbertIndex`` over the first ``BASE`` rows
  (``lp_static_*``);
* ``bundle/``: a format-4 bundle ``repro`` saved after stage ``delete``.
"""

import json
import os
import shutil
import sys

import numpy as np

N, D, Q = 2048, 24, 16
FOREST = dict(n_trees=4, bits=4, key_bits=96, leaf_size=16, seed=0)
SEAL_POW2 = True
SHARDS = 4
BUFFER = 64  # write-buffer rows a shard
MAX_SEGMENTS = 2
# k2 * (2h + 1) = 96 candidates a generation: a 5 % delete leaves every
# generation inside its pool; emptying most of one shard of the base does not.
SEARCH = dict(k1=32, k2=32, h=1, k=10)
MERGES = (("tree", False), ("gather", False), ("tree", True))
BASE = 1024  # rows of the initial build
INSERT_BATCH = 128
STAGES = ("build", "insert", "delete", "rewrite", "stream", "compact")
STACK_FIELDS = ("orders", "directories", "lo", "hi", "sketches", "codes",
                "master_order", "master_rank", "id_map")
WORD_FIELDS = ("directories", "sketches", "codes")


def host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def buffered_ids(idx) -> np.ndarray:
    """Every occupied buffer slot's external id, shard by shard."""
    return np.concatenate([idx._buf_ids[s, : int(idx._buf_count[s])]
                           for s in range(idx.n_shards)])


def state_arrays(idx) -> dict:
    """The integer and float state of either package's index as numpy
    arrays (copies); packed words as uint32, as the JAX package holds them."""
    out = {
        "next_id": np.asarray(idx._lsm.next_id, np.int64),
        "gen": np.asarray(idx._gen, np.int64),
        "rr": np.asarray(idx._rr, np.int64),
        "alive": idx._lsm.alive,
        "buf_pts": idx._buf_pts,
        "buf_ids": idx._buf_ids,
        "buf_count": np.asarray(idx._buf_count, np.int64),
        "n_segments": np.asarray(len(idx.segments), np.int64),
        "has_bounds": np.asarray(idx._bounds is not None),
    }
    if idx._bounds is not None:
        out["bounds"] = host(idx._bounds).view(np.uint32)
        out["route_lo"] = host(idx._route_lo)
        out["route_hi"] = host(idx._route_hi)
    if idx._perms is not None:
        out["perms"] = host(idx._perms)
        out["flips"] = host(idx._flips)
    for i, seg in enumerate(idx.segments):
        p = f"seg{i}/"
        for field in STACK_FIELDS:
            a = host(getattr(seg.stack, field))
            out[p + field] = a.view(np.uint32) if field in WORD_FIELDS else a
        if seg.points is not None:
            out[p + "points"] = host(seg.points)
        out[p + "boundaries"] = host(seg.quant.boundaries)
        out[p + "centroids"] = host(seg.quant.centroids)
        out[p + "gen"] = np.asarray(seg.gen, np.int64)
        out[p + "n_valid"] = np.asarray(seg.n_valid, np.int64)
        out[p + "pad_max"] = np.asarray(seg.pad_max, np.int64)
        out[p + "ids_host"] = np.asarray(seg.ids_host)
    # copies: the buffers and the alive mask change in place later on
    return {k: np.array(v) for k, v in out.items()}


def run_script(build, data, on_stage) -> None:
    """One op sequence on either package; ``build(rows)`` makes the index
    and ``on_stage(name, index)`` runs after each stage of ``STAGES``.

    build over ``BASE`` rows; inserts that seal several generations and
    tier-merge; deletes of every 5th id and of half the buffered rows;
    a delete that empties most of shard 0 of the base (the next search
    rewrites it); a bulk load onto the live index and more inserts;
    ``compact()``.
    """
    idx = build(data[:BASE])
    on_stage("build", idx)
    for s in range(BASE, BASE + 512, INSERT_BATCH):
        idx.insert(data[s : s + INSERT_BATCH])
    on_stage("insert", idx)
    idx.delete(np.concatenate([np.arange(0, BASE + 512, 5), buffered_ids(idx)[::2]]))
    on_stage("delete", idx)
    base = idx.segments[0]
    idx.delete(base.ids_host[0, : int(base.n_valid[0]) - 8])
    on_stage("rewrite", idx)
    idx.bulk_load(data[BASE + 512 : BASE + 768])
    for s in range(BASE + 768, N, INSERT_BATCH):
        idx.insert(data[s : s + INSERT_BATCH])
    on_stage("stream", idx)
    idx.compact()
    on_stage("compact", idx)


def main(out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses
    import hashlib

    import jax
    import jax.numpy as jnp

    from repro.core.forest import HilbertForest
    from repro.data import ann_datasets
    from repro.index import HilbertIndex
    from repro.index import (ForestConfig, IndexConfig, SearchParams,
                             ShardedHilbertIndex)
    from repro.index import sharded_mutable as sm
    from repro.launch.mesh import data_mesh
    from repro.obs.recall import live_points

    def owned_rows(self, seg, s):
        if seg.points is None:
            raise ValueError("cannot re-sort a generation built without stored points")
        nv = int(seg.n_valid[s])
        return seg.ids_host[s, :nv], np.asarray(jax.device_get(seg.points))[s][:nv]

    def seg_shard_uid(seg, s):
        h = hashlib.sha1()
        h.update(np.int64(seg.gen).tobytes())
        codes = np.asarray(jax.device_get(seg.stack.codes))[s]
        h.update(np.asarray(seg.ids_host[s].shape + codes.shape, np.int64).tobytes())
        h.update(seg.ids_host[s].tobytes())
        h.update(codes.tobytes())
        return h.hexdigest()

    def shard_index_from_stack(config, stack, points, quant, perms, flips, s):
        def shard(x):
            return jnp.asarray(np.asarray(jax.device_get(x))[s])

        return HilbertIndex(
            config=dataclasses.replace(config, shards=None),
            forest=HilbertForest(perms=perms, flips=flips, orders=shard(stack.orders),
                                 directories=shard(stack.directories),
                                 lo=shard(stack.lo), hi=shard(stack.hi)),
            quant=quant, codes_master=shard(stack.codes),
            sketches_master=shard(stack.sketches),
            master_order=shard(stack.master_order),
            master_rank=shard(stack.master_rank),
            points=None if points is None else shard(points))

    sm.ShardedMutableHilbertIndex._owned_rows = owned_rows
    sm._seg_shard_uid = seg_shard_uid
    sm.shard_index_from_stack = shard_index_from_stack

    assert len(jax.devices()) == SHARDS, jax.devices()
    mesh = data_mesh(SHARDS)
    data, queries = ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8,
                                                              seed=0)
    cfg = IndexConfig(forest=ForestConfig(**FOREST), seal_pow2=SEAL_POW2)
    sp = SearchParams(**SEARCH)
    out = {}

    def on_stage(name, idx):
        for merge, prune in MERGES:
            ids, d2 = idx.search(jnp.asarray(queries), sp, merge=merge, prune=prune)
            tag = f"{name}/search/{merge}{'_prune' if prune else ''}"
            out[tag + "/ids"], out[tag + "/d2"] = np.asarray(ids), np.asarray(d2)
        for k, v in state_arrays(idx).items():
            out[f"{name}/{k}"] = v
        if name == "delete":
            idx.save(os.path.join(out_dir, "bundle"))
        if name == "stream":
            out["lp_mut_ids"], out["lp_mut_pts"] = live_points(idx)
            out["report_keys"] = np.asarray(json.dumps(sorted(idx.memory_report())))

    run_script(lambda rows: sm.ShardedMutableHilbertIndex.build(
        jnp.asarray(rows), cfg, mesh=mesh, buffer_capacity=BUFFER,
        max_segments=MAX_SEGMENTS), data, on_stage)
    static = ShardedHilbertIndex.build(jnp.asarray(data[:BASE]), cfg, mesh=mesh)
    out["lp_static_ids"], out["lp_static_pts"] = live_points(static)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])


SUBPROCESS_TIMEOUT_S = 240


def reference(tmp_path_factory) -> str:
    """The directory of this pytest run's ``ref.npz`` and ``bundle/``.

    The script runs once per pytest run: under xdist every worker shares
    the run's base temp directory, and a lock file serializes the first
    call.  Its own time limit is ``SUBPROCESS_TIMEOUT_S``.
    """
    import fcntl
    import subprocess

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = os.path.join(str(root), "jax_sharded_mutable_4dev")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(out, "ref.npz")):
            shutil.rmtree(out, ignore_errors=True)
            os.makedirs(out)
            env = dict(os.environ)
            src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "src")
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            env["JAX_PLATFORMS"] = "cpu"
            r = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                               capture_output=True, text=True,
                               timeout=SUBPROCESS_TIMEOUT_S, env=env)
            if r.returncode != 0:
                raise RuntimeError(f"{__file__} failed:\n{r.stderr[-4000:]}")
    return out
