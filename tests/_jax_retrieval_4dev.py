"""The JAX package's sharded RetrievalStore on 4 virtual CPU devices.

Run as ``python tests/_jax_retrieval_4dev.py DIR`` (it sets its own
``XLA_FLAGS``); ``tests/test_torch_retrieval.py`` runs it once per module
in a subprocess, after writing the port's bundles into ``DIR``, and
drives the port through the same :func:`store_script`.  It patches
``repro``'s three sharded host reads as ``_jax_sharded_mutable_4dev.py``
does (``patch_repro_host_reads``).

``DIR`` receives ``ref.npz``: after each stage of :func:`store_script`,
the backing index's state (``<stage>/...``, the keys of
``state_arrays`` plus ``values``) and its lookups and their values
(``<stage>/lookup/*``); the same for the port's bundles loaded onto 4
devices (``v4_port/...``, ``v3_port/...``); and ``v4_jax/``, the store
``repro`` saved after stage ``delete``.
"""

import os
import sys

import numpy as np

SHARDS = 4
BASE = 1000
BUFFER = 64
STAGES = ("build", "append", "delete", "compact")
SUBPROCESS_TIMEOUT_S = 240


def base_values() -> np.ndarray:
    return (np.arange(BASE, dtype=np.int32) % 31)


def store_script(build, data, on_stage) -> None:
    """One op sequence on either package's store: ``build(keys, values)``
    makes it, ``on_stage(name, store)`` runs after each stage of
    ``STAGES``.  Appends route into the shards' buffers and seal a
    generation; deletes reach sealed and buffered rows."""
    store = build(data[:BASE], base_values())
    on_stage("build", store)
    store.append(data[BASE : BASE + 300], np.arange(300, dtype=np.int32) % 13)
    on_stage("append", store)
    store.delete(np.arange(0, BASE + 300, 7))
    on_stage("delete", store)
    store.compact()
    on_stage("compact", store)


def store_state(store, state_arrays) -> dict:
    impl = store._impl
    return dict(state_arrays(impl), values=np.array(impl._lsm.values))


def main(out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _jax_sharded_mutable_4dev import patch_repro_host_reads, state_arrays

    patch_repro_host_reads()
    import jax
    import jax.numpy as jnp

    from repro.core.types import ForestConfig, SearchParams
    from repro.data import ann_datasets
    from repro.index import IndexConfig
    from repro.launch.mesh import data_mesh
    from repro.serve.retrieval import RetrievalStore
    from _torch_parity import D, FOREST, N, Q, SPD

    assert len(jax.devices()) == SHARDS, jax.devices()
    mesh = data_mesh(SHARDS)
    data, queries = ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8,
                                                              seed=0)
    cfg = IndexConfig(forest=ForestConfig(**FOREST), query_chunk=16)
    sp = SearchParams(**SPD)
    out = {}

    def record(name, store):
        ids, d2 = store.lookup(jnp.asarray(queries), sp)
        out[name + "/lookup/ids"], out[name + "/lookup/d2"] = np.asarray(ids), np.asarray(d2)
        out[name + "/lookup/values"] = np.asarray(store.values_at(ids, fill=-1))
        for k, v in store_state(store, state_arrays).items():
            out[f"{name}/{k}"] = v

    def on_stage(name, store):
        assert store.is_sharded
        record(name, store)
        if name == "delete":
            store.save(os.path.join(out_dir, "v4_jax"))

    store_script(lambda keys, vals: RetrievalStore.build(
        jnp.asarray(keys), jnp.asarray(vals), cfg, mesh=mesh, buffer_capacity=BUFFER),
        data, on_stage)
    for name in ("v4_port", "v3_port"):
        store = RetrievalStore.load(os.path.join(out_dir, name), mesh=mesh)
        assert store.is_sharded
        record(name, store)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)


def run(out_dir: str) -> None:
    """Run :func:`main` in a subprocess with ``src`` on its path."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), out_dir],
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
                       env=env)
    if r.returncode != 0:
        raise RuntimeError(f"{__file__} failed:\n{r.stderr[-4000:]}")


if __name__ == "__main__":
    main(sys.argv[1])
