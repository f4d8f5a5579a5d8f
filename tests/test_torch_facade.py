"""Port parity: the ``HilbertIndex`` facade of repro_torch against repro's.

* A port build is bit-equal to the JAX build, array for array.
* Search on an index carried across from JAX (``index_from_arrays``) meets
  the repo's distance contract against JAX ``search`` with
  ``backend="xla"`` and ``backend="pallas"`` (interpret mode on CPU).
* A bundle saved by either package loads in the other.
* The port imports no jax and never falls back to the CPU on its own.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import ForestConfig as JForestConfig
from repro.core.types import SearchParams as JSearchParams
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro_torch.checkpoint import bundle
from repro_torch.data import ann_datasets as tdata
from repro_torch.index import (ForestConfig, HilbertIndex, IndexConfig,
                               SearchParams, build_with_timings,
                               index_from_arrays, load_index_bundle)
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
_FOREST = dict(n_trees=4, bits=4, key_bits=128, leaf_size=16, seed=0)
_PARAMS = dict(k1=16, k2=64, h=1, k=8)


def _jax_arrays(jidx):
    return {k: np.asarray(v) for k, v in jidx._array_bundle().items()}


def _assert_same_arrays(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _assert_results_match(jres, tres):
    (jids, jd), (tids, td) = jres, tres
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids.numpy(), jd)


@pytest.fixture(scope="module")
def dataset():
    return tdata.lowrank_dataset_with_queries(3000, 37, 64, n_clusters=8, r=4, seed=0)


@pytest.fixture(scope="module")
def jax_index(dataset):
    return JIndex.build(jnp.asarray(dataset[0]), JIndexConfig(
        forest=JForestConfig(**_FOREST), query_chunk=16))


@pytest.mark.parametrize("d,key_bits,store_points", [(64, 128, True), (384, 448, False)])
def test_build_bit_equal_to_jax(d, key_bits, store_points):
    data, _ = tdata.lowrank_dataset_with_queries(3000, 1, d, n_clusters=8, r=4, seed=1)
    forest = dict(_FOREST, key_bits=key_bits)
    jidx = JIndex.build(jnp.asarray(data), JIndexConfig(
        forest=JForestConfig(**forest), store_points=store_points))
    tidx, timings = build_with_timings(
        data, IndexConfig(forest=ForestConfig(**forest), store_points=store_points),
        device="cpu")
    assert set(timings) == {"quantization", "sketches", "forest", "master_sort"}
    _assert_same_arrays(_jax_arrays(jidx), tidx.array_bundle())
    assert tidx.memory_report() == jidx.memory_report()
    assert tidx.device == torch.device("cpu") and tidx.dim == d


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_search_on_carried_index_matches_jax(dataset, jax_index, backend):
    _, queries = dataset
    tidx = index_from_arrays(_jax_arrays(jax_index), jax_index.config.to_dict(),
                             device="cpu")
    assert tidx.config.query_chunk == 16
    # 37 queries in chunks of 16: the last chunk (5) pads to a bucket of 8.
    jres = jax_index.search(jnp.asarray(queries), JSearchParams(**_PARAMS),
                            backend=backend)
    for tb in ("kernel", "ref"):
        tres = tidx.search(queries, SearchParams(**_PARAMS), backend=tb)
        assert tres[0].dtype == torch.int32 and tres[1].dtype == torch.float32
        assert tres[0].shape == (37, 8)
        _assert_results_match(jres, tres)


def test_search_of_own_build_matches_jax(dataset, jax_index):
    data, queries = dataset
    tidx = HilbertIndex.build(data, IndexConfig(forest=ForestConfig(**_FOREST)),
                              device="cpu")
    jres = jax_index.search(jnp.asarray(queries[:19]), JSearchParams(**_PARAMS),
                            backend="xla", query_chunk=2048)
    _assert_results_match(jres, tidx.search(queries[:19], SearchParams(**_PARAMS)))


def test_empty_batch_and_k_beyond_pool(dataset):
    data, queries = dataset
    cfg = IndexConfig(forest=ForestConfig(n_trees=2, bits=4, key_bits=16,
                                          leaf_size=2), store_points=False)
    tiny = HilbertIndex.build(data[:5], cfg, device="cpu")
    ids, d2 = tiny.search(np.zeros((0, 64), np.float32), SearchParams(k=4))
    assert ids.shape == (0, 4) and ids.dtype == torch.int32
    assert d2.shape == (0, 4) and d2.dtype == torch.float32

    # pool = k2 * min(2h+1, n) = 2 < k = 4: tail is id -1 / +inf, as in JAX.
    p = dict(k1=2, k2=2, h=0, k=4)
    jtiny = JIndex.build(jnp.asarray(data[:5]), JIndexConfig(
        forest=JForestConfig(n_trees=2, bits=4, key_bits=16, leaf_size=2),
        store_points=False))
    jids, jd = jtiny.search(jnp.asarray(queries[:3]), JSearchParams(**p), backend="xla")
    tids, td = tiny.search(queries[:3], SearchParams(**p))
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    assert (tids[:, 2:] == -1).all() and torch.isinf(td[:, 2:]).all()
    with pytest.raises(ValueError, match="backend"):
        tiny.search(queries[:3], SearchParams(**p), backend="pallas")


def test_bundles_cross_load_both_ways(tmp_path, dataset, jax_index):
    _, queries = dataset
    params = SearchParams(**_PARAMS)
    # JAX saves, the port loads.
    jpath = str(tmp_path / "jax_saved")
    jax_index.save(jpath)
    tidx = HilbertIndex.load(jpath, device="cpu")
    _assert_same_arrays(_jax_arrays(jax_index), tidx.array_bundle())
    assert tidx.config == IndexConfig.from_dict(jax_index.config.to_dict())

    # The port saves (twice: one step of grace is kept), JAX loads.
    tpath = str(tmp_path / "torch_saved")
    tidx.save(tpath)
    final = tidx.save(tpath)
    assert final.endswith("step_00000001") and bundle.latest_step(tpath) == 1
    jback = JIndex.load(tpath)
    _assert_same_arrays(_jax_arrays(jax_index), _jax_arrays(jback))
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(jpath, "step_00000000", "manifest.json")) as f:
        jmanifest = json.load(f)
    assert manifest["leaves"] == jmanifest["leaves"]
    assert manifest["digests"] == jmanifest["digests"]
    assert manifest["extra"] == jmanifest["extra"]

    jres = jback.search(jnp.asarray(queries), JSearchParams(**_PARAMS), backend="xla")
    tres = load_index_bundle(tpath, device="cpu")[0].search(queries, params)
    _assert_results_match(jres, tres)


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_bitflipped_newest_step_is_quarantined_in_both_packages(tmp_path, jax_index,
                                                                saver):
    """One flipped byte in the newest ``host0.npz``: each package moves that
    step aside as ``.quarantine`` and loads step 0 (``BadZipFile`` from a lazy
    read used to escape the port's load)."""
    import shutil

    src = str(tmp_path / "saved")
    index = (jax_index if saver == "jax" else
             index_from_arrays(_jax_arrays(jax_index), jax_index.config.to_dict(),
                               device="cpu"))
    index.save(src)
    index.save(src)
    npz = os.path.join(src, "step_00000001", "host0.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x10]))
    jpath, tpath = str(tmp_path / "for_jax"), str(tmp_path / "for_torch")
    shutil.copytree(src, jpath)
    shutil.copytree(src, tpath)
    jloaded = JIndex.load(jpath)
    tloaded = HilbertIndex.load(tpath, device="cpu")
    for path in (jpath, tpath):
        assert sorted(os.listdir(path)) == ["step_00000000",
                                            "step_00000001.quarantine"]
    _assert_same_arrays(_jax_arrays(jax_index), _jax_arrays(jloaded))
    _assert_same_arrays(_jax_arrays(jax_index), tloaded.array_bundle())


def test_v1_bundle_is_repacked_and_digests_are_checked(tmp_path, dataset, jax_index):
    tidx = index_from_arrays(_jax_arrays(jax_index), jax_index.config.to_dict(),
                             device="cpu")
    arrays = tidx.array_bundle()
    from repro_torch.core import quantize
    arrays["codes_master"] = quantize.unpack_codes(tidx.codes_master, tidx.dim).numpy()
    extra = {"kind": "hilbert_index", "format_version": 1,
             "config": tidx.config.to_dict(), "has_points": True}
    path = str(tmp_path / "v1")
    final = bundle.save(path, 0, arrays, extra)
    loaded = HilbertIndex.load(path, device="cpu")
    _assert_same_arrays(tidx.array_bundle(), loaded.array_bundle())

    # A flipped digest is refused, never loaded silently.
    mpath = os.path.join(final, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["digests"]["['master_rank']"][0] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(bundle.CorruptBundleError, match="master_rank"):
        HilbertIndex.load(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        HilbertIndex.load(str(tmp_path / "nothing"), device="cpu")


def test_entry_points_raise_without_gpu_unless_cpu_is_asked(monkeypatch, dataset,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, _ = dataset
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HilbertIndex.build(data[:100])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_with_timings(data[:100])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HilbertIndex.load(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_arrays({}, {})


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.index import HilbertIndex, IndexConfig, ForestConfig, SearchParams\n"
        "from repro_torch.data import ann_datasets\n"
        "import repro_torch.kernels._build, repro_torch.checkpoint.bundle\n"
        "x = ann_datasets.lowrank_embeddings(500, 16, n_clusters=4, r=3)\n"
        "cfg = IndexConfig(forest=ForestConfig(n_trees=2, key_bits=32, leaf_size=8))\n"
        "idx = HilbertIndex.build(x, cfg, device='cpu')\n"
        "ids, d = idx.search(x[:5], SearchParams(k1=8, k2=16, h=1, k=3))\n"
        "assert ids.shape == (5, 3)\n"
        "from repro_torch.index import GraphParams\n"
        "from repro_torch.configs import gooaq\n"
        "from repro_torch.core import knn_graph, search\n"
        "g, _ = idx.knn_graph(GraphParams(n_orders=2, k1=8, k2=8, k=3))\n"
        "assert g.shape == (500, 3) and gooaq.TABLE2[0].k == 15\n"
        "from repro_torch.index import MutableHilbertIndex\n"
        "import repro_torch.testing, repro_torch.checkpoint.wal\n"
        "m = MutableHilbertIndex(cfg, buffer_capacity=64, device='cpu')\n"
        "m.insert(x[:100]); m.delete([3])\n"
        "assert m.search(x[:5], SearchParams(k1=8, k2=16, h=1, k=3))[0].shape == (5, 3)\n"
        "import repro_torch.obs, repro_torch.serve, repro_torch.serve.compactor\n"
        "from repro_torch.serve import RetrievalEngine\n"
        "eng = RetrievalEngine(m, SearchParams(k1=8, k2=16, h=1, k=3))\n"
        "assert eng.search(x[:5])[0].shape == (5, 3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
