"""Port parity: the WAL, the fault points and the corruption-aware bundles.

``repro_torch.checkpoint.wal``, ``repro_torch.testing.faults`` and
``repro_torch.checkpoint.bundle`` against ``repro``'s modules on the same
inputs, made from a numpy seed:

* a WAL written by either package is byte-identical to the other's and
  reads back in both, record for record;
* a bit flip is rejected, and a torn tail is truncated with ``seq``
  continuing, in both packages;
* fault plans parse to the same dict and ``raise`` points fire at the same
  hit;
* a bit-flipped checkpoint step is detected, quarantined and skipped.
"""

import os

import numpy as np
import pytest

from repro import checkpoint as jckpt
from repro.checkpoint import wal as jwal
from repro.testing import faults as jfaults
from repro_torch.checkpoint import bundle as tckpt
from repro_torch.checkpoint import wal as twal
from repro_torch.testing import faults as tfaults

WAL = {"jax": jwal, "torch": twal}


@pytest.fixture(autouse=True)
def _no_fault_plan():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _records(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(5, 8)).astype(np.float32)
    vals = rng.integers(0, 100, size=(5,)).astype(np.int32)
    return [
        ("insert", {"points": pts, "values": vals}, {"next_id": 0}),
        ("delete", {"ids": np.arange(3, dtype=np.int32)}, {"next_id": 5}),
        ("bulk_load", {"points": pts[:2]}, {"next_id": 5}),
    ]


def _write(mod, path, records, **cfg):
    w = mod.WriteAheadLog(path, mod.WalConfig(**cfg))
    seqs = [w.append(*rec) for rec in records]
    w.close()
    return seqs


def _flip(path, pos, mask=0x01):
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ mask]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_written_by_either_package_reads_back_in_both(tmp_path, writer):
    recs = _records()
    path = str(tmp_path / "wal.log")
    seqs = _write(WAL[writer], path, recs, sync_every=2)
    other = str(tmp_path / "other.log")
    _write(WAL["torch" if writer == "jax" else "jax"], other, recs, sync_every=2)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    for reader in WAL.values():
        got, end, torn = reader.read_records(path)
        assert not torn and end == os.path.getsize(path)
        assert [r.seq for r in got] == seqs == [0, 1, 2]
        for r, (op, arrays, meta) in zip(got, recs):
            assert r.op == op and r.meta == meta and sorted(r.arrays) == sorted(arrays)
            for k, v in arrays.items():
                assert r.arrays[k].dtype == v.dtype
                assert r.arrays[k].tobytes() == v.tobytes()
    assert twal.WalConfig() == twal.WalConfig(sync_every=32, sync_interval_ms=50.0)


@pytest.mark.parametrize("reader", ["jax", "torch"])
@pytest.mark.parametrize("frac", [0.1, 0.3, 0.5, 0.9])
def test_wal_bitflip_rejected_at_fixed_positions(tmp_path, reader, frac):
    path = str(tmp_path / "wal.log")
    _write(twal, path, _records()[:1])
    size = os.path.getsize(path)
    _flip(path, max(8, min(size - 1, int(frac * size))))  # past the magic
    records, end, torn = WAL[reader].read_records(path)
    assert records == [] and torn and end == 8


@pytest.mark.parametrize("writer,recoverer", [("jax", "torch"), ("torch", "jax"),
                                              ("torch", "torch")])
def test_wal_torn_tail_truncated_and_seq_continues(tmp_path, writer, recoverer):
    path = str(tmp_path / "wal.log")
    recs = _records(1)[:2]
    _write(WAL[writer], path, recs)
    good = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"\xff\x00\x00\x00torn-partial-frame")
    records, wal = WAL[recoverer].open_and_recover(path)
    assert [r.seq for r in records] == [0, 1]
    assert os.path.getsize(path) == good
    s = wal.append("delete", {"ids": np.zeros(1, np.int32)}, {"next_id": 6})
    wal.close()
    assert s == 2
    for mod in WAL.values():
        assert [r.seq for r in mod.read_records(path)[0]] == [0, 1, 2]


@pytest.mark.parametrize("spec", [
    "a.b@3=kill; c.d=raise;e.f=torn:7;g=bitflip",
    "wal.append.post_write@2=raise",
    "x=explode",
])
def test_fault_plans_parse_alike_and_raise_at_the_same_hit(tmp_path, spec):
    try:
        want = jfaults.parse_plan(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tfaults.parse_plan(spec)
        return
    assert tfaults.parse_plan(spec) == want
    raising = {k: v for k, v in want.items() if v[1] == "raise"}
    for name, (hit, _) in raising.items():
        fired = {}
        for pkg, mod in (("jax", jfaults), ("torch", tfaults)):
            trace = str(tmp_path / f"{pkg}.trace")
            mod.install_plan({name: (hit, "raise")}, trace_path=trace)
            for i in range(1, hit + 2):
                try:
                    mod.fault_point(name)
                except mod.FaultInjected as e:
                    assert e.point == name
                    fired[pkg] = i
            assert mod.registered_points() == {name: hit + 1}
            mod.reset()
            mod.fault_point(name)  # disarmed: no-op
            assert mod.registered_points() == {}
            with open(trace) as f:
                assert f.read().splitlines() == [name] * (hit + 1)
        assert fired == {"jax": hit, "torch": hit}


def test_wal_fault_points_sit_at_the_same_sites(tmp_path):
    seen = {}
    for pkg, mod, fmod in (("jax", jwal, jfaults), ("torch", twal, tfaults)):
        trace = str(tmp_path / f"{pkg}.trace")
        fmod.install_plan(None, trace_path=trace)
        w = mod.WriteAheadLog(str(tmp_path / f"{pkg}.log"), mod.WalConfig(sync_every=1))
        w.append(*_records()[0])
        w.truncate()
        w.close()
        fmod.reset()
        with open(trace) as f:
            seen[pkg] = f.read().splitlines()
    assert seen["torch"] == seen["jax"] == [
        "wal.append.pre_write", "wal.append.post_write", "wal.fsync.pre",
        "wal.truncate.pre", "wal.truncate.post"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_bitflip_detected_quarantined_fallback(tmp_path, writer):
    ckpt = str(tmp_path / "bundle")
    tree = {"w": np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)}
    for step in (0, 1):
        if writer == "jax":
            jckpt.save(ckpt, step=step, tree=tree, extra={})
        else:
            tckpt.save(ckpt, step, tree, extra={})
    assert tckpt.verify_step(ckpt, 1) == [] == jckpt.verify_step(ckpt, 1)
    npz = os.path.join(ckpt, "step_00000001", "host0.npz")
    _flip(npz, os.path.getsize(npz) // 2, 0x04)
    assert tckpt.verify_step(ckpt, 1) and jckpt.verify_step(ckpt, 1)
    with pytest.raises(tckpt.CorruptBundleError) as err:
        tckpt.restore(ckpt, 1, ["w"])
    assert err.value.quarantined.endswith("step_00000001.quarantine")
    assert tckpt.latest_step(ckpt) == 0 == tckpt.latest_verifiable_step(ckpt)
    assert os.path.isdir(os.path.join(ckpt, "step_00000001.quarantine"))
    restored, _ = tckpt.restore(ckpt, 0, ["w"])
    np.testing.assert_array_equal(restored["w"], tree["w"])
    jrestored, _ = jckpt.restore(ckpt, 0, tree)
    np.testing.assert_array_equal(np.asarray(jrestored["w"]), tree["w"])


def test_checkpoint_fault_points_sit_at_the_same_sites(tmp_path):
    seen = {}
    tree = {"w": np.zeros((3, 2), np.float32)}
    for pkg, fmod in (("jax", jfaults), ("torch", tfaults)):
        trace = str(tmp_path / f"{pkg}.trace")
        fmod.install_plan(None, trace_path=trace)
        d = str(tmp_path / pkg)
        if pkg == "jax":
            jckpt.save(d, step=0, tree=tree)
            jckpt.atomic_write_json(os.path.join(d, "m.json"), {"a": 1})
        else:
            tckpt.save(d, 0, tree)
            tckpt.atomic_write_json(os.path.join(d, "m.json"), {"a": 1})
        fmod.reset()
        with open(trace) as f:
            seen[pkg] = f.read().splitlines()
    assert seen["torch"] == seen["jax"] == [
        "ckpt.npz.post_write", "ckpt.manifest.pre_rename",
        "ckpt.manifest.post_rename", "ckpt.json.pre_rename", "ckpt.json.post_rename"]
