"""Port parity: ``repro_torch.launch.{multihost,dryrun,roofline}`` against
``repro.launch``.

* ``resolve_topology`` and ``host_batch_slice`` equal ``repro``'s on the
  environments of ``tests/test_multihost.py`` and a few more;
  ``bootstrap`` with two hosts, and with two processes of one host, on
  localhost gloo (two subprocesses) all-reduces their ranks, and a single
  process leaves ``torch.distributed`` uninitialized;
* ``resolve_rank`` under SLURM with one task a GPU and one task a host,
  and ``rank_batch_slice`` over every rank;
* the dry run's planning (``rules_for``, ``microbatches_for``,
  ``needs_seq_shard``, ``saved_stack_bytes``, ``input_specs``' shapes and
  dtypes) equals ``repro``'s for every arch x shape x mesh at ``repro``'s
  mesh shapes (16, 16) and (2, 16, 16): ``tests/_jax_dryrun_plan.py``
  records ``repro``'s side in its own process;
* the production meshes ((data 32, model 8), (pod 2, data 32, model 8))
  and the dev mesh on fake process groups;
* FLOPs are counted per rank: on 128 fake ranks a sharded matmul chain
  counts 1/128 of what ``FlopCounterMode`` counts above DTensor (the
  global figure);
* one cell end to end on a fake (2, 2) mesh (granite_moe_1b smoke, train
  and decode): status ``ok``, parameter bytes a rank equal to the sum of
  its shards, the train step's FLOPs over the ranks within 10 % of
  6 N_active tokens plus the attention products as the port computes them
  (whole score matrices, masked) and the unembed its chunked loss
  recomputes in the backward pass;
* ``roofline.fmt_row`` on ``ok``, ``skipped`` and ``error`` records, and
  both CLIs on a cell that needs no mesh.
"""

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import multihost as jmultihost
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, multihost, roofline
from repro_torch.launch import shardings as tshardings
from repro_torch.models.config import ATTN
from repro_torch.models.model import layer_specs
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import make_rules
from repro_torch.train import TrainConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_dryrun_plan import reference  # noqa: E402
from test_torch_sharding import TorchStubMesh, cache_path  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ENVS = {
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_STEP_NODELIST": "gpu[003-010]"},
    "slurm_nodelist": {"SLURM_PROCID": "1", "SLURM_NTASKS": "4", "SLURM_NODELIST": "n1",
                       "REPRO_COORD_PORT": "2222"},
    "slurm_plain_list": {"SLURM_PROCID": "0", "SLURM_STEP_NODELIST": "alpha,beta"},
    "slurm_no_list": {"SLURM_PROCID": "2", "SLURM_NTASKS": "3"},
    "gke": {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "t1k-w0,t1k-w1,t1k-w2,t1k-w3"},
    "gke_count": {"TPU_WORKER_ID": "0", "TPU_WORKER_COUNT": "2"},
    "single": {},
}
PLAN_MESHES = {"single": ((16, 16), ("data", "model")),
               "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_resolve_topology_and_batch_slice_match_repro(name):
    env = ENVS[name]
    got, want = multihost.resolve_topology(env=env), jmultihost.resolve_topology(env=env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for batch in (256, 8, 7):
        assert (multihost.host_batch_slice(batch, got)
                == jmultihost.host_batch_slice(batch, want))


def test_manual_topology_and_batch_partition_match_repro():
    kw = dict(coordinator="10.0.0.1:1234", host_id=2, n_hosts=4)
    assert (dataclasses.asdict(multihost.resolve_topology(**kw))
            == dataclasses.asdict(jmultihost.resolve_topology(**kw)))
    covered = []
    for i in range(4):
        env = {"SLURM_PROCID": str(i), "SLURM_NTASKS": "4", "SLURM_NODELIST": "n1"}
        a, b = multihost.host_batch_slice(256, multihost.resolve_topology(env=env))
        covered.extend(range(a, b))
    assert covered == list(range(256))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_PROCESS = """
import sys, torch, torch.distributed as dist
from repro_torch.launch.multihost import bootstrap
coord, host_id, n_hosts, local_rank, gpus = sys.argv[1], *map(int, sys.argv[2:])
topo = bootstrap(coordinator=coord, host_id=host_id, n_hosts=n_hosts, local_rank=local_rank,
                 gpus_per_host=gpus, backend="gloo")
t = torch.tensor([float(dist.get_rank())])
dist.all_reduce(t)
print(topo.source, dist.get_rank(), dist.get_world_size(), float(t))
dist.destroy_process_group()
"""
# (host_id, n_hosts, local_rank, gpus_per_host) of each process
LAYOUTS = {"2_hosts_x_1_process": [(0, 2, 0, 1), (1, 2, 0, 1)],
           "1_host_x_2_processes": [(0, 1, 0, 2), (0, 1, 1, 2)]}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bootstrap_two_hosts_on_localhost_gloo(layout):
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _PROCESS, coord, *map(str, args)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for args in LAYOUTS[layout]]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    assert sorted(outs) == [["manual", "0", "2", "1.0"], ["manual", "1", "2", "1.0"]]


def test_resolve_rank_reads_slurm_task_per_gpu_and_task_per_host():
    RankLayout = multihost.RankLayout
    # srun --ntasks-per-node=8 on 2 nodes: node 1's task 1
    env = {"SLURM_PROCID": "9", "SLURM_NTASKS": "16", "SLURM_NNODES": "2",
           "SLURM_NODEID": "1", "SLURM_LOCALID": "1", "SLURM_STEP_NODELIST": "gpu[003-004]"}
    topo = multihost.resolve_topology(env=env)
    for kw in ({}, {"gpus_per_host": 8}, {"local_rank": 1}):
        assert multihost.resolve_rank(topo, env, **kw) == RankLayout(9, 16, 1)
    with pytest.raises(ValueError, match="gpus_per_host=4.*16 tasks on 2 nodes"):
        multihost.resolve_rank(topo, env, gpus_per_host=4)
    with pytest.raises(ValueError, match="local_rank=3.*SLURM_LOCALID=1"):
        multihost.resolve_rank(topo, env, local_rank=3)
    # one task a host (repro's convention): its gpus_per_host processes
    env = {"SLURM_PROCID": "1", "SLURM_NTASKS": "2", "SLURM_NNODES": "2",
           "SLURM_NODEID": "1", "SLURM_LOCALID": "0", "SLURM_STEP_NODELIST": "gpu[003-004]"}
    topo = multihost.resolve_topology(env=env)
    assert (topo.host_id, topo.n_hosts) == (1, 2)
    assert (multihost.resolve_rank(topo, env, local_rank=3, gpus_per_host=8)
            == RankLayout(1 * 8 + 3, 2 * 8, 3))
    single = multihost.resolve_topology(env={})
    assert multihost.resolve_rank(single, {}) == RankLayout(0, 1, 0)
    assert multihost.resolve_rank(single, {}, 5, 8) == RankLayout(5, 8, 5)
    with pytest.raises(ValueError, match="local_rank=8 outside .0, gpus_per_host=8"):
        multihost.resolve_rank(single, {}, local_rank=8, gpus_per_host=8)
    with pytest.raises(ValueError, match="coordinator's port"):
        multihost.bootstrap(env={}, local_rank=1, gpus_per_host=2, backend="gloo")


def test_rank_batch_slice_covers_the_batch_once():
    for world in (1, 2, 8, 16, 256):
        rows = [i for r in range(world) for i in range(*multihost.rank_batch_slice(256, r, world))]
        assert rows == list(range(256)), world
    topo = multihost.resolve_topology(coordinator="h:1", host_id=3, n_hosts=4)
    assert multihost.rank_batch_slice(256, 3, 4) == multihost.host_batch_slice(256, topo)


def test_bootstrap_single_host_leaves_no_process_group():
    import torch.distributed as dist

    topo = multihost.bootstrap(env={})
    assert (topo.n_hosts, topo.source) == (1, "single")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    return reference(tmp_path_factory)


def _norm(v):
    return list(v) if isinstance(v, tuple) else v


def _port_inputs(cfg, shape):
    """The port's input_specs as {repro key path: [shape, dtype]}."""
    seq, batch, kind = tconfigs.SHAPES[shape]
    specs = dryrun.input_specs(cfg, shape)
    out = {f"['{k}']": [list(v.shape), str(v.dtype).replace("torch.", "")]
           for k, v in specs.items() if k != "caches"}
    caches = {}
    for name, t in tshardings.named_leaves(specs.get("caches", [])):
        assert t.device.type == "meta"
        path, stacked = cache_path(cfg, name[:-1] if name.endswith(".") else name)
        caches[path] = (list(t.shape), str(t.dtype).replace("torch.", ""), stacked)
    return out, caches


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_plan_matches_repro(plan, arch):
    cfg = tconfigs.get_config(arch)
    for shape, (seq, batch, kind) in tconfigs.SHAPES.items():
        inputs, caches = _port_inputs(cfg, shape)
        for mesh_name, (mshape, names) in PLAN_MESHES.items():
            want = plan[f"{arch}|{shape}|{mesh_name}"]
            rules = dryrun.rules_for(cfg, shape, TorchStubMesh(mshape, names))
            got = {f.name: _norm(getattr(rules, f.name)) for f in dataclasses.fields(rules)
                   if f.name != "mesh"}
            assert got == want["rules"], (shape, mesh_name)
            shards = math.prod(mshape[:-1])
            seq_shards = mshape[-1] if rules.seq else 1
            assert dryrun.needs_seq_shard(cfg, seq, batch, mshape[-2]) == want["needs_seq_shard"]
            assert dryrun.saved_stack_bytes(cfg, seq, batch, 1, shards, seq_shards) == \
                want["saved_one"]
            if kind == "train":
                n = dryrun.microbatches_for(cfg, seq, batch, shards, seq_shards)
                assert n == want["microbatches"]
                assert dryrun.saved_stack_bytes(cfg, seq, batch, n, shards, seq_shards) == \
                    want["saved"]
                tcfg = dryrun.train_config(cfg, shape, rules)
                assert tcfg.n_microbatches == n
            plain = {k: v for k, v in want["inputs"].items() if not k.startswith("['caches']")}
            assert inputs == plain
            for k, (wshape, wdtype) in want["inputs"].items():
                if not k.startswith("['caches']"):
                    continue
                keys = tuple(int(p) if p.isdigit() else p
                             for p in k.replace("['caches']", "").replace("]", "")
                             .replace("'", "").replace(".", "[").split("[") if p)
                matches = [v for path, v in caches.items() if path == keys]
                assert matches, k
                gshape, gdtype, stacked = matches[0]
                lead = wshape[1:] if stacked else wshape
                if keys[-1] == "pos":  # (B, L) here, (L,) in repro
                    assert gshape[1:] == lead and gshape[0] == batch, k
                else:
                    assert gshape == lead, k
                assert gdtype == wdtype, k


@pytest.fixture()
def fake_group():
    import torch.distributed as dist

    yield dryrun.fake_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_and_dev_meshes(fake_group):
    from repro_torch.launch import mesh as tmesh

    fake_group((256,), ("world",))
    single = tmesh.make_production_mesh(device_type="cpu")
    assert (tuple(single.shape), single.mesh_dim_names) == ((32, 8), ("data", "model"))
    fake_group((512,), ("world",))
    multi = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert (tuple(multi.shape), multi.mesh_dim_names) == ((2, 32, 8), ("pod", "data", "model"))
    # the model axis is a node's 8 consecutive ranks
    assert multi["model"].mesh.tolist() == list(range(8))
    fake_group((8,), ("world",))
    dev = tmesh.make_dev_mesh(4, device_type="cpu")
    assert (tuple(dev.shape), dev.mesh_dim_names) == ((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_dev_mesh(3, device_type="cpu")


def test_flops_are_counted_per_rank(fake_group):
    """(64, 4096) x (4096, 14336) x (14336, 4096): rows over data 16,
    the hidden dim over model 8.  Above DTensor FlopCounterMode counts the
    global 1.50e10; each rank computes 1/128 of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    mesh = fake_group((16, 8), ("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 4096), mesh, [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.empty(4096, 14336), mesh, [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.empty(14336, 4096), mesh, [Replicate(), Shard(0)])
        glob = FlopCounterMode(display=False)
        cost = dryrun.RankCost(mesh)
        with dryrun._own_propagation_fake_mode(), glob:
            (x @ w1) @ w2
        with dryrun._own_propagation_fake_mode(), cost:
            ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
    total = 2 * 2 * 64 * 4096 * 14336
    assert glob.get_total_flops() == total
    assert cost.flops * 128 == total
    # the partial sums' all-reduce over the model axis: 4 rows x 4096 fp32
    assert cost.by_axis == {"model": 4 * 4096 * 4}


def _smoke_cell(fake_group, kind):
    cfg = dataclasses.replace(tconfigs.get_config("granite_moe_1b", smoke=True),
                              compute_dtype="float32", remat_policy="none",
                              capacity_factor=1.0)
    rules = make_rules(fake_group((2, 2), ("data", "model")))
    seq, batch = 32, 4
    tcfg = TrainConfig(optimizer=OptimizerConfig()) if kind == "train" else None
    rec = dryrun.cell_record(cfg, kind, seq, batch, rules, tcfg, 0.0)
    return cfg, rules, seq, batch, rec


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_cell_end_to_end_on_a_fake_2x2_mesh(fake_group, kind):
    from repro_torch.models.model import abstract_params

    cfg, rules, seq, batch, rec = _smoke_cell(fake_group, kind)
    assert rec["status"] == "ok", rec.get("reason")
    assert rec["n_chips"] == 4 and rec["mesh_shape"] == {"data": 2, "model": 2}
    shards = 0
    m = abstract_params(cfg)
    place = tshardings.tree_shardings(m, rules.mesh, rules)
    for name, p in m.named_parameters():
        split = math.prod(rules.mesh.size(i) for i, pl in enumerate(place[name])
                          if pl.is_shard())
        shards += p.numel() // split * p.element_size()
    assert rec["memory"]["param_bytes"] == shards
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["state_bytes"] >= shards
    assert rec["collective_bytes_per_device"]["by_axis"]["model"] > 0
    assert rec["dominant_term"] in ("compute_term_s", "memory_term_s", "collective_term_s")
    if kind == "train":
        tokens = seq * batch
        n_attn = sum(1 for s in layer_specs(cfg) if s.mixer == ATTN)
        attention = 3 * 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * n_attn
        want = (6 * cfg.active_param_count() * tokens + attention
                + 2 * cfg.d_model * cfg.padded_vocab * tokens)
        got = rec["flops_per_device"] * rec["n_chips"]
        assert abs(got / want - 1) < 0.1, (got, want)
        assert rec["collective_bytes_per_device"]["by_axis"]["data"] > 0  # gradients


def _records():
    ok = {"arch": "yi_34b", "shape": "train_4k", "mesh": "single", "status": "ok",
          "compute_term_s": 1.5, "memory_term_s": 2.25, "collective_term_s": 0.5,
          "dominant_term": "memory_term_s", "useful_flops_ratio": 0.73,
          "memory": {"peak_bytes": 3 * 2**30}}
    skipped = {"arch": "yi_34b", "shape": "long_500k", "mesh": "single",
               "status": "skipped", "reason": "pure full-attention arch: 512k decode"}
    error = {"arch": "mamba2_780m", "shape": "long_500k", "mesh": "single",
             "status": "error", "reason": "aten.bmm.default: Sharding propagation failed"}
    return ok, skipped, error


def test_roofline_rows():
    ok, skipped, error = _records()
    assert roofline.fmt_row(ok) == (
        "| yi_34b | train_4k | 1.5 | 2.25 | 0.5 | 3 | memory | 0.73 "
        f"| {roofline.MOVE_HINTS['memory_term_s'][:58]} |")
    assert "| skipped |" in roofline.fmt_row(skipped)
    assert "pure full-attention" in roofline.fmt_row(skipped)
    row = roofline.fmt_row(error)
    assert "| ERROR |" in row and "aten.bmm.default" in row


def test_dryrun_and_roofline_clis_on_a_cell_without_a_mesh(tmp_path, capsys):
    dryrun.main(["--arch", "yi_34b", "--shape", "long_500k", "--mesh", "both",
                 "--out", str(tmp_path)])
    for mesh in ("single", "multi"):
        with open(tmp_path / f"yi_34b.long_500k.{mesh}.json") as f:
            assert json.load(f)["status"] == "skipped"
    ok, _, error = _records()
    for rec in (ok, error):
        with open(tmp_path / f"{rec['arch']}.{rec['shape']}.single.json", "w") as f:
            json.dump(rec, f)
    capsys.readouterr()
    roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("\n| ") == 3  # the three rows
    assert "single mesh: 1 ok, 1 skipped (inapplicable), 1 errors" in out
    assert np.isclose(dryrun.roofline({**ok, "flops_per_device": 989e12, "n_chips": 2,
                                       "bytes_per_device": 3.35e12, "model_flops_total": 989e12,
                                       "collective_bytes_per_device": {"by_axis": {
                                           "model": 450e9, "data": 50e9}}})["collective_term_s"],
                      2.0)
