"""Port parity: ``repro_torch.sharding`` and ``repro_torch.launch.shardings``
against ``repro.sharding`` and ``repro.launch.shardings``.

* ``ShardingRules``, ``spec`` and ``make_rules`` give ``repro``'s entries
  for every logical name, on a single-pod and a multi-pod mesh (stub
  meshes: only their axis names and sizes are read);
* for each of the ten smoke configs, the spec of every leaf of the port's
  parameters, AdamW state and decode caches equals ``repro``'s
  ``tree_specs`` spec of the matching leaf (matched through
  ``models/convert.py``), with ``repro``'s stacked-blocks lead dropped,
  under several rules;
* ``_validate_spec`` equals ``repro``'s on every parameter of the ten full
  configs at ``repro``'s production meshes, and ``wants_fsdp`` equals
  ``repro``'s;
* ``placements``, ``tree_shardings`` and ``shard`` on a fake 8-rank mesh;
* with the default ``ShardingRules()`` the entry points compute what they
  compute without rules, bit for bit (the other ``test_torch_*`` files hold
  those results to ``repro``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sharding as jsharding
from repro.launch import shardings as jshardings
from repro.models import model as jmodel
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.train import train_loop as jtrain
from repro_torch import configs as tconfigs
from repro_torch import sharding as tsharding
from repro_torch.launch import shardings as tshardings
from repro_torch.models import model as tmodel
from repro_torch.models.convert import _layer_of
from repro_torch.optim import OptimizerConfig
from repro_torch.train import TrainConfig, abstract_train_state

ARCHS = tconfigs.ARCH_IDS
LOGICAL = ("batch", "seq", "d_model", "heads", "kv_heads", "head_dim", "kv_head_dim",
           "mlp", "vocab", "experts", "capacity", "fsdp", "cache_seq", "frames", "state")
OVERRIDES = (
    {},
    {"fsdp": "data"},
    {"experts": None, "fsdp": "data"},
    {"kv_heads": None, "kv_head_dim": "model", "cache_seq": "data"},
    {"batch": None, "attn_unconstrained": True, "seq": "model"},
)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BATCH, CACHE_SEQ = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxStubMesh:
    """What ``repro``'s rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class TorchStubMesh:
    """What the port's rules read of a DeviceMesh."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = tuple(shape)


def rules_pair(mesh_name, **overrides):
    shape, names = MESHES[mesh_name]
    return (jsharding.make_rules(JaxStubMesh(shape, names), **overrides),
            tsharding.make_rules(TorchStubMesh(shape, names), **overrides))


def norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis (``PartitionSpec`` stores
    ``("data",)`` as ``"data"``; both name the same sharding)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def fields(rules):
    return {f.name: getattr(rules, f.name) for f in dataclasses.fields(rules) if f.name != "mesh"}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("overrides", OVERRIDES, ids=str)
def test_rules_and_spec_match_repro(mesh_name, overrides):
    jr, tr = rules_pair(mesh_name, **overrides)
    assert fields(jr) == fields(tr)
    for name in LOGICAL:
        assert norm(jr.spec(name)) == norm(tr.spec(name)), name
    assert norm(jr.spec(*LOGICAL[:4])) == norm(tr.spec(*LOGICAL[:4]))
    assert norm(jsharding.ShardingRules().spec(None, "heads")) == \
        norm(tsharding.ShardingRules().spec(None, "heads"))


def _plain_path(path) -> tuple:
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(getattr(k, attr))
                break
    return tuple(out)


def repro_specs(tree, rules) -> dict:
    """``repro``'s spec of every leaf, by its plain key path."""
    specs = jshardings.tree_specs(tree, rules)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    return {_plain_path(p): norm(s) for p, s in flat}


def param_path(cfg, name):
    path, stacked, _ = _layer_of(cfg, name)
    return path, stacked is not None


def cache_path(cfg, name):
    """A port cache leaf ``i.k`` / ``i.cross.k`` / ``i.h`` -> (repro's
    path, stacked?)."""
    parts = name.split(".")
    i, rest = int(parts[0]), parts[1:]
    sub = ("cross",) if rest[0] == "cross" else ("mixer",)
    rest = rest[1:] if rest[0] == "cross" else rest
    p = cfg.pattern_len
    if i < cfg.n_blocks * p:
        return ("blocks", i % p) + sub + tuple(rest), True
    return ("tail", i - cfg.n_blocks * p) + sub + tuple(rest), False


def assert_leaf_specs_match(port: dict, ref: dict, to_path):
    assert port, "no leaves"
    for name, spec in port.items():
        path, stacked = to_path(name)
        want = ref[path]
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        if name.endswith("pos"):  # (B, L) here, (L,) in repro: replicated in both
            assert set(spec) == {None} and set(want) == {None}, (name, spec, want)
            continue
        assert norm(spec) == want, (name, spec, want)


def smoke_pair(arch):
    return jconfigs.get_config(arch, smoke=True), tconfigs.get_config(arch, smoke=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_adamw_specs_match_repro(arch):
    jcfg, tcfg = smoke_pair(arch)
    jstate = jtrain.abstract_train_state(jcfg, jtrain.TrainConfig(
        optimizer=JOptimizerConfig(compression="bf16")))
    state = abstract_train_state(tcfg, TrainConfig(optimizer=OptimizerConfig(
        compression="bf16")))
    assert all(t.device.type == "meta" for t in state["params"].parameters())
    for overrides in OVERRIDES:
        jr, tr = rules_pair("single", **overrides)
        ref = repro_specs(jstate, jr)
        port = tshardings.tree_specs(state["params"], tr)
        assert len(port) == len(list(state["params"].parameters()))
        assert_leaf_specs_match(port, ref, lambda n: ((("params",) + param_path(tcfg, n)[0]),
                                                      param_path(tcfg, n)[1]))
        for key in ("m", "v", "err"):
            port = tshardings.tree_specs(state["opt"][key], tr)
            assert_leaf_specs_match(port, ref, lambda n, key=key: (
                ("opt", key) + param_path(tcfg, n)[0], param_path(tcfg, n)[1]))
        assert norm(tshardings.tree_specs(state, tr)["step"]) == ref[("step",)] == ()
        assert tshardings.tree_specs(state, tr)["opt.step"] == ref[("opt", "step")]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_match_repro(arch):
    jcfg, tcfg = smoke_pair(arch)
    jcaches = jmodel.abstract_decode_caches(jcfg, CACHE_BATCH, CACHE_SEQ)
    caches = tmodel.abstract_decode_caches(tcfg, CACHE_BATCH, CACHE_SEQ)
    for overrides in OVERRIDES:
        jr, tr = rules_pair("single", **overrides)
        ref = repro_specs(jcaches, jr)
        port = tshardings.tree_specs(caches, tr)
        assert_leaf_specs_match(port, ref, lambda n: cache_path(tcfg, n))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_validate_spec_matches_repro_at_production_meshes(mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh, tmesh = JaxStubMesh(shape, names), TorchStubMesh(shape, names)
    for arch in ARCHS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        overrides = {"fsdp": "data" if jshardings.wants_fsdp(jcfg) else None}
        jr = jsharding.make_rules(jmesh, **overrides)
        tr = tsharding.make_rules(tmesh, **overrides)
        jparams = jmodel.abstract_params(jcfg)
        ref = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            key = jax.tree_util.keystr(path)
            ref[_plain_path(path)] = norm(jshardings._validate_spec(
                jshardings._leaf_spec(key, leaf.ndim, jr), leaf.shape, jmesh))
        for name, p in tmodel.abstract_params(tcfg).named_parameters():
            path, stacked = param_path(tcfg, name)
            got = tshardings._validate_spec(tshardings._leaf_spec(name, p.ndim, tr),
                                            p.shape, tmesh)
            want = ref[path][1:] if stacked else ref[path]
            assert norm(got) == want, (arch, name, got, want)


def test_wants_fsdp_matches_repro():
    for arch in ARCHS:
        assert (tshardings.wants_fsdp(tconfigs.get_config(arch))
                == jshardings.wants_fsdp(jconfigs.get_config(arch))), arch


def test_batch_specs_match_repro():
    jr, tr = rules_pair("multi")
    batch = {"tokens": np.zeros((4, 8), np.int32), "frames": np.zeros((4, 3, 2), np.float32)}
    want = jshardings.batch_specs(batch, jr)
    got = tshardings.batch_specs({k: torch.from_numpy(v) for k, v in batch.items()}, tr)
    assert {k: norm(v) for k, v in got.items()} == {k: norm(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def fake_mesh():
    """A (data 4, model 2) mesh of fake ranks; this process is rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_placements_tree_shardings_and_shard_on_a_fake_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rules = tsharding.make_rules(fake_mesh, fsdp="data")
    assert tsharding.placements(fake_mesh, (("data",), "model")) == (Shard(0), Shard(1))
    assert tsharding.placements(fake_mesh, (None, None)) == (Replicate(), Replicate())
    cfg = tconfigs.get_config("granite_moe_1b", smoke=True)
    m = tmodel.abstract_params(cfg)
    place = tshardings.tree_shardings(m, fake_mesh, rules)
    specs = tshardings.tree_specs(m, rules)
    for name, p in m.named_parameters():
        want = tsharding.placements(fake_mesh, tsharding.validate_spec(specs[name], p.shape,
                                                                        fake_mesh))
        assert place[name] == want, name
    assert place["layers.0.ffn.w1"] == (Shard(1), Shard(0))     # (experts, fsdp, None)
    assert place["layers.0.mixer.wk"] == (Shard(0), Shard(1))   # (fsdp, heads)
    # shard(): redistributes a DTensor, drops an axis that does not divide
    x = distribute_tensor(torch.zeros(8, 6), fake_mesh, [Replicate(), Replicate()])
    assert tsharding.shard(x, rules, "batch", "mlp").placements == (Shard(0), Shard(1))
    y = distribute_tensor(torch.zeros(8, 5), fake_mesh, [Replicate(), Replicate()])
    assert tsharding.shard(y, rules, "batch", "mlp").placements == (Shard(0), Replicate())
    plain = torch.zeros(8, 6)
    assert tsharding.shard(plain, rules, "batch", "mlp") is plain
    assert tsharding.shard(x, tsharding.ShardingRules(), "batch", "mlp") is x


@pytest.mark.parametrize("arch", ("gemma3_1b", "granite_moe_1b", "whisper_small"))
def test_default_rules_compute_what_no_rules_compute(arch):
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), compute_dtype="float32")
    m = tmodel.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    rules = tsharding.ShardingRules()
    assert torch.equal(m(toks, **extra), m(toks, rules=rules, **extra))
    pre, caches = m.prefill(toks, **extra)
    pre_r, caches_r = m.prefill(toks, rules=rules, **extra)
    assert torch.equal(pre, pre_r)
    caches, caches_r = m.pad_caches(caches, 18), m.pad_caches(caches_r, 18)
    step = toks[:, -1:]
    assert torch.equal(m.decode_step(step, 16, caches)[0],
                       m.decode_step(step, 16, caches_r, rules=rules)[0])
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones(2, 16), **extra}
    m.requires_grad_(True)
    loss = tmodel.train_loss(m, batch)
    assert torch.equal(loss, tmodel.train_loss(m, batch, rules))
