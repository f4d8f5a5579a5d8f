"""Dry run of the model zoo on fake H100 ranks: the counterpart of
``repro.launch.dryrun``.

``repro`` lowers and compiles every (arch x shape x mesh) cell with XLA on
512 placeholder host devices and reads the costs from the HLO.  The port
runs eagerly, so it measures instead: one process joins a fake process
group of 256 or 512 ranks (``FakeStore``, backend ``"fake"``: every
collective returns at once), builds the production mesh over it (on the
``cpu`` device type; the layout is the H100 mesh's, ``launch/mesh.py``),
and runs the port's own step under ``FakeTensorMode`` (no memory, no
arithmetic) with every parameter, optimizer moment, cache and input a
DTensor placed by ``launch/shardings.py``.  It records, for rank 0:

* peak bytes, from ``torch.distributed._tools.mem_tracker.MemTracker``
  (``repro``'s ``memory_analysis()``), and the bytes of the rank's shards
  of the parameters and of the whole state;
* FLOPs, from ``FlopCounterMode``'s formulas applied to the local ops
  DTensor runs on the rank's shards (:class:`RankCost`), so replicated
  work counts on every rank and sharded work once a shard: per-device
  FLOPs, as ``repro``'s.  ``FlopCounterMode`` itself, above DTensor, sees
  the global shapes and counts the global FLOPs;
* collective bytes by mesh axis and kind: the result buffer of each
  collective DTensor (or the expert-parallel MoE) issues, as ``repro``
  counts the result shape of each collective in the HLO;
* HBM bytes: each local op's input and output bytes (views excluded).  The
  port runs eagerly, so every intermediate goes through memory: an upper
  bound on what a fused program would move.

The roofline terms use the H100 SXM5 data sheet (the card the port runs
on): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s a direction over
NVLink for the model axis (within a node of 8), 50 GB/s a GPU over NDR
InfiniBand for the data and pod axes; the collective term sums each axis's
bytes over its bandwidth.  A cell whose op has no DTensor sharding
strategy is recorded with status ``error`` and that op's name.

Usage:
  python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
(``--all`` runs each cell in its own subprocess, ``--jobs`` at a time, so a
crash loses one cell, not the run.)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import shardings as shlib
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.sharding import ShardingRules, axis_size, make_rules
from repro_torch.train.train_loop import TrainConfig, make_train_step

# NVIDIA H100 SXM5 data sheet, per GPU
DEVICE = "NVIDIA H100 SXM5 80GB (data sheet, 700 W)"
PEAK_FLOPS = 989e12          # dense bf16
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction: the model axis, within a node
IB_BW = 50e9                 # bytes/s a GPU, NDR InfiniBand: the data and pod axes
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

_COLLECTIVES = {"all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                "all_to_all_single", "broadcast"}


# ---------------------------------------------------------------------------
# Planning: repro's, with the mesh's sizes in place of its literal 16
# ---------------------------------------------------------------------------


def saved_stack_bytes(cfg: ModelConfig, seq: int, batch: int, n_micro: int,
                      batch_shards: int, seq_shards: int = 1) -> float:
    """Per-device remat-saved layer-input stack of one microbatch, at
    ``repro``'s 6 bytes an element (its measured bf16 stack plus XLA's f32
    copy; the planning keeps ``repro``'s figure so both plan the same
    cells, and the dry run measures the port's real peak)."""
    tokens_dev = seq * batch / batch_shards / n_micro
    per_layer = tokens_dev * cfg.d_model * 6
    if seq_shards > 1:
        per_layer /= seq_shards
    return per_layer * cfg.n_layers


def microbatches_for(cfg: ModelConfig, seq: int, batch: int, batch_shards: int,
                     seq_shards: int = 1) -> int:
    """Gradient-accumulation count: bound the saved stack at ~4 GB a device.

    n divides the global batch and leaves >= 1 row a batch shard."""
    n = 1
    while (saved_stack_bytes(cfg, seq, batch, n, batch_shards, seq_shards) > 4e9
           and n < batch // batch_shards):
        n += 1
        while batch % n:
            n += 1
    return n


def needs_seq_shard(cfg: ModelConfig, seq: int, batch: int, data_shards: int) -> bool:
    """Even at the most microbatches the stack exceeds ~6 GB: shard the
    residual stream's sequence over the model axis between layers.  Rows
    a device are taken over the data axis alone, as ``repro`` does (its
    literal 16 on both meshes; a pod axis would halve the stack again)."""
    return saved_stack_bytes(cfg, seq, batch, max(1, batch // data_shards),
                             data_shards) > 6e9


def _batch_shards(mesh, rules: ShardingRules) -> int:
    axes = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    return math.prod(axis_size(mesh, a) for a in axes if a is not None)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of the cell (no memory)."""
    seq, batch, kind = configs.SHAPES[shape_name]
    b = _inputs(cfg, kind, seq, batch)
    if kind == "decode":
        b["idx"] = torch.empty((), dtype=torch.int32, device="meta")
        b["caches"] = model.abstract_decode_caches(cfg, batch, seq)
    return b


def rules_for(cfg: ModelConfig, shape_name: str, mesh) -> ShardingRules:
    """``repro``'s per-cell rules, sized by ``mesh``."""
    overrides: Dict[str, Any] = {"fsdp": "data" if shlib.wants_fsdp(cfg) else None}
    model_size = axis_size(mesh, "model")
    if 0 < cfg.n_heads < model_size:
        # Fewer query heads than the model axis (gemma3's 4): no explicit
        # head constraints; the caches shard by head_dim.
        overrides["attn_unconstrained"] = True
        overrides["kv_heads"] = None
        overrides["kv_head_dim"] = None
    if cfg.n_experts and cfg.n_experts % model_size != 0:
        overrides["experts"] = None  # intra-expert TP instead of EP
    if not 0 < cfg.n_heads < model_size and 0 < cfg.n_kv_heads < model_size:
        # KV heads do not cover the model axis: shard head_dim instead
        overrides["kv_heads"] = None
        overrides["kv_head_dim"] = "model"
    seq, batch, kind = configs.SHAPES[shape_name]
    if kind in ("decode", "prefill") and overrides.get("attn_unconstrained"):
        overrides["kv_head_dim"] = "model"
    if kind == "train" and needs_seq_shard(cfg, seq, batch, axis_size(mesh, "data")):
        overrides["seq"] = "model"
    rules = make_rules(mesh, **overrides)
    if kind == "decode" and batch < _batch_shards(mesh, rules):
        # the batch cannot shard (long_500k: 1 row): shard the cache's
        # sequence over the data axis instead
        rules = dataclasses.replace(rules, batch=None, cache_seq="data")
    return rules


def train_config(cfg: ModelConfig, shape_name: str, rules: ShardingRules) -> TrainConfig:
    """``repro``'s train config of the cell: its microbatches, and bf16
    moments above 1e11 parameters."""
    seq, batch, _ = configs.SHAPES[shape_name]
    mesh = rules.mesh
    n_micro = microbatches_for(cfg, seq, batch, _batch_shards(mesh, rules),
                               axis_size(mesh, "model") if rules.seq else 1)
    moments = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    return TrainConfig(n_microbatches=n_micro,
                       optimizer=OptimizerConfig(moment_dtype=moments))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


class RankCost(torch.utils._python_dispatch.TorchDispatchMode):
    """FLOPs, HBM bytes and collective bytes of the local ops one rank runs.

    Above DTensor a mode sees global shapes; this one hands every DTensor
    op back (``NotImplemented``), so DTensor runs it as local ops on the
    rank's shards and collectives, which come back here.  Ops DTensor runs
    under its own fake mode to propagate shapes are skipped (as
    ``MemTracker`` skips them)."""

    def __init__(self, mesh):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.flops = 0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = defaultdict(float)
        self.by_axis: Dict[str, float] = defaultdict(float)
        self._formulas = FlopCounterMode(display=False).flop_registry
        names = tuple(mesh.mesh_dim_names)
        self._axis = {mesh.get_group(i).group_name: n for i, n in enumerate(names)}
        self._fake = None

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        if func.namespace == "_c10d_functional":
            name = func._overloadpacket.__name__
            if name in _COLLECTIVES:
                group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
                nbytes = float(_nbytes(out))
                self.collectives[name] += nbytes
                self.by_axis[self._axis.get(group, str(group))] += nbytes
            return out
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += self._formulas[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


@contextlib.contextmanager
def _own_propagation_fake_mode():
    """DTensor finds each op's output shape by running it on fake tensors
    of the global shapes, under the fake mode already active (ours here);
    give it a fresh one, so the trackers, which count only ops of the mode
    they were entered in, leave those runs out."""
    from torch.distributed.tensor import _sharding_prop

    saved = _sharding_prop.detect_fake_mode
    _sharding_prop.detect_fake_mode = lambda *args, **kwargs: None
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode = saved


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes for t in tensors)


def _failed_op(err: BaseException) -> str:
    m = re.search(r"(aten\.[\w.]+|_c10d_functional\.[\w.]+)", str(err))
    return m.group(1) if m else type(err).__name__


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    seq, batch, kind = configs.SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch


def fake_mesh(shape, names):
    """A mesh of ``prod(shape)`` fake ranks; this process is rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def measure(cfg: ModelConfig, kind: str, seq: int, batch: int, rules: ShardingRules,
            tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Run a step of ``kind`` ("train" with ``tcfg``, "prefill" or "decode"
    against a ``seq``-long cache) at (seq, batch) on ``rules.mesh`` under
    ``FakeTensorMode``; return the rank's measurements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode():
        m = model.Transformer(cfg, device="cpu")
        shlib.distribute(m, rules)
        inputs = {k: torch.zeros(v.shape, dtype=v.dtype, device="cpu")
                  for k, v in _inputs(cfg, kind, seq, batch).items()}
        tracked = list(m.parameters())
        if kind == "train":
            m.requires_grad_(True)
            opt = shlib.distribute(init_opt_state(dict(m.named_parameters()), tcfg.optimizer),
                                   rules, "opt.")
            step = shlib.distribute(torch.zeros((), dtype=torch.int32), rules, "step")
            state = {"params": m, "opt": opt, "step": step}
            tracked += [t for _, t in shlib.named_leaves(opt)]
        else:
            caches = None
            if kind == "decode":
                caches = shlib.distribute(m.make_decode_caches(batch, seq), rules)
                tracked += [t for _, t in shlib.named_leaves(caches)]
        batch_in = shlib.distribute_batch(inputs, rules)
        param_bytes = _local_bytes(m.parameters())
        state_bytes = _local_bytes(tracked)
        cost = RankCost(rules.mesh)
        mem = MemTracker()
        mem.track_external(*tracked)
        t0 = time.perf_counter()
        with _own_propagation_fake_mode(), mem, cost, implicit_replication():
            if kind == "train":
                make_train_step(cfg, tcfg, rules)(state, batch_in)
            elif kind == "prefill":
                m.prefill(batch_in["tokens"], patches=batch_in.get("patches"),
                          frames=batch_in.get("frames"), rules=rules)
            else:
                m.decode_step(batch_in["tokens"], seq - 1, caches, rules=rules)
        run_s = time.perf_counter() - t0
    peak = max(v.get("Total", 0) for v in mem.get_tracker_snapshot("peak").values())
    return {
        "flops_per_device": float(cost.flops),
        "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": {**cost.collectives,
                                        "by_axis": dict(cost.by_axis),
                                        "total": sum(cost.by_axis.values())},
        "memory": {"peak_bytes": int(peak), "param_bytes": int(param_bytes),
                   "state_bytes": int(state_bytes)},
        "n_microbatches": tcfg.n_microbatches if kind == "train" else None,
        "run_s": run_s,
    }


def _inputs(cfg: ModelConfig, kind: str, seq: int, batch: int) -> Dict[str, Any]:
    """The input shapes of a cell of ``kind`` at (seq, batch) (caches aside)."""
    if kind == "decode":
        return {"tokens": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
    b = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device="meta")}
    if kind == "train":
        b["labels"] = torch.empty((batch, seq), dtype=torch.int32, device="meta")
        b["mask"] = torch.empty((batch, seq), dtype=torch.float32, device="meta")
    if cfg.n_patches:
        b["patches"] = torch.empty((batch, cfg.n_patches, cfg.patch_dim), device="meta")
    if cfg.is_encdec:
        b["frames"] = torch.empty((batch, cfg.enc_frames, cfg.d_model), device="meta")
    return b


def roofline(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The three terms in seconds, the dominant one and the useful-FLOP
    ratio, from a record's per-device numerators."""
    by_axis = rec["collective_bytes_per_device"]["by_axis"]
    terms = {
        "compute_term_s": rec["flops_per_device"] / PEAK_FLOPS,
        "memory_term_s": rec["bytes_per_device"] / HBM_BW,
        "collective_term_s": sum(v / AXIS_BW.get(a, IB_BW) for a, v in by_axis.items()),
    }
    total = rec["flops_per_device"] * rec["n_chips"]
    return {**terms, "dominant_term": max(terms, key=terms.get),
            "useful_flops_ratio": rec["model_flops_total"] / total if total else 0.0}


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    cfg = configs.get_config(arch)
    head = {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single"}
    ok, reason = configs.shape_applicable(cfg, shape_name)
    if not ok:
        return {**head, "status": "skipped", "reason": reason}
    if configs.SHAPES[shape_name][2] == "train":
        cfg = dataclasses.replace(cfg, remat_policy="full")
    shape, names = production_shape(multi_pod)
    mesh = fake_mesh(shape, names)
    try:
        rules = rules_for(cfg, shape_name, mesh)
        seq, batch, kind = configs.SHAPES[shape_name]
        tcfg = train_config(cfg, shape_name, rules) if kind == "train" else None
        return {**head, **cell_record(cfg, kind, seq, batch, rules, tcfg,
                                      model_flops(cfg, shape_name))}
    finally:
        dist.destroy_process_group()


def cell_record(cfg: ModelConfig, kind: str, seq: int, batch: int, rules: ShardingRules,
                tcfg: Optional[TrainConfig], model_flops_total: float) -> Dict[str, Any]:
    """The record of one cell on ``rules.mesh``: status ``ok`` with the
    measurements and the roofline terms, or ``error`` with the op that
    stopped it."""
    mesh = rules.mesh
    names = tuple(mesh.mesh_dim_names)
    rec = {"n_chips": mesh.size(), "mesh_shape": dict(zip(names, mesh.shape)),
           "device": DEVICE, "rules": _rules_record(rules),
           "model_flops_total": model_flops_total}
    try:
        rec.update(measure(cfg, kind, seq, batch, rules, tcfg))
    except Exception as err:  # a cell that cannot run is a record, not a crash
        return {**rec, "status": "error", "reason": f"{_failed_op(err)}: {str(err)[:400]}"}
    return {**rec, "status": "ok", **roofline(rec)}


def _rules_record(rules: ShardingRules) -> Dict[str, Any]:
    return {f.name: getattr(rules, f.name) for f in dataclasses.fields(rules)
            if f.name != "mesh"}


def _run_one(out_dir: str, arch: str, shape: str, mesh_name: str, timeout: int) -> str:
    fn = os.path.join(out_dir, f"{arch}.{shape}.{mesh_name}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh_name, "--out", out_dir]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        failed = r.returncode != 0 and f"exit {r.returncode}: {r.stderr[-3000:]}"
    except subprocess.TimeoutExpired:
        failed = f"timed out after {timeout} s"
    if failed:
        with open(fn, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh_name, "status": "error",
                       "reason": failed}, f, indent=1)
    with open(fn) as f:
        rec = json.load(f)
    return f"{arch} x {shape} x {mesh_name}: {rec['status']}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1, help="cells at a time under --all")
    ap.add_argument("--timeout", type=int, default=3000, help="seconds a cell under --all")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            rec = run_cell(args.arch, args.shape, mp)
            fn = os.path.join(args.out, f"{args.arch}.{args.shape}.{rec['mesh']}.json")
            with open(fn, "w") as f:
                json.dump(rec, f, indent=1)
            print(json.dumps(rec))
        return

    cells = [(a, s, "multi" if mp else "single")
             for a in configs.ARCH_IDS for s in configs.SHAPES for mp in meshes]
    todo = [c for c in cells
            if not os.path.exists(os.path.join(args.out, f"{c[0]}.{c[1]}.{c[2]}.json"))]
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = [pool.submit(_run_one, args.out, *c, args.timeout) for c in todo]
        for fut in concurrent.futures.as_completed(futures):
            print(fut.result(), flush=True)


if __name__ == "__main__":
    main()
