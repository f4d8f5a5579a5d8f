"""Multi-host cluster bootstrap (SLURM / GKE / manual): port of
``repro.launch.multihost``.

Each process calls :func:`bootstrap` before any collective; it resolves
the coordinator and the host topology from the environment and
initializes ``torch.distributed`` so the same ``make_production_mesh()``
and launch scripts run unchanged from one host to a 512-GPU job.

Environment resolution order (first match wins):
  1. explicit kwargs,
  2. SLURM (SLURM_PROCID / SLURM_NTASKS / SLURM_STEP_NODELIST),
  3. GKE (TPU_WORKER_ID / TPU_WORKER_HOSTNAMES, as ``repro`` reads them),
  4. single host (no process group).

NCCL takes one GPU a process, so every GPU has a process of its own, and
a process group forms whenever a job has more than one process, on one
host too (``repro``'s one process a host drives all of its chips).
:func:`resolve_rank` gives each process its rank, world and GPU:

* one task a host (``repro``'s convention: kwargs, GKE, or SLURM with as
  many tasks as nodes): the host starts ``gpus_per_host`` processes, and
  process ``local_rank`` of host ``host_id`` is rank
  ``host_id * gpus_per_host + local_rank`` of ``n_hosts * gpus_per_host``.
  One host of 8 GPUs: ``bootstrap(coordinator="localhost:29500",
  host_id=0, n_hosts=1, local_rank=r, gpus_per_host=8)`` in process r;
* one task a GPU (``srun --ntasks-per-node=8``: SLURM_NTASKS above
  SLURM_NNODES, with SLURM_LOCALID): the rank is SLURM_PROCID of
  SLURM_NTASKS and the GPU is SLURM_LOCALID; ``bootstrap()`` needs no
  kwargs.

Data loading uses :func:`rank_batch_slice` with one process a GPU: each
process materializes exactly its rows of any global batch with no
coordination (the step-indexed pipeline, ``repro_torch/data/pipeline.py``).
:func:`host_batch_slice` is ``repro``'s split by host; with one process
a host the two agree.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HostTopology:
    host_id: int
    n_hosts: int
    coordinator: str         # "host:port"
    source: str              # slurm | gke | manual | single


@dataclasses.dataclass(frozen=True)
class RankLayout:
    rank: int
    world: int
    local_rank: int          # the GPU of this process on its host


def resolve_topology(
    coordinator: Optional[str] = None,
    host_id: Optional[int] = None,
    n_hosts: Optional[int] = None,
    env: Optional[dict] = None,
) -> HostTopology:
    env = os.environ if env is None else env
    if coordinator is not None and host_id is not None and n_hosts is not None:
        return HostTopology(host_id, n_hosts, coordinator, "manual")

    if "SLURM_PROCID" in env:
        hid = int(env["SLURM_PROCID"])
        n = int(env.get("SLURM_NTASKS", "1"))
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = _first_slurm_node(nodelist)
        port = env.get("REPRO_COORD_PORT", "12321")
        return HostTopology(hid, n, f"{head}:{port}", "slurm")

    if "TPU_WORKER_ID" in env:
        hid = int(env["TPU_WORKER_ID"])
        hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
        n = len(hosts) or int(env.get("TPU_WORKER_COUNT", "1"))
        head = hosts[0] if hosts else "localhost"
        port = env.get("REPRO_COORD_PORT", "8476")
        return HostTopology(hid, n, f"{head}:{port}", "gke")

    return HostTopology(0, 1, "localhost:0", "single")


def _first_slurm_node(nodelist: str) -> str:
    """'node[003-010,012],other' -> 'node003' (minimal SLURM range parser)."""
    if not nodelist:
        return "localhost"
    head = nodelist.split(",")[0]
    m = re.match(r"([^\[]+)\[(\d+)", head)
    if m:
        prefix, first = m.group(1), m.group(2)
        return f"{prefix}{first}"
    return head


def resolve_rank(topo: HostTopology, env: Optional[dict] = None,
                 local_rank: Optional[int] = None,
                 gpus_per_host: Optional[int] = None) -> RankLayout:
    """This process's rank, world and GPU (module docstring).  Under SLURM
    with one task a GPU, the environment decides, and a ``gpus_per_host``
    or ``local_rank`` that contradicts it raises; otherwise they default to
    1 and 0, and ``local_rank`` must lie in ``[0, gpus_per_host)``."""
    env = os.environ if env is None else env
    if (topo.source == "slurm" and "SLURM_LOCALID" in env
            and topo.n_hosts > int(env.get("SLURM_NNODES", topo.n_hosts))):
        nodes, gpu = int(env["SLURM_NNODES"]), int(env["SLURM_LOCALID"])
        if gpus_per_host is not None and gpus_per_host * nodes != topo.n_hosts:
            raise ValueError(f"gpus_per_host={gpus_per_host} contradicts SLURM's "
                             f"{topo.n_hosts} tasks on {nodes} nodes")
        if local_rank is not None and local_rank != gpu:
            raise ValueError(f"local_rank={local_rank} contradicts SLURM_LOCALID={gpu}")
        return RankLayout(topo.host_id, topo.n_hosts, gpu)
    gpus = 1 if gpus_per_host is None else gpus_per_host
    local = 0 if local_rank is None else local_rank
    if not 0 <= local < gpus:
        raise ValueError(f"local_rank={local} outside [0, gpus_per_host={gpus})")
    return RankLayout(topo.host_id * gpus + local, topo.n_hosts * gpus, local)


def bootstrap(coordinator: Optional[str] = None, host_id: Optional[int] = None,
              n_hosts: Optional[int] = None, env: Optional[dict] = None, *,
              local_rank: Optional[int] = None, gpus_per_host: Optional[int] = None,
              backend: str = "nccl") -> HostTopology:
    """Initialize ``torch.distributed`` per the resolved topology and
    :func:`resolve_rank` (nothing for a job of one process).
    ``backend="gloo"`` runs the process group on the CPU (tests); with
    ``"nccl"`` the process takes GPU ``local_rank``."""
    topo = resolve_topology(coordinator, host_id, n_hosts, env)
    layout = resolve_rank(topo, env, local_rank, gpus_per_host)
    if layout.world > 1:
        import torch
        import torch.distributed as dist

        if topo.coordinator.endswith(":0"):
            raise ValueError(f"{layout.world} processes need a coordinator's port: pass "
                             "coordinator='host:port', host_id and n_hosts")
        if backend == "nccl":
            torch.cuda.set_device(layout.local_rank)
        dist.init_process_group(
            backend, init_method=f"tcp://{topo.coordinator}",
            world_size=layout.world, rank=layout.rank)
    return topo


def host_batch_slice(global_batch: int, topo: HostTopology) -> Tuple[int, int]:
    """[start, stop) rows of the global batch owned by this host."""
    per = global_batch // topo.n_hosts
    return topo.host_id * per, (topo.host_id + 1) * per


def rank_batch_slice(global_batch: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, stop) rows of the global batch owned by process ``rank`` of
    ``world``: :func:`host_batch_slice`'s split, a process at a time."""
    per = global_batch // world
    return rank * per, (rank + 1) * per
