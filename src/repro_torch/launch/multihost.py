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

NCCL takes one GPU a process, so a host runs ``gpus_per_host`` processes:
process ``local_rank`` of host ``host_id`` is rank
``host_id * gpus_per_host + local_rank`` of ``n_hosts * gpus_per_host``.
Data loading uses :func:`host_batch_slice`: the step-indexed pipeline
lets every host materialize exactly its rows of any global batch with no
coordination (``repro_torch/data/pipeline.py``).
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


def bootstrap(coordinator: Optional[str] = None, host_id: Optional[int] = None,
              n_hosts: Optional[int] = None, env: Optional[dict] = None, *,
              local_rank: int = 0, gpus_per_host: int = 1,
              backend: str = "nccl") -> HostTopology:
    """Initialize ``torch.distributed`` per the resolved topology (nothing
    for a single host).  ``backend="gloo"`` runs the process group on the
    CPU (tests); with ``"nccl"`` the process takes GPU ``local_rank``."""
    topo = resolve_topology(coordinator, host_id, n_hosts, env)
    if topo.n_hosts > 1:
        import torch
        import torch.distributed as dist

        if backend == "nccl":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(
            backend, init_method=f"tcp://{topo.coordinator}",
            world_size=topo.n_hosts * gpus_per_host,
            rank=topo.host_id * gpus_per_host + local_rank)
    return topo


def host_batch_slice(global_batch: int, topo: HostTopology) -> Tuple[int, int]:
    """[start, stop) rows of the global batch owned by this host."""
    per = global_batch // topo.n_hosts
    return topo.host_id * per, (topo.host_id + 1) * per
