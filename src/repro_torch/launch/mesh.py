"""Device meshes for the model zoo: port of ``repro.launch.mesh``.

Functions, never import-time state: a mesh needs an initialized
``torch.distributed`` process group (:func:`repro_torch.launch.multihost.
bootstrap`, or a fake one for the dry run).

Production shapes keep ``repro``'s chip counts (256 and 512) with the
model axis inside one node of 8 H100s: tensor and expert parallelism
all-reduce every layer's activations, which NVLink carries at 450 GB/s a
direction, while a 16-way model axis (``repro``'s TPU shape) would put
half of those collectives on InfiniBand at 50 GB/s a GPU.  So
``(data 32, model 8)`` and ``(pod 2, data 32, model 8)``; the ranks are
numbered node by node, so the last (fastest) mesh axis stays in a node.

``repro``'s ``data_mesh`` (a 1-D mesh for row-partitioned index work) is
not ported: the port's sharded index layouts run S logical shards on one
card through ``repro_torch.core.shard_group`` (``ROADMAP.md``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

GPUS_PER_NODE = 8
SINGLE_POD_SHAPE = (32, GPUS_PER_NODE)
MULTI_POD_SHAPE = (2, 32, GPUS_PER_NODE)


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return MULTI_POD_SHAPE, ("pod", "data", "model")
    return SINGLE_POD_SHAPE, ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (data 32, model 8) mesh of 256 GPUs, or (pod 2, data 32, model 8)
    of 512, over the initialized process group."""
    shape, names = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_dev_mesh(model_axis: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """Whatever the process group has (tests, one host): (n / model, model)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} ranks")
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
