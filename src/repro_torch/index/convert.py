"""Carry an index across from the JAX package: numpy arrays in, port index out.

The JAX index's state reaches numpy through ``np.asarray(leaf)`` (its
``HilbertIndex._array_bundle()``) or through its saved bundle; both use the
leaf names below.  Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.checkpoint import bundle
from repro_torch.core import forest as forest_lib
from repro_torch.core import quantize
from repro_torch.index.config import IndexConfig
from repro_torch.index.facade import KIND, DeviceLike, HilbertIndex, resolve_device

__all__ = ["LEAF_NAMES", "index_from_arrays", "index_from_jax_bundle"]

# Leaf name -> dtype of the port's tensor (32-bit words are carried as int32).
LEAF_NAMES = {
    "forest.perms": np.int32,
    "forest.flips": np.bool_,
    "forest.orders": np.int32,
    "forest.directories": np.int32,
    "forest.lo": np.float32,
    "forest.hi": np.float32,
    "quant.boundaries": np.float32,
    "quant.centroids": np.float32,
    "codes_master": np.int32,
    "sketches_master": np.int32,
    "master_order": np.int32,
    "master_rank": np.int32,
    "points": np.float32,
}
_WORDS = ("forest.directories", "codes_master", "sketches_master")


def _tensor(name: str, arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if name in _WORDS:
        arr = arr.astype(np.uint32, copy=False).view(np.int32)
    else:
        arr = arr.astype(LEAF_NAMES[name], copy=False)
    if not arr.flags.writeable:  # e.g. np.asarray of a jax array: own a copy
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def index_from_arrays(arrays: Mapping[str, np.ndarray], config_dict: Dict, *,
                      device: DeviceLike = None) -> HilbertIndex:
    """Build the port's index from the JAX index's arrays, as numpy arrays.

    ``arrays`` maps the leaf names of :data:`LEAF_NAMES` to arrays
    (``points`` optional); ``config_dict`` is ``IndexConfig.to_dict()`` of
    either package.  Unpacked ``(n, d)`` uint8 codes (format 1 bundles)
    are nibble-packed on the way in.
    """
    dev = resolve_device(device)
    t = {k: _tensor(k, arrays[k], dev) for k in LEAF_NAMES
         if k != "codes_master" and k in arrays}
    codes = np.asarray(arrays["codes_master"])
    if codes.dtype == np.uint8:  # v1 layout: unpacked codes, repack
        t["codes_master"] = quantize.pack_codes(torch.from_numpy(codes).to(dev))
    else:
        t["codes_master"] = _tensor("codes_master", codes, dev)
    return HilbertIndex(
        config=IndexConfig.from_dict(config_dict),
        forest=forest_lib.HilbertForest(
            perms=t["forest.perms"],
            flips=t["forest.flips"],
            orders=t["forest.orders"],
            directories=t["forest.directories"],
            lo=t["forest.lo"],
            hi=t["forest.hi"],
        ),
        quant=quantize.Quantizer(t["quant.boundaries"], t["quant.centroids"]),
        codes_master=t["codes_master"],
        sketches_master=t["sketches_master"],
        master_order=t["master_order"],
        master_rank=t["master_rank"],
        points=t.get("points"),
    )


def index_from_jax_bundle(path: str, *, device: DeviceLike = None) -> HilbertIndex:
    """Load the newest step of an index bundle saved by either package.

    Format 1 bundles (unpacked uint8 codes) are repacked; every leaf read
    is checked against its manifest digest.
    """
    dev = resolve_device(device)
    step = bundle.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no HilbertIndex checkpoint under {path!r}")
    extra = bundle.read_manifest(path, step).get("extra", {})
    if extra.get("kind") != KIND:
        raise ValueError(
            f"{path!r} is not a HilbertIndex checkpoint (kind={extra.get('kind')!r})"
        )
    names = [k for k in LEAF_NAMES if k != "points" or extra.get("has_points")]
    arrays, _ = bundle.restore(path, step, names)
    return index_from_arrays(arrays, extra["config"], device=dev)
